"""In-sample and held-out eval CD of every retained checkpoint of a run,
with the PyTorch port alone: the counterpart of ``tools/eval_curve.py``.

For each ``ckpt_<step>.pt`` of a workdir (or for one checkpoint of any form
``rfnet_tpu_torch.eval.load_state`` takes: a ``ckpt_<step>.pt``, the
trainer's ``bestrecord/``, a ``state_dict`` ``.pt`` or a flax ``.npz`` such
as ``weights/rfnet_r4_105000.npz``) it scores

  * ``num`` TRAINING samples: the first ``num`` items of the seed-0
    synthetic set, the ``--synthetic`` training set, and
  * ``num`` HELD-OUT samples: the seed-1234 set the trainer's
    ``--synthetic_val_size``/``--synthetic_online`` eval holds out,

with the trainer's own eval (``train.eval_step``: CD of the final output,
batch 4, the mean of the batches' means). The held-out column is the
trainer's ``eval @ <step>: mean cd`` line: the same arrays, weights and
arithmetic. A healthy run that overfits shows the in-sample curve falling
while the held-out one bottoms out and rises; an unstable run shows both
rising. Each set goes to the device once.

    python tools/eval_curve_torch.py runs/modelvv_recon [num] [--json curve.json]
    python tools/eval_curve_torch.py weights/rfnet_r4_105000.npz 64
    python tools/eval_curve_torch.py runs/modelvv_recon 8 --device cpu \\
        --innum 64 --ptnum 128

Runs on the card unless ``--device cpu`` is given; a missing card is an
error. ``--json`` writes the rows as ``[{"step", "in_cd", "heldout_cd"}]``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from rfnet_tpu_torch.data.dataset import resample_pcd, synthetic_pairs
from rfnet_tpu_torch.eval import CHECKPOINT_NAME, list_checkpoints, load_state, resolve_device
from rfnet_tpu_torch.train import TrainState, eval_step

IN_SAMPLE_SEED = 0
HELD_OUT_SEED = 1234
BATCH = 4  # TrainConfig.eval_size


def build_set(num: int, seed: int, innum: int, ptnum: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``num`` pairs of the synthetic set of ``seed`` as the
    trainer's dataflow batches them: partials of ``2·innum`` points cut to
    their first ``innum``, ground truths of ``ptnum``; float32."""
    parts, gts = [], []
    for _, partial, gt in synthetic_pairs(num, innum * 2, ptnum, seed):
        parts.append(resample_pcd(partial, innum))
        gts.append(resample_pcd(gt, ptnum))
    return np.stack(parts).astype(np.float32), np.stack(gts).astype(np.float32)


def checkpoints(path: str) -> list[tuple[int | None, str]]:
    """(step, checkpoint) pairs to score: every ``ckpt_<step>.pt`` of a
    workdir, oldest first; otherwise ``path`` itself, with the step its
    name, its ``__step__`` or its ``best.json`` gives (None where none
    does)."""
    if os.path.isdir(path) and not os.path.isfile(os.path.join(path, "model.pt")):
        found = list_checkpoints(path)
        if not found:
            raise SystemExit(f"{path}: no ckpt_<step>.pt checkpoints")
        return found
    if not os.path.exists(path):
        raise SystemExit(f"{path}: no such checkpoint")
    step = None
    if m := CHECKPOINT_NAME.fullmatch(os.path.basename(path)):
        step = int(m.group(1))
    elif path.endswith(".npz"):
        with np.load(path) as z:
            step = int(z["__step__"]) if "__step__" in z.files else None
    elif os.path.isfile(best := os.path.join(path, "best.json")):
        with open(best) as f:
            step = int(json.load(f)["step"])
    return [(step, path)]


def sweep(state: TrainState, parts: torch.Tensor, gts: torch.Tensor) -> float:
    """Mean over the batches of ``eval_step``'s CD, as ``train.evaluate``."""
    cds = [float(eval_step(state, parts[i:i + BATCH], gts[i:i + BATCH])[0])
           for i in range(0, parts.shape[0], BATCH)]
    return float(np.mean(cds))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("path", nargs="?", default="modelvv_recon",
                   help="a workdir (every ckpt_<step>.pt) or one checkpoint")
    p.add_argument("num", nargs="?", type=int, default=64,
                   help="samples a set (a multiple of 4)")
    p.add_argument("--json", default=None, help="also write the rows to this file")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--innum", type=int, default=3000, help="partial-cloud size")
    p.add_argument("--ptnum", type=int, default=16384, help="ground-truth size")
    args = p.parse_args(argv)
    if args.num <= 0 or args.num % BATCH:
        p.error(f"num {args.num} must be a positive multiple of {BATCH}")
    device = resolve_device(args.device)
    found = checkpoints(args.path)
    print(f"checkpoints: {[s for s, _ in found]}", file=sys.stderr)

    sets = {name: [torch.from_numpy(a).to(device)
                   for a in build_set(args.num, seed, args.innum, args.ptnum)]
            for name, seed in (("in_cd", IN_SAMPLE_SEED), ("heldout_cd", HELD_OUT_SEED))}
    rows = []
    print(f"{'step':>6} {'in-sample cd':>13} {'held-out cd':>12}")
    for step, path in found:
        with contextlib.redirect_stdout(sys.stderr):
            model = load_state(path).to(device)
        state = TrainState(model, optimizer=None)
        row = {"step": step, **{name: sweep(state, *data) for name, data in sets.items()}}
        rows.append(row)
        print(f"{'-' if step is None else step:>6} {row['in_cd']:>13.6f} "
              f"{row['heldout_cd']:>12.6f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
        print(f"wrote {args.json}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()

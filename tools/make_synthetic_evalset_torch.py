"""Dump a training run's held-out synthetic set as an eval-CLI fixture
(``data/partial|complete/<id>.pcd`` and ``test.list``), with the PyTorch
port alone: the counterpart of ``tools/make_synthetic_evalset.py``, writing
the same bytes from the same flags.

The port's trainer, under ``--synthetic_online`` or ``--synthetic_val_size``,
holds out ``synthetic_pairs(N, seed=1234)`` and logs its mean CD every eval
(``eval @ N: mean cd X``). Serving the run's best checkpoint over this dump
with the port's eval CLI must give the same mean CD: the partials (3000
points) and ground truths (16384) take ``resample_pcd``'s identity path and
the ``.pcd`` round trip is exact in float32, so the CLI sees the training
evaluator's arrays.

    python tools/make_synthetic_evalset_torch.py --out runs/evalset --num 64
    python -m rfnet_tpu_torch.eval --checkpoint runs/bestrecord \\
        --list_path runs/evalset/test.list --data_dir runs/evalset/data \\
        --results_dir runs/results_synth --batch_size 4

With ``--pcn_layout`` the ids are ``<synset>/<model>`` over the PCN test
set's 8 known-category synsets, round-robin, so the CLI's per-category
paths run as on the real test set. The tool computes nothing on a device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfnet_tpu_torch.data.dataset import synthetic_pairs
from rfnet_tpu_torch.data.pcd_io import save_pcd

# the 8 PCN "known" category synsets, the directories of the reference's
# test set (BASELINE.md's per-category table)
PCN_SYNSETS = (
    "02691156",  # airplane
    "02933112",  # cabinet
    "02958343",  # car
    "03001627",  # chair
    "03636649",  # lamp
    "04256520",  # sofa
    "04379243",  # table
    "04530566",  # vessel
)


def write_evalset(out: str, num: int, seed: int = 1234, input_size: int = 3000,
                  gt_size: int = 16384, pcn_layout: bool = False) -> list[str]:
    """Write ``num`` pairs of ``synthetic_pairs(num, input_size, gt_size,
    seed)`` under ``out`` and return their ids, in ``test.list``'s order."""
    ids = []
    for i, (mid, part, gt) in enumerate(synthetic_pairs(num, input_size, gt_size, seed=seed)):
        if pcn_layout:
            mid = f"{PCN_SYNSETS[i % len(PCN_SYNSETS)]}/{mid.split('/')[-1]}"
        for kind, cloud in (("partial", part), ("complete", gt)):
            path = os.path.join(out, "data", kind, mid + ".pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_pcd(path, cloud)
        ids.append(mid)
    with open(os.path.join(out, "test.list"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--input_size", type=int, default=3000)
    p.add_argument("--gt_size", type=int, default=16384)
    p.add_argument("--pcn_layout", action="store_true",
                   help="ids <synset>/<model> over the PCN test set's 8 known-category "
                   "synsets (round-robin), as the real test set lays them out")
    args = p.parse_args(argv)
    ids = write_evalset(args.out, args.num, args.seed, args.input_size, args.gt_size,
                        args.pcn_layout)
    print(f"wrote {len(ids)} models under {args.out} "
          f"(list: {os.path.join(args.out, 'test.list')})")


if __name__ == "__main__":
    main()

"""Training loop — port of ``rfnet_tpu/train.py`` (one device, float32).

    python -m rfnet_tpu_torch.train --synthetic --steps 4 --ckpt_every 2 \\
        --workdir runs/modelvv_recon            # on the card (the default)
    python -m rfnet_tpu_torch.train --synthetic --device cpu --innum 64 \\
        --ptnum 128 --n_seed 4 --up_ratio 4 --batch_size 2 --steps 4 --ckpt_every 2

* One train step = the model's forward, ``losses.total_loss`` (with the 64-
  and 1 024-point FPS pyramids of the ground truth made in the step, as the
  reference makes them in its graph), the backward and one Adam update.
  The state (model, optimizer, step count) is updated in place.
* Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added outside the
  square root, after bias correction: torch's ``Adam`` computes the same
  update). The learning rate is set before each update from
  ``learning_rate(step)``, ``step`` being the number of updates done so far,
  which is where optax evaluates its schedule; the same count feeds
  ``decfactor_weight``.
* Checkpoints every ``ckpt_every`` steps: ``<workdir>/ckpt_<step>.pt``
  (``torch.save`` of model, optimizer and step), the newest ``max_to_keep``
  kept, the latest restored at start. After each checkpoint the eval set is
  scored (CD and EMD of the final output); the best CD so far is kept in
  ``<workdir>/../bestrecord/`` as ``model.pt`` (the state_dict the eval CLI
  loads) and ``best.json``, which a resumed run reads back.
* Every ``log_every`` steps the reference's scalars are printed and
  appended to ``<workdir>/../logs/metrics.jsonl``, with the eval scores.

The model's initial weights come from a torch generator seeded by
``config.seed``, so they differ from the JAX package's flax init by design;
``compat.convert`` carries flax weights across where equal weights matter.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import time

import numpy as np
import torch

from rfnet_tpu_torch import losses
from rfnet_tpu_torch.eval import resolve_device
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.ops.chamfer import chamfer_means
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point


@dataclasses.dataclass
class TrainConfig:
    # reference constants, vv_recon.py:25-31
    iters: int = 300_000
    batch_size: int = 32
    eval_size: int = 4
    innum: int = 3000
    ptnum: int = 16384
    seed: int = 1
    log_every: int = 500
    ckpt_every: int = 20_000
    max_to_keep: int = 20
    workdir: str = "./modelvv_recon"
    # model
    n_seed: int = 32
    up_ratio: int = 16
    # compresses the LR/α₁ schedule boundaries for runs shorter than the
    # reference's 300k steps (1.0 = the reference)
    schedule_scale: float = 1.0


@dataclasses.dataclass
class TrainState:
    model: RFNet
    optimizer: torch.optim.Adam
    step: int = 0  # updates done so far


def create_state(config: TrainConfig, device: torch.device | str = "cuda") -> TrainState:
    """A freshly initialised model on ``device`` (the card unless the CPU is
    asked for) and its Adam optimizer. The weights are drawn from a torch
    generator seeded by ``config.seed``, so they differ from the JAX
    package's flax init of the same seed by design."""
    device = resolve_device(device)
    model = RFNet(n_seed=config.n_seed, up_ratio=config.up_ratio,
                  generator=torch.Generator().manual_seed(config.seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=losses.learning_rate(0, config.schedule_scale),
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt)


def apply_gradients(state: TrainState, schedule_scale: float = 1.0) -> None:
    """One Adam update from the parameters' ``.grad``, at the learning rate
    the schedule gives for the updates done so far."""
    lr = losses.learning_rate(state.step, schedule_scale)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, partial: torch.Tensor, gt: torch.Tensor, *, n1: int,
               n2: int, schedule_scale: float = 1.0):
    """One optimisation step; n1/n2 are the coarse pyramid sizes.
    Returns (LossBreakdown, diagnostics), both detached."""
    gt1 = gather_point(gt, farthest_point_sample(n1, gt))
    gt2 = gather_point(gt, farthest_point_sample(n2, gt))
    return train_step_pyr(state, partial, gt, gt1, gt2, schedule_scale=schedule_scale)


def train_step_pyr(state: TrainState, partial: torch.Tensor, gt: torch.Tensor,
                   gt1: torch.Tensor, gt2: torch.Tensor, *, schedule_scale: float = 1.0):
    """The step with the ground truth's FPS pyramids passed in. The
    parameters' ``.grad`` hold this step's gradients afterwards."""
    state.optimizer.zero_grad(set_to_none=True)
    out = state.model(partial)
    lb = losses.total_loss(out, gt, gt1, gt2, state.step, schedule_scale)
    lb.total.backward()
    apply_gradients(state, schedule_scale)
    c1, c2, c3 = out.code1[0, 0].detach(), out.code2[0, 0].detach(), out.code3[0, 0].detach()
    diag = {
        "code1_first": c1[0],
        "code1_nonzero": torch.sum(c1 != 0),
        "code2_nonzero": torch.sum(c2 != 0),
        "code3_nonzero": torch.sum(c3 != 0),
        "code1_max": torch.max(c1),
        "code2_max": torch.max(c2),
        "code3_max": torch.max(c3),
    }
    return losses.LossBreakdown(*(t.detach() for t in lb)), diag


@torch.no_grad()
def eval_step(state: TrainState, partial: torch.Tensor, gt: torch.Tensor):
    """(chamfer, emd) of the final output (the reference's eval_one_batch)."""
    out4 = state.model(partial).out4
    ma, mb = chamfer_means(gt, out4)
    return (ma + mb) / 2.0, losses.earth_mover_eval(gt, out4)


def evaluate(state: TrainState, valid_iter, valid_num: int, config: TrainConfig,
             device: torch.device) -> tuple[float, float]:
    """Mean CD and EMD over ``valid_num // eval_size`` batches of the
    persistent eval iterator."""
    cds, emds = [], []
    for _ in range(max(1, valid_num // config.eval_size)):
        _, batch_point, _, output_point = next(valid_iter)
        cd, emd = eval_step(state, torch.from_numpy(batch_point).to(device),
                            torch.from_numpy(output_point).to(device))
        cds.append(float(cd))
        emds.append(float(emd))
    return float(np.mean(cds)), float(np.mean(emds))


def _checkpoints(workdir: str) -> list[tuple[int, str]]:
    found = []
    for path in glob.glob(os.path.join(workdir, "ckpt_*.pt")):
        m = re.fullmatch(r"ckpt_(\d+)\.pt", os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(state: TrainState, workdir: str, max_to_keep: int) -> str:
    """Write ``ckpt_<step>.pt`` and drop all but the newest ``max_to_keep``."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"ckpt_{state.step}.pt")
    _save_atomic({"model": state.model.state_dict(),
                  "optimizer": state.optimizer.state_dict(), "step": state.step}, path)
    for _, old in _checkpoints(workdir)[:-max_to_keep]:
        os.remove(old)
    return path


def restore_if_available(state: TrainState, workdir: str) -> bool:
    """Load the latest checkpoint of ``workdir`` into ``state``, if any."""
    found = _checkpoints(workdir)
    if not found:
        return False
    step, path = found[-1]
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    print(f"restored checkpoint at step {state.step} ({path})")
    return True


def _read_best_cd(path: str) -> float:
    try:
        with open(path) as f:
            return float(json.load(f)["cd"])
    except FileNotFoundError:
        return float("inf")


def _append_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def train(config: TrainConfig, train_df, valid_df, valid_num: int,
          device: torch.device | str = "cuda") -> TrainState:
    device = resolve_device(device)
    state = create_state(config, device)
    restore_if_available(state, config.workdir)
    root = os.path.join(config.workdir, "..")
    best_dir = os.path.join(root, "bestrecord")
    best_meta = os.path.join(best_dir, "best.json")
    os.makedirs(os.path.join(root, "logs"), exist_ok=True)
    metrics_path = os.path.join(root, "logs", "metrics.jsonl")
    # best-by-CD survives restarts, so a resumed run's first eval cannot
    # overwrite a better earlier record
    best_cd = _read_best_cd(best_meta)
    if best_cd < float("inf"):
        print(f"best-so-far cd {best_cd:.6f} (from {best_meta})")
    n1 = 2 * config.n_seed
    n2 = n1 * config.up_ratio
    start = state.step
    train_gen, valid_iter = iter(train_df), iter(valid_df)
    t_last = time.perf_counter()
    try:
        for i in range(start, config.iters):
            _, batch_point, _, output_point = next(train_gen)
            lb, diag = train_step(
                state, torch.from_numpy(batch_point).to(device),
                torch.from_numpy(output_point).to(device), n1=n1, n2=n2,
                schedule_scale=config.schedule_scale)
            if (i + 1) % config.log_every == 0:
                lb_host = {k: float(v) for k, v in lb._asdict().items()}
                now = time.perf_counter()
                rate = config.log_every * config.batch_size / (now - t_last)
                t_last = now
                print(f"batch {i}  loss {lb_host['total']:.6f}  "
                      f"cd {lb_host['cd3'] + lb_host['cd4']:.6f}  "
                      f"emd64 {lb_host['cd1_emd']:.6f}  emd1024 {lb_host['cd2_emd']:.6f}  "
                      f"decfac {lb_host['loss_dec']:.6f}  {rate:.1f} clouds/s")
                print("max of code1 first: %f  nonzero:%d | code2 max %f nz %d | "
                      "code3 max %f nz %d" % (
                          float(diag["code1_max"]), int(diag["code1_nonzero"]),
                          float(diag["code2_max"]), int(diag["code2_nonzero"]),
                          float(diag["code3_max"]), int(diag["code3_nonzero"])))
                _append_jsonl(metrics_path, {"step": i, **lb_host})
            if (i + 1) % config.ckpt_every == 0:
                save_checkpoint(state, config.workdir, config.max_to_keep)
                mean_cd, mean_emd = evaluate(state, valid_iter, valid_num, config, device)
                print(f"eval @ {i + 1}: mean cd {mean_cd:.6f} mean emd {mean_emd:.6f}")
                _append_jsonl(metrics_path,
                              {"step": i + 1, "eval_cd": mean_cd, "eval_emd": mean_emd})
                if mean_cd < best_cd:
                    best_cd = mean_cd
                    os.makedirs(best_dir, exist_ok=True)
                    _save_atomic(state.model.state_dict(), os.path.join(best_dir, "model.pt"))
                    with open(best_meta, "w") as f:
                        json.dump({"step": i + 1, "cd": best_cd}, f)
                    print("record bestsofar:", mean_emd, mean_cd)
    finally:
        # stop the dataflows' prefetch threads on every exit path
        train_gen.close()
        valid_iter.close()
    print(f"trained {state.step - start} steps (now at step {state.step})")
    return state


def main(argv=None):
    p = argparse.ArgumentParser(description="RFNet training (PyTorch port)")
    p.add_argument("--synthetic", action="store_true", help="train on synthetic clouds")
    p.add_argument("--synthetic_size", type=int, default=256)
    p.add_argument("--synthetic_val_size", type=int, default=None,
                   help="held-out synthetic validation set of this many samples "
                   "(disjoint generator seed); default the in-sample 8")
    p.add_argument("--schedule_scale", type=float, default=None,
                   help="compress the LR/α₁ boundary schedule by this factor")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--ckpt_every", type=int, default=None)
    p.add_argument("--innum", type=int, default=None, help="partial-cloud size (3000)")
    p.add_argument("--ptnum", type=int, default=None,
                   help="dense output size; must equal 2*n_seed*up_ratio^2")
    p.add_argument("--n_seed", type=int, default=None, help="coarse seed half-count (32)")
    p.add_argument("--up_ratio", type=int, default=None, help="upsampling factor (16)")
    p.add_argument("--workdir", default="./modelvv_recon")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    config = TrainConfig(workdir=args.workdir)
    for field in ("innum", "ptnum", "n_seed", "up_ratio"):
        if getattr(args, field) is not None:
            config = dataclasses.replace(config, **{field: getattr(args, field)})
    if config.ptnum != 2 * config.n_seed * config.up_ratio**2:
        p.error(f"--ptnum {config.ptnum} inconsistent with the 3-step pyramid: "
                f"2*n_seed*up_ratio^2 = {2 * config.n_seed * config.up_ratio**2}")
    if args.steps:
        config = dataclasses.replace(config, iters=args.steps)
    if args.batch_size:
        config = dataclasses.replace(config, batch_size=args.batch_size)
    if args.ckpt_every:
        config = dataclasses.replace(config, ckpt_every=args.ckpt_every)
    if args.schedule_scale is not None:
        if args.schedule_scale <= 0:
            p.error("--schedule_scale must be > 0")
        config = dataclasses.replace(config, schedule_scale=args.schedule_scale)
    if not args.synthetic:
        p.error("only --synthetic data is ported: the LMDB dataflow waits for "
                "data/lmdb_pure.py (ROADMAP.md, modules to port: data / CLI flags)")
    device = resolve_device(args.device)

    from rfnet_tpu_torch.data.dataset import synthetic_dataflow

    train_df, _ = synthetic_dataflow(args.synthetic_size, config.batch_size, config.innum,
                                     config.ptnum)
    # held-out split: a disjoint generator seed, so eval measures
    # generalisation instead of training-set recall
    val_n = args.synthetic_val_size or max(8, config.eval_size)
    val_seed = 1234 if args.synthetic_val_size else 0
    valid_df, valid_num = synthetic_dataflow(val_n, config.eval_size, config.innum,
                                             config.ptnum, is_training=False, seed=val_seed)
    train(config, train_df, valid_df, valid_num, device)


if __name__ == "__main__":
    main()

"""Training loop — port of ``rfnet_tpu/train.py`` on one device.

    python -m rfnet_tpu_torch.train --train_path train.lmdb \\
        --val_path valid.lmdb --workdir runs/modelvv_recon   # PCN, on the card
    python -m rfnet_tpu_torch.train --synthetic --steps 4 --ckpt_every 2 \\
        --workdir runs/modelvv_recon [--preload_device]
    python -m rfnet_tpu_torch.train --synthetic_online --steps 4 --ckpt_every 2
    python -m rfnet_tpu_torch.train --synthetic --device cpu --innum 64 \\
        --ptnum 128 --n_seed 4 --up_ratio 4 --batch_size 2 --steps 4 --ckpt_every 2

* Data: without ``--synthetic`` the PCN tensorpack LMDB files
  ``--train_path`` (shuffled) and ``--val_path`` (in order, ``eval_size`` a
  batch), read by ``data.dataset.lmdb_dataflow``; one process is shard 0 of
  1. Each batch is copied to the device at its step, unless
  ``--preload_device`` uploads the whole training set once (partials of at
  least ``innum`` points), computes the ground truth's FPS pyramids once in
  chunks of 64, and gathers each batch on the device from the dataflow's own
  index stream: the same batches and pyramids, bit for bit. With
  ``--synthetic_online`` every batch is generated on the device from
  (seed, step) (``data/online.py``), and the eval set is the held-out
  synthetic set of seed 1234.
* One train step = the model's forward, ``losses.total_loss`` (with the 64-
  and 1 024-point FPS pyramids of the ground truth made in the step, as the
  reference makes them in its graph, or passed in), the backward and one
  Adam update. The state (model, optimizer, step count) is updated in
  place. ``TrainConfig.compute_dtype`` "bfloat16" computes the feature MLPs
  in bfloat16, the parameters, coordinates and gradients staying float32.
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
  appended to ``<workdir>/../logs/metrics.jsonl``, with the eval scores, and
  written as TensorBoard scalars (``loss/<term>``,
  ``throughput/clouds_per_sec``) into the same directory where the
  ``tensorboard`` package is installed; ``--tb_histograms`` adds one
  histogram per parameter, under its ``state_dict`` name.
* ``--debug_nans`` stops at the first non-finite loss term or NaN gradient
  with ``FloatingPointError`` naming the step; ``--profile_dir`` writes a
  ``torch.profiler`` Chrome trace of the run.

The model's initial weights come from a torch generator seeded by
``config.seed``, so they differ from the JAX package's flax init by design;
``compat.convert`` carries flax weights across where equal weights matter.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import re
import time

import numpy as np
import torch

from rfnet_tpu_torch import losses
from rfnet_tpu_torch.data import online
from rfnet_tpu_torch.data.dataset import resample_pcd
from rfnet_tpu_torch.eval import profile_trace, refuse_unported, resolve_device
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
    # "bfloat16" computes the feature MLPs in bfloat16 (parameters,
    # coordinates and gradients stay float32), as the JAX package's does
    compute_dtype: str = "float32"
    # compresses the LR/α₁ schedule boundaries for runs shorter than the
    # reference's 300k steps (1.0 = the reference)
    schedule_scale: float = 1.0
    # one TensorBoard histogram per parameter at every log step (each reads
    # every parameter back to the host); the scalars are always written
    tb_histograms: bool = False


_COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


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
    if config.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {config.compute_dtype!r}: expected one of "
                         f"{sorted(_COMPUTE_DTYPES)}")
    model = RFNet(n_seed=config.n_seed, up_ratio=config.up_ratio,
                  generator=torch.Generator().manual_seed(config.seed),
                  dtype=_COMPUTE_DTYPES[config.compute_dtype]).to(device)
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
               n2: int, schedule_scale: float = 1.0, debug_nans: bool = False):
    """One optimisation step; n1/n2 are the coarse pyramid sizes.
    Returns (LossBreakdown, diagnostics), both detached."""
    gt1 = gather_point(gt, farthest_point_sample(n1, gt))
    gt2 = gather_point(gt, farthest_point_sample(n2, gt))
    return train_step_pyr(state, partial, gt, gt1, gt2, schedule_scale=schedule_scale,
                          debug_nans=debug_nans)


@contextlib.contextmanager
def _nan_guard(step: int):
    """``--debug_nans`` around a step's forward and backward: autograd's
    anomaly mode checks every backward function's outputs for NaN, and its
    error becomes ``FloatingPointError`` naming the step."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as exc:
        if "returned nan values" not in str(exc):
            raise
        raise FloatingPointError(f"step {step}: {exc}") from exc


def _check_finite(lb: losses.LossBreakdown, step: int) -> None:
    """Raise ``FloatingPointError`` naming the step and the terms where a
    loss term is not finite (one read-back of all of them)."""
    finite = torch.isfinite(torch.stack([t.detach().float() for t in lb])).tolist()
    bad = [name for name, ok in zip(lb._fields, finite) if not ok]
    if bad:
        raise FloatingPointError(f"step {step}: non-finite loss terms {bad}")


def train_step_pyr(state: TrainState, partial: torch.Tensor, gt: torch.Tensor,
                   gt1: torch.Tensor, gt2: torch.Tensor, *, schedule_scale: float = 1.0,
                   debug_nans: bool = False):
    """The step with the ground truth's FPS pyramids passed in. The
    parameters' ``.grad`` hold this step's gradients afterwards. With
    ``debug_nans`` a non-finite loss term or a NaN in the backward raises
    ``FloatingPointError`` before the update."""
    state.optimizer.zero_grad(set_to_none=True)
    with _nan_guard(state.step) if debug_nans else contextlib.nullcontext():
        out = state.model(partial)
        lb = losses.total_loss(out, gt, gt1, gt2, state.step, schedule_scale)
        if debug_nans:
            _check_finite(lb, state.step)
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


def preload_device_data(train_df, config: TrainConfig, device: torch.device):
    """Upload the whole training set to ``device`` once; batches then become
    gathers on the device driven by the dataflow's own index stream.

    Valid where every partial has at least ``innum`` points: resampling is
    then a truncation that draws nothing from the host path's RNG, so the
    gathered batches equal the host path's bit for bit.
    Returns (partials (N, innum, 3), gts (N, ptnum, 3), index stream)."""
    parts, gts = [], []
    for i in range(train_df.size):
        _, partial, gt = train_df._load(i)
        if partial.shape[0] < config.innum:
            raise ValueError(
                "preload_device requires partials with >= innum points "
                "(smaller partials take the RNG duplicate-padding path, "
                "which is per-batch-stateful on the host)"
            )
        parts.append(resample_pcd(partial, config.innum))
        gts.append(resample_pcd(gt, config.ptnum))
    return (torch.from_numpy(np.stack(parts).astype(np.float32)).to(device),
            torch.from_numpy(np.stack(gts).astype(np.float32)).to(device),
            train_df._index_stream())


def _precompute_pyramids(gts: torch.Tensor, n1: int, n2: int, chunk: int = 64):
    """The FPS pyramids (N, n1, 3) and (N, n2, 3) of a device-resident
    ground-truth set, in chunks of ``chunk`` clouds (the last one ragged).
    FPS is a function of each row alone, so they equal the pyramids a step
    computes from the same rows."""
    g1s, g2s = [], []
    for lo in range(0, gts.shape[0], chunk):
        g = gts[lo:lo + chunk]
        g1s.append(gather_point(g, farthest_point_sample(n1, g)))
        g2s.append(gather_point(g, farthest_point_sample(n2, g)))
    return torch.cat(g1s), torch.cat(g2s)


def _tb_writer(logdir: str):
    """A TensorBoard writer into ``logdir``, or None where the tensorboard
    package is not installed, as the JAX package's writer is None without
    TensorFlow. Imported here, not with the module: on a machine with
    TensorFlow the import takes seconds."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:
        print(f"TensorBoard scalars not written: {exc}")
        return None
    return SummaryWriter(logdir)


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
          device: torch.device | str = "cuda", *, preload_device: bool = False,
          synthetic_online: bool = False, debug_nans: bool = False) -> TrainState:
    """Train from ``state.step`` (the latest checkpoint's, or 0) to
    ``config.iters``. Batches come from ``train_df`` (copied to the device
    each step, or, with ``preload_device``, uploaded once and gathered on
    it) or, with ``synthetic_online``, are generated on the device."""
    device = resolve_device(device)
    state = create_state(config, device)
    restore_if_available(state, config.workdir)
    root = os.path.join(config.workdir, "..")
    best_dir = os.path.join(root, "bestrecord")
    best_meta = os.path.join(best_dir, "best.json")
    logs = os.path.join(root, "logs")
    os.makedirs(logs, exist_ok=True)
    metrics_path = os.path.join(logs, "metrics.jsonl")
    # best-by-CD survives restarts, so a resumed run's first eval cannot
    # overwrite a better earlier record
    best_cd = _read_best_cd(best_meta)
    if best_cd < float("inf"):
        print(f"best-so-far cd {best_cd:.6f} (from {best_meta})")
    n1 = 2 * config.n_seed
    n2 = n1 * config.up_ratio
    step_kw = dict(schedule_scale=config.schedule_scale, debug_nans=debug_nans)
    bs = config.batch_size
    train_gen = None
    if synthetic_online:
        def take_step():
            partial, gt = online.synthetic_batch(config.seed, state.step, bs, config.innum,
                                                 config.ptnum, device)
            return train_step(state, partial, gt, n1=n1, n2=n2, **step_kw)
    elif preload_device:
        partials, gts, index_iter = preload_device_data(train_df, config, device)
        gt1s, gt2s = _precompute_pyramids(gts, n1, n2)

        def take_step():
            idx = torch.from_numpy(np.fromiter((next(index_iter) for _ in range(bs)),
                                               dtype=np.int64, count=bs)).to(device)
            rows = (x.index_select(0, idx) for x in (partials, gts, gt1s, gt2s))
            return train_step_pyr(state, *rows, **step_kw)
    else:
        train_gen = iter(train_df)

        def take_step():
            _, batch_point, _, output_point = next(train_gen)
            return train_step(state, torch.from_numpy(batch_point).to(device),
                              torch.from_numpy(output_point).to(device), n1=n1, n2=n2,
                              **step_kw)
    start = state.step
    valid_iter = iter(valid_df)
    tb = _tb_writer(logs)
    t_last = time.perf_counter()
    try:
        for i in range(start, config.iters):
            lb, diag = take_step()
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
                if tb is not None:
                    for k, v in lb_host.items():
                        tb.add_scalar(f"loss/{k}", v, i)
                    tb.add_scalar("throughput/clouds_per_sec", rate, i)
                    if config.tb_histograms:
                        for name, p in state.model.state_dict().items():
                            tb.add_histogram(name, p.detach().cpu().numpy(), i)
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
        if train_gen is not None:
            train_gen.close()
        valid_iter.close()
        if tb is not None:
            tb.close()
    print(f"trained {state.step - start} steps (now at step {state.step})")
    return state


# flags of the JAX package's CLI that the port does not have yet (ROADMAP.md §1)
_NOT_PORTED = ("--mesh", "--distributed")


def main(argv=None):
    p = argparse.ArgumentParser(description="RFNet training (PyTorch port)")
    p.add_argument("--train_path", default="../../dense_data/train.lmdb")
    p.add_argument("--val_path", default="../../dense_data/valid.lmdb")
    p.add_argument("--synthetic", action="store_true", help="train on synthetic clouds")
    p.add_argument("--synthetic_size", type=int, default=256)
    p.add_argument("--synthetic_val_size", type=int, default=None,
                   help="held-out synthetic validation set of this many samples "
                   "(disjoint generator seed); default the in-sample 8 (64 held-out "
                   "samples under --synthetic_online)")
    p.add_argument("--synthetic_online", action="store_true",
                   help="generate every training batch on the device from (seed, step) "
                   "(data/online.py): no host-to-device batch copy, no finite set; eval "
                   "on the held-out seed-1234 synthetic set")
    p.add_argument("--preload_device", action="store_true",
                   help="upload the whole training set to the device once, compute the "
                   "ground truth's FPS pyramids once, and gather each batch on the "
                   "device (partials must have >= innum points, e.g. --synthetic)")
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
    p.add_argument("--tb_histograms", action="store_true",
                   help="also write one TensorBoard histogram per parameter every log step "
                   "(reads every parameter back to the host)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run (host activity, and "
                   "the card's kernels and copies) to <dir>/trace.json")
    p.add_argument("--debug_nans", action="store_true",
                   help="stop at the first non-finite loss term or NaN gradient with "
                   "FloatingPointError (autograd anomaly mode; slow)")
    refuse_unported(p, argv, _NOT_PORTED)
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
    if args.tb_histograms:
        config = dataclasses.replace(config, tb_histograms=True)
    device = resolve_device(args.device)

    from rfnet_tpu_torch.data.dataset import lmdb_dataflow, synthetic_dataflow

    if args.synthetic_online:
        train_df = None  # batches come from the on-device stream
        valid_df, valid_num = synthetic_dataflow(args.synthetic_val_size or 64,
                                                 config.eval_size, config.innum, config.ptnum,
                                                 is_training=False, seed=1234)
    elif args.synthetic:
        train_df, _ = synthetic_dataflow(args.synthetic_size, config.batch_size, config.innum,
                                         config.ptnum)
        # held-out split: a disjoint generator seed, so eval measures
        # generalisation instead of training-set recall
        val_n = args.synthetic_val_size or max(8, config.eval_size)
        val_seed = 1234 if args.synthetic_val_size else 0
        valid_df, valid_num = synthetic_dataflow(val_n, config.eval_size, config.innum,
                                                 config.ptnum, is_training=False, seed=val_seed)
    else:
        for flag, path in (("--train_path", args.train_path), ("--val_path", args.val_path)):
            if not os.path.exists(path):
                p.error(f"{flag} {path}: no such LMDB file or directory (pass --synthetic to "
                        "train on synthetic clouds)")
        train_df, _ = lmdb_dataflow(args.train_path, config.batch_size, config.innum,
                                    config.ptnum, True)
        valid_df, valid_num = lmdb_dataflow(args.val_path, config.eval_size, config.innum,
                                            config.ptnum, False)
    with profile_trace(args.profile_dir, device):
        train(config, train_df, valid_df, valid_num, device,
              preload_device=args.preload_device, synthetic_online=args.synthetic_online,
              debug_nans=args.debug_nans)


if __name__ == "__main__":
    main()

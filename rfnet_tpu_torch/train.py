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
import math
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from rfnet_tpu_torch import losses
from rfnet_tpu_torch.data import online
from rfnet_tpu_torch.data.dataset import resample_pcd
from rfnet_tpu_torch.eval import profile_trace, resolve_device
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.ops.chamfer import chamfer_means
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point
from rfnet_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    maybe_initialize_distributed,
    shard_batch,
    torchrun_world,
)
from rfnet_tpu_torch.parallel.mesh import TORCHRUN_ENV


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
               n2: int, schedule_scale: float = 1.0, debug_nans: bool = False,
               mesh: Mesh | None = None):
    """One optimisation step; n1/n2 are the coarse pyramid sizes.
    Returns (LossBreakdown, diagnostics), both detached."""
    gt1 = gather_point(gt, farthest_point_sample(n1, gt))
    gt2 = gather_point(gt, farthest_point_sample(n2, gt))
    return train_step_pyr(state, partial, gt, gt1, gt2, schedule_scale=schedule_scale,
                          debug_nans=debug_nans, mesh=mesh)


@contextlib.contextmanager
def _nan_guard(step: int, mesh: Mesh | None = None):
    """``--debug_nans`` around a step's forward and backward: autograd's
    anomaly mode checks every backward function's outputs for NaN, and its
    error becomes ``FloatingPointError`` naming the step. With a mesh the
    ranks first agree (one all_reduce MAX of a flag) whether any of them
    met a NaN, so they all raise together and none waits alone in the
    gradient all_reduce."""
    error = None
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as exc:
        if "returned nan values" not in str(exc):
            raise
        error = exc
    if mesh is not None:
        flag = torch.tensor([float(error is not None)], device=mesh.device)
        if mesh.all_reduce_(flag, "max").item() and error is None:
            raise FloatingPointError(f"step {step}: NaN values in the backward of another rank")
    if error is not None:
        raise FloatingPointError(f"step {step}: {error}") from error


def _check_finite(lb: losses.LossBreakdown, step: int) -> None:
    """Raise ``FloatingPointError`` naming the step and the terms where a
    loss term is not finite (one read-back of all of them)."""
    finite = torch.isfinite(torch.stack([t.detach().float() for t in lb])).tolist()
    bad = [name for name, ok in zip(lb._fields, finite) if not ok]
    if bad:
        raise FloatingPointError(f"step {step}: non-finite loss terms {bad}")


def _report(lb: losses.LossBreakdown, out, mesh: Mesh | None):
    """The step's loss terms and diagnostics, detached. The diagnostics read
    the first row of the batch, as the reference's do. With a mesh both are
    the global batch's on every rank: the terms are the ranks' mean (one
    all_reduce SUM), the diagnostics the lead rank's (its rows start the
    global batch; the others add 0 to the SUM and -inf to a MAX)."""
    codes = [c[0, 0].detach() for c in (out.code1, out.code2, out.code3)]
    if mesh is None:
        c1, c2, c3 = codes
        return losses.LossBreakdown(*(t.detach() for t in lb)), {
            "code1_first": c1[0],
            "code1_nonzero": torch.sum(c1 != 0),
            "code2_nonzero": torch.sum(c2 != 0),
            "code3_nonzero": torch.sum(c3 != 0),
            "code1_max": torch.max(c1),
            "code2_max": torch.max(c2),
            "code3_max": torch.max(c3),
        }
    firsts = torch.stack([codes[0][0].float(), *(torch.sum(c != 0).float() for c in codes)])
    maxes = torch.stack([torch.max(c).float() for c in codes])
    if not mesh.is_lead:
        firsts.zero_()
        maxes.fill_(-float("inf"))
    n = len(lb)
    sums = mesh.all_reduce_(torch.cat([torch.stack([t.detach().float() for t in lb]), firsts]))
    maxes = mesh.all_reduce_(maxes, "max")
    terms = sums[:n] / mesh.size
    return losses.LossBreakdown(*terms.unbind()), {
        "code1_first": sums[n],
        **{f"code{k}_nonzero": sums[n + k].long() for k in (1, 2, 3)},
        **{f"code{k}_max": maxes[k - 1] for k in (1, 2, 3)},
    }


def _all_reduce_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """The ranks' mean of every parameter's ``.grad``: one all_reduce SUM of
    the gradients flattened into one buffer, divided by the world size.
    Parameters without a gradient (the same on every rank) are left out."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads])).div_(mesh.size)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def train_step_pyr(state: TrainState, partial: torch.Tensor, gt: torch.Tensor,
                   gt1: torch.Tensor, gt2: torch.Tensor, *, schedule_scale: float = 1.0,
                   debug_nans: bool = False, mesh: Mesh | None = None):
    """The step with the ground truth's FPS pyramids passed in. The
    parameters' ``.grad`` hold this step's gradients afterwards. With
    ``debug_nans`` a non-finite loss term or a NaN in the backward raises
    ``FloatingPointError`` before the update.

    With a ``mesh`` the tensors are this rank's rows of the global batch:
    the loss is the global batch's (``losses.total_loss`` with the mesh),
    the gradients are all-reduced to the ranks' mean before the update, and
    the terms and diagnostics returned are the global batch's, so the
    replicated parameters stay equal on every rank."""
    state.optimizer.zero_grad(set_to_none=True)
    with _nan_guard(state.step, mesh) if debug_nans else contextlib.nullcontext():
        out = state.model(partial)
        lb = losses.total_loss(out, gt, gt1, gt2, state.step, schedule_scale, mesh)
        report, diag = _report(lb, out, mesh)
        if debug_nans:
            _check_finite(report, state.step)
        lb.total.backward()
    if mesh is not None:
        _all_reduce_grads(state.model, mesh)
    apply_gradients(state, schedule_scale)
    return report, diag


@torch.no_grad()
def eval_step(state: TrainState, partial: torch.Tensor, gt: torch.Tensor):
    """(chamfer, emd) of the final output (the reference's eval_one_batch)."""
    out4 = state.model(partial).out4
    ma, mb = chamfer_means(gt, out4)
    return (ma + mb) / 2.0, losses.earth_mover_eval(gt, out4)


def _tile_for_devices(arr: np.ndarray, n_devices: int) -> np.ndarray:
    """Repeat the batch k times so it splits over n_devices.

    Every row appears exactly k times, so any per-batch MEAN metric is
    unchanged: eval batches (default 4) split over more ranks with exact
    metric parity."""
    b = arr.shape[0]
    if n_devices <= 1 or b % n_devices == 0:
        return arr
    k = n_devices // math.gcd(b, n_devices)
    return np.tile(arr, (k,) + (1,) * (arr.ndim - 1))


def evaluate(state: TrainState, valid_iter, valid_num: int, config: TrainConfig,
             place, mesh: Mesh | None = None) -> tuple[float, float]:
    """Mean CD and EMD over ``valid_num // eval_size`` batches of the
    persistent eval iterator; ``place`` puts this rank's rows of a host
    batch on its device. With a mesh each rank scores its rows and the
    means are the ranks' mean (one all_reduce a batch), the same on every
    rank."""
    cds, emds = [], []
    for _ in range(max(1, valid_num // config.eval_size)):
        _, batch_point, _, output_point = next(valid_iter)
        scores = torch.stack(eval_step(state, place(batch_point), place(output_point)))
        cd, emd = (scores if mesh is None else mesh.mean(scores)).tolist()
        cds.append(cd)
        emds.append(emd)
    return float(np.mean(cds)), float(np.mean(emds))


def preload_device_data(train_df, config: TrainConfig, device: torch.device,
                        mesh: Mesh | None = None):
    """Upload the whole training set to ``device`` once; batches then become
    gathers on the device driven by the dataflow's own index stream.

    Valid where every partial has at least ``innum`` points: resampling is
    then a truncation that draws nothing from the host path's RNG, so the
    gathered batches equal the host path's bit for bit.

    With a mesh the set is split by sample over the ranks, padded to a
    multiple of the world size with copies of row 0 (which the index stream
    never names): each rank loads and holds only its N/W rows, and the ranks
    agree (one all_reduce MAX) whether any partial was short before any
    raises. Returns (partials (N, innum, 3), gts (N, ptnum, 3), index
    stream): this rank's rows under a mesh."""
    n = train_df.size
    rows = range(n)
    if mesh is not None:
        span = mesh.rows(-(-n // mesh.size) * mesh.size)
        rows = range(span.start, span.stop)
    parts, gts, short = [], [], False
    for i in rows:
        _, partial, gt = train_df._load(i if i < n else 0)
        if partial.shape[0] < config.innum:
            short = True
            break
        parts.append(resample_pcd(partial, config.innum))
        gts.append(resample_pcd(gt, config.ptnum))
    if mesh is not None:
        short = bool(mesh.all_reduce_(torch.tensor([float(short)], device=device), "max"))
    if short:
        raise ValueError(
            "preload_device requires partials with >= innum points "
            "(smaller partials take the RNG duplicate-padding path, "
            "which is per-batch-stateful on the host)"
        )
    return (torch.from_numpy(np.stack(parts).astype(np.float32)).to(device),
            torch.from_numpy(np.stack(gts).astype(np.float32)).to(device),
            train_df._index_stream())


def _precompute_pyramids(gts: torch.Tensor, n1: int, n2: int, chunk: int = 64):
    """The FPS pyramids (N, n1, 3) and (N, n2, 3) of a device-resident
    ground-truth set, in chunks of ``chunk`` clouds (the last one ragged).
    FPS is a function of each row alone, so they equal the pyramids a step
    computes from the same rows (and a rank's shard's, those of its rows)."""
    g1s, g2s = [], []
    for lo in range(0, gts.shape[0], chunk):
        g = gts[lo:lo + chunk]
        g1s.append(gather_point(g, farthest_point_sample(n1, g)))
        g2s.append(gather_point(g, farthest_point_sample(n2, g)))
    return torch.cat(g1s), torch.cat(g2s)


def _resident_gather(resident: torch.Tensor, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the global batch ``idx`` (B indices into the whole
    set) from a resident set split by sample over the mesh, the JAX
    package's psum gather: each rank takes the named rows that lie in its
    shard and zeros for the rest, one all_reduce SUM assembles the batch on
    every rank, and each keeps its rows. Each row is summed with W−1 exact
    zeros, so the batch equals a plain ``index_select`` of the whole set bit
    for bit."""
    shard_n = resident.shape[0]
    rel = idx - mesh.rank * shard_n
    own = (rel >= 0) & (rel < shard_n)
    rows = resident.index_select(0, rel.clamp(0, shard_n - 1))
    batch = torch.where(own.view(-1, *(1,) * (rows.dim() - 1)), rows, 0.0)
    return mesh.all_reduce_(batch)[mesh.rows(idx.shape[0])]


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


def _check_shards(df, mesh: Mesh | None, what: str) -> bool:
    """Whether ``df`` yields this rank's rows alone (a dataflow shard of the
    mesh, ``--distributed``) rather than the global batches every rank
    reads (one shard)."""
    shards = 1 if df is None else df.num_shards
    if shards == 1:
        return False
    if mesh is None or shards != mesh.size or df.shard_id != mesh.rank:
        where = "has no mesh" if mesh is None else f"is rank {mesh.rank} of {mesh.size}"
        raise ValueError(f"the {what} dataflow is shard {df.shard_id} of {shards}; "
                         f"this process {where}")
    return True


def train(config: TrainConfig, train_df, valid_df, valid_num: int,
          device: torch.device | str = "cuda", *, preload_device: bool = False,
          synthetic_online: bool = False, debug_nans: bool = False,
          mesh: Mesh | None = None) -> TrainState:
    """Train from ``state.step`` (the latest checkpoint's, or 0) to
    ``config.iters``. Batches come from ``train_df`` (copied to the device
    each step, or, with ``preload_device``, uploaded once and gathered on
    it) or, with ``synthetic_online``, are generated on the device.

    With a ``mesh`` (``parallel.make_mesh``) this process is one rank of a
    data-parallel world on ``mesh.device``, and ``config.batch_size`` is
    the global batch. Each rank steps on its B/W rows of it: rows
    ``[r·B/W, (r+1)·B/W)`` of the global batches that a one-shard dataflow
    gives every rank, or all the rows of its own dataflow shard (shard r of
    W, at B/W; ``preload_device`` takes the one global stream only). The
    gradients are all-reduced, so the parameters stay equal on all ranks.
    Rank 0 writes the checkpoints, the best record, the metrics and the
    TensorBoard events; every rank restores the latest checkpoint, after a
    barrier, and takes rank 0's parameters."""
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    sharded = _check_shards(train_df, mesh, "training")
    valid_sharded = _check_shards(valid_df, mesh, "eval")
    if preload_device and sharded:
        # each rank's dataflow shard has its own index stream; the global
        # epoch permutation the gather replays does not decompose
        raise ValueError("--preload_device takes the one global stream (--mesh), not "
                         "dataflow shards (--distributed); the multi-process fast path is "
                         "--synthetic_online")
    lead = mesh is None or mesh.is_lead
    state = create_state(config, device)
    if mesh is not None:
        mesh.build_kernels()  # also the barrier before every rank restores
    restore_if_available(state, config.workdir)
    if mesh is not None:
        for t in state.model.state_dict().values():
            mesh.broadcast_(t)
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
    step_kw = dict(schedule_scale=config.schedule_scale, debug_nans=debug_nans, mesh=mesh)
    bs = config.batch_size
    mine = slice(None) if mesh is None else mesh.rows(bs)  # this rank's rows of a batch

    def place(batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch if sharded else batch[mine]).to(device)

    def place_eval(batch: np.ndarray) -> torch.Tensor:
        if mesh is None or valid_sharded:
            return torch.from_numpy(batch).to(device)
        return shard_batch(_tile_for_devices(batch, mesh.size), mesh)

    train_gen = None
    if synthetic_online:
        def take_step():
            partial, gt = online.synthetic_batch(config.seed, state.step, bs, config.innum,
                                                 config.ptnum, device)
            return train_step(state, partial[mine].contiguous(), gt[mine].contiguous(),
                              n1=n1, n2=n2, **step_kw)
    elif preload_device:
        partials, gts, index_iter = preload_device_data(train_df, config, device, mesh)
        gt1s, gt2s = _precompute_pyramids(gts, n1, n2)
        if mesh is not None:
            resident = torch.cat([partials, gts, gt1s, gt2s], dim=1)
            widths = [x.shape[1] for x in (partials, gts, gt1s, gt2s)]
            del partials, gts, gt1s, gt2s

        def take_step():
            idx = torch.from_numpy(np.fromiter((next(index_iter) for _ in range(bs)),
                                               dtype=np.int64, count=bs)).to(device)
            if mesh is None:
                rows = [x.index_select(0, idx) for x in (partials, gts, gt1s, gt2s)]
            else:
                rows = [x.contiguous() for x in
                        _resident_gather(resident, idx, mesh).split(widths, dim=1)]
            return train_step_pyr(state, *rows, **step_kw)
    else:
        train_gen = iter(train_df)

        def take_step():
            _, batch_point, _, output_point = next(train_gen)
            return train_step(state, place(batch_point), place(output_point), n1=n1, n2=n2,
                              **step_kw)
    start = state.step
    valid_iter = iter(valid_df)
    tb = _tb_writer(logs) if lead else None
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
                if lead:
                    _append_jsonl(metrics_path, {"step": i, **lb_host})
                if tb is not None:
                    for k, v in lb_host.items():
                        tb.add_scalar(f"loss/{k}", v, i)
                    tb.add_scalar("throughput/clouds_per_sec", rate, i)
                    if config.tb_histograms:
                        for name, p in state.model.state_dict().items():
                            tb.add_histogram(name, p.detach().cpu().numpy(), i)
            if (i + 1) % config.ckpt_every == 0:
                if lead:
                    save_checkpoint(state, config.workdir, config.max_to_keep)
                mean_cd, mean_emd = evaluate(state, valid_iter, valid_num, config, place_eval,
                                             mesh)
                print(f"eval @ {i + 1}: mean cd {mean_cd:.6f} mean emd {mean_emd:.6f}")
                if lead:
                    _append_jsonl(metrics_path,
                                  {"step": i + 1, "eval_cd": mean_cd, "eval_emd": mean_emd})
                # the means are the same on every rank, and so is this decision
                if mean_cd < best_cd:
                    best_cd = mean_cd
                    if lead:
                        os.makedirs(best_dir, exist_ok=True)
                        _save_atomic(state.model.state_dict(),
                                     os.path.join(best_dir, "model.pt"))
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default; under a mesh the card LOCAL_RANK) or cpu")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over the ranks torchrun starts (torchrun "
                   "--nproc_per_node N -m rfnet_tpu_torch.train --mesh ...; NCCL a card, gloo "
                   "on the CPU): every rank reads the global batches and steps on its 1/N of "
                   "the rows; gradients all-reduced; a world of 1 outside torchrun")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process data: each torchrun rank reads its own 1/N shard of "
                   "the dataflow at 1/N of the batch and eval sizes (needs torchrun's "
                   "environment); implies --mesh")
    p.add_argument("--tb_histograms", action="store_true",
                   help="also write one TensorBoard histogram per parameter every log step "
                   "(reads every parameter back to the host)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run (host activity, and "
                   "the card's kernels and copies) to <dir>/trace.json, under a mesh one "
                   "<dir>/trace_rank<r>.json a rank")
    p.add_argument("--debug_nans", action="store_true",
                   help="stop at the first non-finite loss term or NaN gradient with "
                   "FloatingPointError (autograd anomaly mode; slow)")
    args = p.parse_args(argv)
    if args.distributed:
        args.mesh = True
        if torchrun_world() is None and not dist.is_initialized():
            p.error("--distributed needs torchrun's environment (" + ", ".join(TORCHRUN_ENV)
                    + "): launch it with torchrun --nproc_per_node N -m "
                    "rfnet_tpu_torch.train --distributed ...")

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
    # every check that could differ between ranks runs before the group forms
    world = 1
    if args.mesh:
        world = dist.get_world_size() if dist.is_initialized() else torchrun_world() or 1
        if config.batch_size % world:
            p.error(f"--batch_size {config.batch_size} does not split over the mesh's "
                    f"{world} ranks")
    # per-process input: with --distributed each rank loads a disjoint 1/world
    # of the data at 1/world of the global batch and eval sizes; otherwise
    # every process reads the global stream (shard 0 of 1)
    pc = world if args.distributed else 1
    if config.batch_size % pc or config.eval_size % pc:
        p.error(f"batch_size {config.batch_size} / eval_size {config.eval_size} "
                f"must divide by process_count {pc}")
    if not (args.synthetic or args.synthetic_online):
        for flag, path in (("--train_path", args.train_path), ("--val_path", args.val_path)):
            if not os.path.exists(path):
                p.error(f"{flag} {path}: no such LMDB file or directory (pass --synthetic to "
                        "train on synthetic clouds)")

    formed, mesh = False, None
    if args.mesh:
        formed = maybe_initialize_distributed(args.device)
        mesh = make_mesh(world, args.device)
        device = mesh.device
        shard_kw = dict(shard_id=mesh.rank if args.distributed else 0, num_shards=pc)
        print(f"mesh: rank {mesh.rank} of {mesh.size} on {device}"
              f"{' (dataflow shard %d of %d)' % (mesh.rank, pc) if args.distributed else ''}")
    else:
        device = resolve_device(args.device)
        shard_kw = {}
    local_bs = config.batch_size // pc
    local_eval = config.eval_size // pc

    from rfnet_tpu_torch.data.dataset import lmdb_dataflow, synthetic_dataflow

    try:
        if args.synthetic_online:
            train_df = None  # batches come from the on-device stream
            valid_df, valid_num = synthetic_dataflow(args.synthetic_val_size or 64, local_eval,
                                                     config.innum, config.ptnum,
                                                     is_training=False, seed=1234, **shard_kw)
        elif args.synthetic:
            train_df, _ = synthetic_dataflow(args.synthetic_size, local_bs, config.innum,
                                             config.ptnum, **shard_kw)
            # held-out split: a disjoint generator seed, so eval measures
            # generalisation instead of training-set recall
            val_n = args.synthetic_val_size or max(8, config.eval_size)
            val_seed = 1234 if args.synthetic_val_size else 0
            valid_df, valid_num = synthetic_dataflow(val_n, local_eval, config.innum,
                                                     config.ptnum, is_training=False,
                                                     seed=val_seed, **shard_kw)
        else:
            train_df, _ = lmdb_dataflow(args.train_path, local_bs, config.innum, config.ptnum,
                                        True, **shard_kw)
            valid_df, valid_num = lmdb_dataflow(args.val_path, local_eval, config.innum,
                                                config.ptnum, False, **shard_kw)
        trace = "trace.json" if mesh is None else f"trace_rank{mesh.rank}.json"
        with profile_trace(args.profile_dir, device, trace):
            train(config, train_df, valid_df, valid_num, device,
                  preload_device=args.preload_device, synthetic_online=args.synthetic_online,
                  debug_nans=args.debug_nans, mesh=mesh)
    finally:
        if formed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

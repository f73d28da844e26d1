"""Evaluation / serving CLI — the ``recon_test.py`` contract, on the card.

Port of ``rfnet_tpu/eval.py``:
  * reads each ``<data_dir>/{partial,complete}/<id>.pcd`` of ``--list_path``,
    completes the partial cloud, and writes ``results.csv`` with header
    ``id,cd,emd`` where ``cd`` is the per-sample chamfer distance and the
    **``emd`` column is the fidelity** (one-sided partial→output mean
    distance), a reference quirk kept for comparability;
  * prints the parameter count first, then "Average time" (excluding the
    first 10 models as warmup) and the overall and per-category means;
  * optional three-view plots every ``--plot_freq`` models and .pcd dumps;
  * ``--pipeline`` keeps ``DEPTH`` batches in flight: batch i+1 is
    dispatched while batch i is read back (pinned host buffers and
    ``non_blocking`` copies on the default stream), and "Average time"
    becomes the amortized wall time per cloud; without it each batch is
    timed to ``synchronize()``, the reference's convention;
  * ``--bf16`` computes the feature MLPs in bfloat16 (parameters and
    coordinates stay float32), the JAX CLI's serving mode;
  * ``--profile_dir`` writes a ``torch.profiler`` Chrome trace of the run,
    which holds the package's spans (``tracing.py``: each batch's
    ``eval.copy_in``, ``eval.metrics`` and the forward's stages by step,
    under ``--pipeline`` inside an ``eval.dispatch``), and ``counters.json``
    beside it (K3's loaded and dense pairs, the kernel launches);
  * ``--mesh N`` serves data-parallel over the N ranks torchrun starts (one
    card a rank with NCCL, or gloo on the CPU): every rank reads each chunk
    of ``batch_size`` clouds (a multiple of N), completes and scores its
    ``batch_size/N`` rows, and one all_reduce gives every rank the chunk's
    per-cloud metrics; rank 0 writes ``results.csv`` and prints, each rank
    writes the plots and ``.pcd`` files of its rows.

``--model`` picks the network: ``rfnet`` (the default, the JAX CLI's) or
``snowflakenet`` (``models/snowflakenet.py``, served at its published PCN
widths); without it, a checkpoint's keys tell. Each partial is resampled to
the model's input size (RFNet 3 000 points, SnowflakeNet 2 048).

Weights (``--checkpoint``, default ``./bestrecord`` as in the JAX CLI)
come from a directory: the trainer's ``bestrecord/`` (its ``model.pt``) or
its workdir (the ``"model"`` entry of the newest ``ckpt_<step>.pt``); or
from a file: a trainer checkpoint ``ckpt_<step>.pt``, a ``torch.save``d
``state_dict`` (``.pt``) or an ``.npz`` of flat flax params (``{"a/b/leaf":
array}``, with the training step under ``__step__``), such as the converged
``weights/rfnet_r4_105000.npz`` that ``tools/export_torch_weights.py``
writes; legacy shared step biases are upgraded on the way
(``compat.ckpt_compat``). The model's size is read off the weights; a
SnowflakeNet comes from a ``state_dict`` (``.pt``) under its module names.
Where there are no weights, the model is a random init from a seed. Runs on
``--device cuda`` unless asked for ``cpu``; a request for ``cuda`` without a
card is an error.

    python -m rfnet_tpu_torch.eval --list_path test.list --data_dir test \\
        --checkpoint weights/rfnet_r4_105000.npz --results_dir results/recon \\
        --batch_size 4 [--pipeline] [--bf16] [--profile_dir trace/]
    python -m rfnet_tpu_torch.eval --model snowflakenet --checkpoint snowflake.pt ...
    torchrun --nproc_per_node 2 -m rfnet_tpu_torch.eval --mesh 2 ... --batch_size 4
"""

from __future__ import annotations

import argparse
import csv
import glob
import importlib.util
import itertools
import os
import queue
import re
import threading
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from rfnet_tpu_torch.compat import ckpt_compat
from rfnet_tpu_torch.compat.convert import flax_to_state_dict
from rfnet_tpu_torch.data.dataset import resample_pcd
from rfnet_tpu_torch.data.pcd_io import read_pcd, save_pcd
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.models.snowflakenet import SnowflakeNet
from rfnet_tpu_torch.ops.chamfer import chamfer_sample_means, nn_sample_mean_one
from rfnet_tpu_torch.parallel import Mesh, make_mesh, maybe_initialize_distributed, torchrun_world
from rfnet_tpu_torch.tracing import profile_trace, span

INPUT_POINTS = 3000  # RFNet's; a model with ``input_points`` takes its own
MODELS = ("rfnet", "snowflakenet")
RANDOM_INIT_SEED = 1  # the JAX TrainConfig's default seed
DEPTH = 3  # batches in flight under --pipeline


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _model_for(state_dict: dict, dtype: torch.dtype | None = None) -> RFNet:
    """An RFNet whose sizes match ``state_dict`` (seed count and up ratio
    read off the ``points_out`` layers), computing in ``dtype``."""
    n_seed = (state_dict["init_cell.points_out.weight"].shape[0] - 12) // 3
    up_ratio = state_dict["decode_cell.points_out.weight"].shape[0] // 3
    return RFNet(n_seed=n_seed, up_ratio=up_ratio, dtype=dtype)


def _load_npz(checkpoint: str, dtype: torch.dtype | None = None) -> RFNet:
    """The model of an ``.npz`` of flat flax params, its size read off the
    kernels: legacy shared step biases upgraded (``ckpt_compat``), renamed
    (``flax_to_state_dict``) and loaded strictly. Prints the training step
    stored in the file."""
    with np.load(checkpoint) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
        step = int(z["__step__"]) if "__step__" in z.files else None
    print(f"checkpoint {checkpoint}: step {step}")
    model = _model_for(flax_to_state_dict(flat), dtype)
    flat, upgraded = ckpt_compat.upgrade(flat, ckpt_compat.expected_shapes(model.state_dict()))
    if upgraded:
        print("checkpoint upgraded from legacy shared-bias layout")
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    return model


CHECKPOINT_NAME = re.compile(r"ckpt_(\d+)\.pt")  # the trainer's checkpoint files


def list_checkpoints(workdir: str) -> list[tuple[int, str]]:
    """(step, path) of every ``ckpt_<step>.pt`` in ``workdir``, oldest first."""
    found = []
    for path in glob.glob(os.path.join(workdir, "ckpt_*.pt")):
        m = CHECKPOINT_NAME.fullmatch(os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def _checkpoint_file(checkpoint: str) -> str | None:
    """The file that holds ``checkpoint``'s weights: the file itself; for a
    directory its ``model.pt`` (the trainer's ``bestrecord/``), else its
    newest ``ckpt_<step>.pt`` (a workdir); None where there is neither."""
    if os.path.isfile(checkpoint):
        return checkpoint
    if not os.path.isdir(checkpoint):
        return None
    best = os.path.join(checkpoint, "model.pt")
    if os.path.isfile(best):
        return best
    found = list_checkpoints(checkpoint)
    return found[-1][1] if found else None


def _snowflake_for(state_dict: dict, sizes: dict | None) -> SnowflakeNet:
    """A SnowflakeNet whose global feature, seeds and up factors match
    ``state_dict``, and whose other sizes are ``sizes`` (as published where
    not given)."""
    dim_feat, _, num_pc = state_dict["decoder.decoder_coarse.ps.weight"].shape
    ups, i = [], 1
    while f"decoder.uppers.{i}.ps.weight" in state_dict:
        ups.append(state_dict[f"decoder.uppers.{i}.ps.weight"].shape[2])
        i += 1
    return SnowflakeNet(dim_feat=dim_feat, num_pc=num_pc, up_factors=tuple(ups), **(sizes or {}))


def load_state(checkpoint: str | None, dtype: torch.dtype | None = None,
               model: str | None = None, sizes: dict | None = None) -> torch.nn.Module:
    """The model with weights from ``checkpoint`` (a directory or a file, as
    the module docstring lists); its feature MLPs compute in ``dtype`` (None
    = float32; SnowflakeNet only float32). ``model`` ("rfnet" or
    "snowflakenet") names the network; None: the checkpoint's keys tell, and
    RFNet where there are none. ``sizes``: SnowflakeNet's sizes that its
    weights do not hold (``num_p0``, ``radius``, ``sa_points``,
    ``input_points``), as published where None.

    Where ``checkpoint`` is None or holds no weights, warns and returns the
    full-size model's random init, drawn from a generator seeded
    ``RANDOM_INIT_SEED``."""
    if model not in (None, *MODELS):
        raise SystemExit(f"--model {model}: one of {', '.join(MODELS)}")
    if model == "snowflakenet" and dtype not in (None, torch.float32):
        raise SystemExit("SnowflakeNet is served in float32 only (no --bf16)")
    path = None if checkpoint is None else _checkpoint_file(checkpoint)
    if path is None:
        print(f"WARNING: no checkpoint under {checkpoint}; evaluating random init")
        g = torch.Generator().manual_seed(RANDOM_INIT_SEED)
        if model == "snowflakenet":
            return SnowflakeNet(generator=g, **(sizes or {}))
        return RFNet(generator=g, dtype=dtype)
    if path.endswith(".npz"):
        if model == "snowflakenet":
            raise SystemExit(f"{path}: an .npz holds RFNet's flax weights, not SnowflakeNet's")
        return _load_npz(path, dtype)
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if CHECKPOINT_NAME.fullmatch(os.path.basename(path)):
        print(f"checkpoint {path}: step {state_dict['step']}")
        state_dict = state_dict["model"]
    snowflake = "decoder.decoder_coarse.ps.weight" in state_dict
    if model is not None and snowflake != (model == "snowflakenet"):
        raise SystemExit(f"{path} holds {'SnowflakeNet' if snowflake else 'RFNet'} weights, "
                         f"not --model {model}'s")
    if snowflake and dtype not in (None, torch.float32):
        raise SystemExit("SnowflakeNet is served in float32 only (no --bf16)")
    net = _snowflake_for(state_dict, sizes) if snowflake else _model_for(state_dict, dtype)
    net.load_state_dict(state_dict, strict=True)
    return net


def resolve_device(name: str | torch.device) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available (pass --device cpu)")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return device


def make_complete_fn(model: torch.nn.Module, mesh: Mesh | None = None):
    """(complete, metrics) pair on the model's device. With a ``mesh`` both
    take this rank's rows of a batch, and ``metrics`` returns the per-cloud
    (cd, fidelity) of the whole batch on every rank: each rank writes its
    rows' values into zeros and one all_reduce SUM fills in the others'."""

    @torch.inference_mode()
    def complete(partial):
        return model(partial).out4

    @torch.inference_mode()
    def metrics(partial, output, gt):
        with span("eval.metrics"):
            m1, m2 = chamfer_sample_means(output, gt)
            scores = torch.stack([(m1 + m2) / 2, nn_sample_mean_one(partial, output)])
            if mesh is not None:
                whole = scores.new_zeros((2, scores.shape[1] * mesh.size))
                whole[:, mesh.rows(whole.shape[1])] = scores
                scores = mesh.all_reduce_(whole)
            return scores[0], scores[1]

    return complete, metrics


def _load_chunks(model_list, bsz, args, out_q, stop):
    """Producer thread: read + resample the next batches while the card
    computes the current one. Any failure is enqueued as the exception
    itself, so the consumer re-raises it instead of waiting forever."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    try:
        for chunk_start in range(0, len(model_list), bsz):
            chunk = model_list[chunk_start : chunk_start + bsz]
            partials, gts = [], []
            for model_id in chunk:
                partial = read_pcd(os.path.join(args.data_dir, "partial", f"{model_id}.pcd"))
                complete_gt = read_pcd(os.path.join(args.data_dir, "complete", f"{model_id}.pcd"))
                partials.append(resample_pcd(partial, args.input_points).astype(np.float32))
                gts.append(resample_pcd(complete_gt, args.num_gt_points).astype(np.float32))
            # pad the final group so every batch has the same shape
            while len(partials) < bsz:
                partials.append(partials[-1])
                gts.append(gts[-1])
            if not put((chunk_start, chunk, np.stack(partials), np.stack(gts))):
                return
        put(None)
    except BaseException as exc:  # re-raised by the consumer loop
        put(exc)


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``; for the card through a pinned buffer and
    a ``non_blocking`` copy (PyTorch's pinned allocator keeps the buffer
    until the copy is done)."""
    t = torch.from_numpy(batch)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


_dispatched = itertools.count()  # the ordinal of each dispatch()ed batch, for its span


def dispatch(complete, metrics, pnp: np.ndarray, gnp: np.ndarray, device: torch.device):
    """Queue one batch's forward, metrics and read-back on ``device``
    without waiting for any of them; :func:`collect` waits. Returns (host
    copies of cds, emds and the completion, an event that completes with
    them): on the card ``non_blocking`` copies into pinned buffers queued
    behind the work; on the CPU the tensors themselves and no event."""
    with span("eval.dispatch", batch=next(_dispatched)):
        with span("eval.copy_in"):
            pb = _to_device(pnp, device)
        completion = complete(pb)
        # the ground truth goes in behind the forward's work, so its buffer
        # is not held across the forward's peak
        with span("eval.copy_in"):
            gb = _to_device(gnp, device)
        out = (*metrics(pb, completion, gb), completion)
        if device.type != "cuda":
            return list(out), None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


def collect(pending) -> list[np.ndarray]:
    """Wait for a :func:`dispatch`'s read-back (reading the batch's metrics
    back bounds its work, as the JAX CLI's ``np.asarray(cds)`` does) and
    return (cds, emds, completion) as arrays."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return [t.numpy() for t in host]


def _serving_mesh(args) -> tuple[Mesh | None, bool]:
    """``--mesh N``'s mesh: N must be torchrun's world size (1 outside
    torchrun) and divide the batch, both checked before the process group
    forms. Returns (mesh, whether this call formed the group)."""
    n = args.mesh
    world = dist.get_world_size() if dist.is_initialized() else torchrun_world() or 1
    if n != world:
        raise SystemExit(f"--mesh {n} needs {n} ranks, and this world has {world}: launch "
                         f"torchrun --nproc_per_node {n} -m rfnet_tpu_torch.eval --mesh {n} ...")
    if max(1, args.batch_size) % n:
        raise SystemExit(f"--batch_size {args.batch_size} must be a multiple of the "
                         f"mesh size {n}")
    formed = maybe_initialize_distributed(args.device)
    return make_mesh(n, args.device), formed


def test(args, mesh: Mesh | None = None):
    """Serve ``args.list_path``; with ``mesh`` (or ``args.mesh`` N, which
    forms the process group from torchrun's environment) as one rank of a
    data-parallel world."""
    formed = False
    if mesh is None and getattr(args, "mesh", 0):
        mesh, formed = _serving_mesh(args)
    elif mesh is not None and (max(1, args.batch_size) % mesh.size
                               or getattr(args, "mesh", 0) not in (0, mesh.size)):
        raise SystemExit(f"--batch_size {args.batch_size} must be a multiple of the "
                         f"mesh size {mesh.size}, and --mesh {args.mesh} equal to it")
    try:
        if mesh is not None:
            mesh.build_kernels()
        device = resolve_device(args.device) if mesh is None else mesh.device
        trace = "trace.json" if mesh is None else f"trace_rank{mesh.rank}.json"
        with profile_trace(args.profile_dir, device, trace):
            _serve(args, device, mesh)
    finally:
        if formed:
            dist.destroy_process_group()


def _serve(args, device: torch.device, mesh: Mesh | None):
    """The serving loop of :func:`test`. Under a mesh every rank reads each
    whole chunk (the loader's resampling draws from the global RNG in row
    order, so each rank draws what one process would) and takes its rows;
    rank 0 writes the CSV and prints."""
    lead = mesh is None or mesh.is_lead
    say = print if lead else (lambda *a, **k: None)
    dtype = torch.bfloat16 if args.bf16 else None
    model = load_state(args.checkpoint, dtype, args.model).to(device).eval()
    args.input_points = getattr(model, "input_points", INPUT_POINTS)
    say("trainable parameters:", count_params(model))
    complete, metrics = make_complete_fn(model, mesh)
    can_plot = importlib.util.find_spec("matplotlib") is not None
    if not can_plot:
        say("plots skipped: matplotlib not installed")

    os.makedirs(args.results_dir, exist_ok=True)
    with open(args.list_path) as f:
        model_list = f.read().splitlines()

    total_time = 0.0
    timed_models = 0
    total_cd = 0.0
    total_emd = 0.0
    cd_per_cat: dict[str, list] = {}
    emd_per_cat: dict[str, list] = {}
    bsz = max(1, args.batch_size)
    mine = slice(0, bsz) if mesh is None else mesh.rows(bsz)  # this rank's rows of a chunk

    load_q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()
    loader = threading.Thread(
        target=_load_chunks, args=(model_list, bsz, args, load_q, stop), daemon=True
    )
    loader.start()
    csv_file = writer = None
    if lead:
        csv_file = open(os.path.join(args.results_dir, "results.csv"), "w", newline="")
        writer = csv.writer(csv_file)
        writer.writerow(["id", "cd", "emd"])

    def get_item():
        """Next loader item; re-raises a loader-thread failure here."""
        item = load_q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def process_results(chunk_start, chunk, pnp, gnp, completion, cds, emds, elapsed):
        nonlocal total_time, timed_models, total_cd, total_emd
        for j, model_id in enumerate(chunk):
            i = chunk_start + j
            if chunk_start >= 10:
                # warmup exclusion: exact at batch 1; at batch_size > 1 a
                # batch straddling index 10 is excluded entirely
                total_time += elapsed
                timed_models += 1
            cd, emd = float(cds[j]), float(emds[j])
            total_cd += cd
            total_emd += emd
            if lead:
                writer.writerow([model_id, cd, emd])
            synset_id, short_id = model_id.split("/")
            cd_per_cat.setdefault(synset_id, []).append(cd)
            emd_per_cat.setdefault(synset_id, []).append(emd)
            if not mine.start <= j < mine.stop:
                continue  # another rank's cloud: its plot and .pcd are that rank's
            if i % args.plot_freq == 0 and can_plot:
                from rfnet_tpu_torch.visu import plot_pcd_three_views

                plot_dir = os.path.join(args.results_dir, "plots", synset_id)
                os.makedirs(plot_dir, exist_ok=True)
                plot_pcd_three_views(
                    os.path.join(plot_dir, f"{short_id}.png"),
                    [pnp[j], completion[j - mine.start], gnp[j]],
                    ["input", "output", "ground truth"],
                    f"CD {cd:.4f}  EMD {emd:.4f}",
                    [5, 0.5, 0.5],
                )
            if args.save_pcd:
                pcd_dir = os.path.join(args.results_dir, "pcds", synset_id)
                os.makedirs(pcd_dir, exist_ok=True)
                save_pcd(os.path.join(pcd_dir, f"{short_id}.pcd"), completion[j - mine.start])

    try:
        if not args.pipeline:
            # the reference's convention: each batch's forward timed to
            # synchronize(); only the disk reads overlap
            while (item := get_item()) is not None:
                chunk_start, chunk, pnp, gnp = item
                with span("eval.copy_in"):
                    pb = torch.from_numpy(pnp[mine]).to(device)
                    gb = torch.from_numpy(gnp[mine]).to(device)
                start = time.time()
                completion = complete(pb)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                elapsed = (time.time() - start) / bsz
                cds, emds = metrics(pb, completion, gb)
                process_results(chunk_start, chunk, pnp, gnp, completion.cpu().numpy(),
                                cds.cpu().numpy(), emds.cpu().numpy(), elapsed)
        else:
            # DEPTH batches in flight: the next batches are dispatched before
            # the oldest is read back; "Average time" is the amortized wall
            # time per cloud between read-backs
            pending: deque = deque()
            t_prev = time.time()
            done_loading = False
            while not done_loading or pending:
                while not done_loading and len(pending) < DEPTH:
                    item = get_item()
                    if item is None:
                        done_loading = True
                        break
                    chunk_start, chunk, pnp, gnp = item
                    pending.append((chunk_start, chunk, pnp, gnp,
                                    dispatch(complete, metrics, pnp[mine], gnp[mine],
                                             device)))
                if pending:
                    chunk_start, chunk, pnp, gnp, batch = pending.popleft()
                    cds, emds, completion = collect(batch)
                    now = time.time()
                    elapsed = (now - t_prev) / bsz
                    t_prev = now
                    process_results(chunk_start, chunk, pnp, gnp, completion, cds, emds,
                                    elapsed)
    finally:
        stop.set()
        if csv_file is not None:
            csv_file.close()

    say("Average time: %f" % (total_time / max(1, timed_models)))
    say("Average Chamfer distance: %f" % (total_cd / max(1, len(model_list))))
    say("Average Earth mover distance: %f" % (total_emd / max(1, len(model_list))))
    say("Chamfer distance per category")
    for synset_id in cd_per_cat:
        say(synset_id, "%f" % np.mean(cd_per_cat[synset_id]))
    say("Earth mover distance per category")
    for synset_id in emd_per_cat:
        say(synset_id, "%f" % np.mean(emd_per_cat[synset_id]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--list_path", default="../../dense_data/test.list")
    parser.add_argument("--data_dir", default="../../dense_data/test")
    parser.add_argument("--checkpoint", default="./bestrecord")
    parser.add_argument(
        "--model", choices=MODELS, default=None,
        help="the network: rfnet, or snowflakenet at its published PCN widths (2048 points "
        "in, 16384 out); default: the checkpoint's, RFNet where there is none",
    )
    parser.add_argument("--results_dir", default="results/recon")
    parser.add_argument("--num_gt_points", type=int, default=16384)
    parser.add_argument("--plot_freq", type=int, default=100)
    parser.add_argument("--save_pcd", action="store_true")
    parser.add_argument(
        "--batch_size", type=int, default=1,
        help="models per device batch (1 = reference behaviour)",
    )
    parser.add_argument(
        "--pipeline", action="store_true",
        help=f"keep {DEPTH} batches in flight on the card (the next dispatched while the "
        "oldest is read back); 'Average time' becomes the amortized wall time per cloud",
    )
    parser.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 feature MLPs (parameters and coordinates stay float32)",
    )
    parser.add_argument(
        "--profile_dir", default=None,
        help="write a torch.profiler Chrome trace of the run (host activity with the "
        "package's spans, and the card's kernels and copies) to <dir>/trace.json and its "
        "counters to <dir>/counters.json (under --mesh, <dir>/trace_rank<r>.json and "
        "<dir>/counters_rank<r>.json a rank)",
    )
    parser.add_argument(
        "--mesh", type=int, default=0,
        help="data-parallel serving over the N ranks torchrun starts (torchrun "
        "--nproc_per_node N ... --mesh N; a card a rank with NCCL, gloo on the CPU): each "
        "rank completes and scores batch_size/N clouds of each batch (batch_size must be "
        "a multiple of N); per-cloud metrics as one process's; rank 0 writes results.csv",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; under --mesh the card LOCAL_RANK) or cpu")
    args = parser.parse_args(argv)
    test(args)


if __name__ == "__main__":
    main()

"""Evaluation / serving CLI — the ``recon_test.py`` contract, on the card.

Port of ``rfnet_tpu/eval.py`` on one device:
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
  * ``--profile_dir`` writes a ``torch.profiler`` Chrome trace of the run.

Weights (``--checkpoint``) come from a ``torch.save``d ``state_dict``
(``.pt``) or from an ``.npz`` of flat flax params (``{"a/b/leaf": array}``,
with the training step under ``__step__``), such as the converged
``weights/rfnet_r4_105000.npz`` that ``tools/export_torch_weights.py``
writes; legacy shared step biases are upgraded on the way
(``compat.ckpt_compat``). The model's size is read off the weights. Runs on
``--device cuda`` unless asked for ``cpu``; a request for ``cuda`` without a
card is an error.

    python -m rfnet_tpu_torch.eval --list_path test.list --data_dir test \\
        --checkpoint weights/rfnet_r4_105000.npz --results_dir results/recon \\
        --batch_size 4 [--pipeline] [--bf16] [--profile_dir trace/]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import importlib.util
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from rfnet_tpu_torch.compat import ckpt_compat
from rfnet_tpu_torch.compat.convert import flax_to_state_dict
from rfnet_tpu_torch.data.dataset import resample_pcd
from rfnet_tpu_torch.data.pcd_io import read_pcd, save_pcd
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.ops.chamfer import chamfer_sample_means, nn_sample_mean_one

INPUT_POINTS = 3000
RANDOM_INIT_SEED = 1  # the JAX TrainConfig's default seed
DEPTH = 3  # batches in flight under --pipeline
# flags of the JAX package's CLI that the port does not have yet (ROADMAP.md §1)
_NOT_PORTED = ("--mesh",)


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


def load_state(checkpoint: str, dtype: torch.dtype | None = None) -> RFNet:
    """The model with weights from ``checkpoint``: a saved state_dict
    (``.pt``) or an ``.npz`` of flat flax params; its feature MLPs compute
    in ``dtype`` (None = float32).

    When the file is absent, warns and returns the full-size model's random
    init, drawn from a generator seeded ``RANDOM_INIT_SEED``."""
    if not os.path.isfile(checkpoint):
        print(f"WARNING: no checkpoint at {checkpoint}; evaluating random init")
        return RFNet(generator=torch.Generator().manual_seed(RANDOM_INIT_SEED), dtype=dtype)
    if checkpoint.endswith(".npz"):
        return _load_npz(checkpoint, dtype)
    state_dict = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model = _model_for(state_dict, dtype)
    model.load_state_dict(state_dict, strict=True)
    return model


def resolve_device(name: str | torch.device) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available (pass --device cpu)")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return device


def refuse_unported(parser: argparse.ArgumentParser, argv, flags) -> None:
    """Stop with the parser's error for each of ``flags`` given in ``argv``
    (``sys.argv[1:]`` when None): JAX CLI flags the port does not have yet."""
    given = {a.split("=")[0] for a in (sys.argv[1:] if argv is None else argv)}
    for flag in sorted(given.intersection(flags)):
        parser.error(f"{flag} is not ported to the PyTorch package yet "
                     "(ROADMAP.md, modules to port)")


@contextlib.contextmanager
def profile_trace(profile_dir: str | None, device: torch.device):
    """``torch.profiler`` around the block, as ``jax.profiler`` wraps the
    JAX CLIs' runs: host activity, and the card's kernels and copies where
    ``device`` is CUDA. The Chrome trace is written to
    ``<profile_dir>/trace.json`` however the block ends. Does nothing
    without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")


def make_complete_fn(model: RFNet):
    """(complete, metrics) pair on the model's device."""

    @torch.inference_mode()
    def complete(partial):
        return model(partial).out4

    @torch.inference_mode()
    def metrics(partial, output, gt):
        m1, m2 = chamfer_sample_means(output, gt)
        return (m1 + m2) / 2, nn_sample_mean_one(partial, output)

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
                partials.append(resample_pcd(partial, INPUT_POINTS).astype(np.float32))
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


def dispatch(complete, metrics, pnp: np.ndarray, gnp: np.ndarray, device: torch.device):
    """Queue one batch's forward, metrics and read-back on ``device``
    without waiting for any of them; :func:`collect` waits. Returns (host
    copies of cds, emds and the completion, an event that completes with
    them): on the card ``non_blocking`` copies into pinned buffers queued
    behind the work; on the CPU the tensors themselves and no event."""
    pb = _to_device(pnp, device)
    completion = complete(pb)
    out = (*metrics(pb, completion, _to_device(gnp, device)), completion)
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


def test(args):
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else None
    model = load_state(args.checkpoint, dtype).to(device).eval()
    print("trainable parameters:", count_params(model))
    complete, metrics = make_complete_fn(model)
    can_plot = importlib.util.find_spec("matplotlib") is not None
    if not can_plot:
        print("plots skipped: matplotlib not installed")

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

    load_q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()
    loader = threading.Thread(
        target=_load_chunks, args=(model_list, bsz, args, load_q, stop), daemon=True
    )
    loader.start()
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
            writer.writerow([model_id, cd, emd])
            synset_id, short_id = model_id.split("/")
            cd_per_cat.setdefault(synset_id, []).append(cd)
            emd_per_cat.setdefault(synset_id, []).append(emd)
            if i % args.plot_freq == 0 and can_plot:
                from rfnet_tpu_torch.visu import plot_pcd_three_views

                plot_dir = os.path.join(args.results_dir, "plots", synset_id)
                os.makedirs(plot_dir, exist_ok=True)
                plot_pcd_three_views(
                    os.path.join(plot_dir, f"{short_id}.png"),
                    [pnp[j], completion[j], gnp[j]],
                    ["input", "output", "ground truth"],
                    f"CD {cd:.4f}  EMD {emd:.4f}",
                    [5, 0.5, 0.5],
                )
            if args.save_pcd:
                pcd_dir = os.path.join(args.results_dir, "pcds", synset_id)
                os.makedirs(pcd_dir, exist_ok=True)
                save_pcd(os.path.join(pcd_dir, f"{short_id}.pcd"), completion[j])

    try:
        if not args.pipeline:
            # the reference's convention: each batch's forward timed to
            # synchronize(); only the disk reads overlap
            while (item := get_item()) is not None:
                chunk_start, chunk, pnp, gnp = item
                pb = torch.from_numpy(pnp).to(device)
                gb = torch.from_numpy(gnp).to(device)
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
                                    dispatch(complete, metrics, pnp, gnp, device)))
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
        csv_file.close()

    print("Average time: %f" % (total_time / max(1, timed_models)))
    print("Average Chamfer distance: %f" % (total_cd / max(1, len(model_list))))
    print("Average Earth mover distance: %f" % (total_emd / max(1, len(model_list))))
    print("Chamfer distance per category")
    for synset_id in cd_per_cat:
        print(synset_id, "%f" % np.mean(cd_per_cat[synset_id]))
    print("Earth mover distance per category")
    for synset_id in emd_per_cat:
        print(synset_id, "%f" % np.mean(emd_per_cat[synset_id]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--list_path", default="../../dense_data/test.list")
    parser.add_argument("--data_dir", default="../../dense_data/test")
    parser.add_argument("--checkpoint", default="./bestrecord/model.pt")
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
        help="write a torch.profiler Chrome trace of the run (host activity, and the "
        "card's kernels and copies) to <dir>/trace.json",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    refuse_unported(parser, argv, _NOT_PORTED)
    args = parser.parse_args(argv)
    with profile_trace(args.profile_dir, resolve_device(args.device)):
        test(args)


if __name__ == "__main__":
    main()

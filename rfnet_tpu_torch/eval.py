"""Evaluation / serving CLI — the ``recon_test.py`` contract, on the card.

Port of ``rfnet_tpu/eval.py`` (synchronous path, one device):
  * reads each ``<data_dir>/{partial,complete}/<id>.pcd`` of ``--list_path``,
    completes the partial cloud, and writes ``results.csv`` with header
    ``id,cd,emd`` where ``cd`` is the per-sample chamfer distance and the
    **``emd`` column is the fidelity** (one-sided partial→output mean
    distance), a reference quirk kept for comparability;
  * prints the parameter count first, then "Average time" (excluding the
    first 10 models as warmup) and the overall and per-category means;
  * optional three-view plots every ``--plot_freq`` models and .pcd dumps.

Weights come from a ``torch.save``d ``state_dict`` (``--checkpoint``; a
flax tree converts with ``rfnet_tpu_torch.compat.convert``). The model's
size is read off the state_dict. Runs on ``--device cuda`` unless asked
for ``cpu``; a request for ``cuda`` without a card is an error.

    python -m rfnet_tpu_torch.eval --list_path test.list --data_dir test \\
        --checkpoint model.pt --results_dir results/recon --batch_size 4
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import os
import queue
import threading
import time

import numpy as np
import torch

from rfnet_tpu_torch.data.dataset import resample_pcd
from rfnet_tpu_torch.data.pcd_io import read_pcd, save_pcd
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.ops.chamfer import chamfer_sample_means, nn_sample_mean_one

INPUT_POINTS = 3000
RANDOM_INIT_SEED = 1  # the JAX TrainConfig's default seed


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _model_for(state_dict: dict) -> RFNet:
    """An RFNet whose sizes match ``state_dict`` (seed count and up ratio
    read off the ``points_out`` layers)."""
    n_seed = (state_dict["init_cell.points_out.weight"].shape[0] - 12) // 3
    up_ratio = state_dict["decode_cell.points_out.weight"].shape[0] // 3
    return RFNet(n_seed=n_seed, up_ratio=up_ratio)


def load_state(checkpoint: str) -> RFNet:
    """The model with weights from ``checkpoint`` (a saved state_dict).

    When the file is absent, warns and returns the full-size model's random
    init, drawn from a generator seeded ``RANDOM_INIT_SEED``."""
    if not os.path.isfile(checkpoint):
        print(f"WARNING: no checkpoint at {checkpoint}; evaluating random init")
        return RFNet(generator=torch.Generator().manual_seed(RANDOM_INIT_SEED))
    state_dict = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model = _model_for(state_dict)
    model.load_state_dict(state_dict, strict=True)
    return model


def resolve_device(name: str | torch.device) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available (pass --device cpu)")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return device


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


def test(args):
    device = resolve_device(args.device)
    model = load_state(args.checkpoint).to(device).eval()
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
    try:
        writer = csv.writer(csv_file)
        writer.writerow(["id", "cd", "emd"])
        while (item := load_q.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            chunk_start, chunk, pnp, gnp = item
            pb = torch.from_numpy(pnp).to(device)
            gb = torch.from_numpy(gnp).to(device)
            start = time.time()
            completion = complete(pb)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            elapsed = (time.time() - start) / bsz
            cds, emds = metrics(pb, completion, gb)
            cds, emds = cds.cpu().numpy(), emds.cpu().numpy()
            completion = completion.cpu().numpy()
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
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    test(parser.parse_args(argv))


if __name__ == "__main__":
    main()

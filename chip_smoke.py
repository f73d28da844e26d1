#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rfnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the CUDA kernels from
   rfnet_tpu_torch/csrc (nvcc, one process per source);
2. holds each kernel (K1 FPS, K2 NN + coords, K3 early-exit NN) against its
   plain PyTorch version at the serving path's shapes (batch 4) and times
   kernel, plain version and a one-call PyTorch yardstick with CUDA events;
3. serves 16 synthetic clouds in the PCN layout through
   ``rfnet_tpu_torch.eval.main`` on the card with a random-init full-width
   RFNet, checks the CSV, and checks that every kernel was launched by that
   run; then serves the first 4 clouds again on the CPU with the plain
   versions and holds the card's CSV to it;
4. times the full-width forward at batch 32;
5. prints the per-kernel JSON line, then ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no result.
It needs the rest of the repository: alone, or without a card, it fails.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "chip_smoke_work")  # listed in .gitignore, removed at exit
B = 4  # serving batch
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(dev):
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.ops import chamfer, fps

    pairs = list(synthetic_pairs(B, seed=7))
    partial = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)  # (4, 3000, 3)
    gt = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)  # (4, 16384, 3)
    gen = torch.Generator(device=dev).manual_seed(7)
    # a completion-like cloud: the gt jittered by 0.005
    out = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    rows = {}

    # K1: 32 seeds of the 3000-point input, as the model's forward samples
    n, npoint = partial.shape[1], 32
    k_idx = fps.farthest_point_sample(npoint, partial)
    p_idx = fps._fps_plain(partial, npoint)
    torch.cuda.synchronize()
    check(torch.equal(k_idx, p_idx), "K1 FPS indices differ from the plain version")
    ms = cuda_ms(lambda: fps.farthest_point_sample(npoint, partial), 50)
    plain_ms = cuda_ms(lambda: fps._fps_plain(partial, npoint), 5)
    b_ms, b_by = bound(8.0 * B * n * npoint, 4.0 * B * (3 * n + npoint))
    print(f"K1 fps ({B},{n},3)->{npoint}: indices identical; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    rows["fps"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)

    # K2: the three merge scans, 64 / 1024 / 16384 queries into the input
    for nq in (64, 1024, 16384):
        q = out[:, :nq].contiguous()
        kd, ki, kc = chamfer.nn_coords(q, partial)
        pd, pi = chamfer._one_sided(q, partial)
        pc = chamfer._gather_rows(partial, pi)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        same = ki == pi
        # both run one op chain, so 0 is expected; 1e-6 absolute leaves room
        # only for a rounding difference, at distances of order 1e-4..1e-1
        check(err <= 1e-6, f"K2 nq={nq}: distances differ by {err}")
        check(bool(torch.equal(kc[same], pc[same])), f"K2 nq={nq}: coordinates differ off ties")
        # where the indices differ the two picks must be equally near
        tie_gap = ((kc - q).square().sum(-1) - (pc - q).square().sum(-1))[~same]
        check(tie_gap.numel() == 0 or float(tie_gap.abs().max()) <= 1e-6,
              f"K2 nq={nq}: a differing pick is not a tie")
        agree = float(same.float().mean())
        check(agree >= 0.999, f"K2 nq={nq}: indices agree on only {agree:.6f}")
        ms = cuda_ms(lambda: chamfer.nn_coords(q, partial), 20)
        plain_ms = cuda_ms(lambda: chamfer._one_sided(q, partial), 3)
        lib_ms = cuda_ms(lambda: torch.cdist(q, partial).min(-1), 10)
        m = partial.shape[1]
        b_ms, b_by = bound(9.0 * B * nq * m, 4.0 * B * (3 * nq + 3 * m + 5 * nq))
        print(f"K2 nn_coords ({B},{nq},3)x({B},{m},3): max|dd| {err:.3g}, index agreement "
              f"{agree:.6f}, coords equal where indices agree; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, cdist.min {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if nq == 16384:
            rows["nn_coords"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # K3: the eval metrics' three sorted scans
    gts, _ = chamfer.sort_by_z_with_order(gt)
    outs, _ = chamfer.sort_by_z_with_order(out)
    parts, _ = chamfer.sort_by_z_with_order(partial)
    for name, qs, ts in (("out->gt", outs, gts), ("gt->out", gts, outs), ("partial->out", parts, outs)):
        kd, ki = chamfer.nn_dyn(qs, ts)
        pd, pi = chamfer._nn_sorted_plain(qs, ts)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        agree = float((ki == pi).float().mean())
        check(err <= 1e-6, f"K3 {name}: distances differ from the full plain scan by {err}")
        check(agree >= 0.999, f"K3 {name}: indices agree on only {agree:.6f}")
        nq, m = qs.shape[1], ts.shape[1]
        # pairs any exact z-slab walk must visit: targets with (qz-tz)^2 <= best
        tz = ts[..., 2].contiguous()
        r = torch.sqrt(kd)
        lo = torch.searchsorted(tz, (qs[..., 2] - r).contiguous(), right=False)
        hi = torch.searchsorted(tz, (qs[..., 2] + r).contiguous(), right=True)
        pairs = float((hi - lo).sum())
        ms = cuda_ms(lambda: chamfer.nn_dyn(qs, ts), 20)
        plain_ms = cuda_ms(lambda: chamfer._nn_sorted_plain(qs, ts), 3)
        lib_ms = cuda_ms(lambda: torch.cdist(qs, ts).min(-1), 5)
        b_ms, b_by = bound(9.0 * pairs, 4.0 * B * (3 * nq + 3 * m + 2 * nq))
        print(f"K3 nn_dyn {name} ({B},{nq},3)x({B},{m},3): max|dd| vs full plain scan {err:.3g}, "
              f"index agreement {agree:.6f}; slab pairs {pairs:.0f} "
              f"({pairs / (B * nq * m):.4%} of dense); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, cdist.min {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if name == "out->gt":
            rows["nn_dyn"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return rows


def write_evalset(root: str, num: int) -> list[str]:
    """``num`` synthetic clouds laid out like the PCN test set (8 synsets)."""
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.data.pcd_io import save_pcd

    synsets = ("02691156", "02933112", "02958343", "03001627",
               "03636649", "04256520", "04379243", "04530566")
    ids = []
    for i, (mid, part, gt) in enumerate(synthetic_pairs(num, seed=1234)):
        mid = f"{synsets[i % len(synsets)]}/{mid.split('/')[-1]}"
        for kind, cloud in (("partial", part), ("complete", gt)):
            path = os.path.join(root, "data", kind, mid + ".pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_pcd(path, cloud)
        ids.append(mid)
    return ids


def run_eval(argv: list[str]) -> str:
    from rfnet_tpu_torch import eval as eval_mod

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_mod.main(argv)
    text = buf.getvalue()
    print(text, end="")
    return text


def read_rows(results_dir: str) -> list[list[str]]:
    with open(os.path.join(results_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["id", "cd", "emd"], f"CSV header {rows[0]}")
    return rows[1:]


def serve(dev):
    """Phase 3: the serving path end to end; returns the launch counts."""
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.models import RFNet

    ids = write_evalset(WORK, 16)
    with open(os.path.join(WORK, "test.list"), "w") as f:
        f.write("\n".join(ids))
    with open(os.path.join(WORK, "ref.list"), "w") as f:
        f.write("\n".join(ids[:4]))
    ckpt = os.path.join(WORK, "model.pt")
    torch.save(RFNet(generator=torch.Generator().manual_seed(0)).state_dict(), ckpt)
    common = ["--data_dir", os.path.join(WORK, "data"), "--checkpoint", ckpt,
              "--num_gt_points", "16384", "--plot_freq", "8", "--batch_size", str(B)]

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    text = run_eval(["--list_path", os.path.join(WORK, "test.list"),
                     "--results_dir", os.path.join(WORK, "gpu"), "--device", "cuda", *common])
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    n_batches = 16 // B
    print(f"launches in the serving run: {counts} (expected fps {n_batches}, "
          f"nn_coords {3 * n_batches}, nn_dyn {3 * n_batches})")
    check(counts == {"fps": n_batches, "nn_coords": 3 * n_batches, "nn_dyn": 3 * n_batches},
          f"launch counts {counts}")
    avg = re.search(r"Average time: ([0-9.eE+-]+)", text)
    check(avg is not None, "no 'Average time' line")
    print(f"serving: Average time {float(avg.group(1)):.6f} s/cloud (batch {B}, models 12-15), "
          f"max_memory_allocated {peak} bytes")

    gpu_rows = read_rows(os.path.join(WORK, "gpu"))
    check([r[0] for r in gpu_rows] == ids, "CSV ids differ from the list")
    vals = [float(v) for r in gpu_rows for v in r[1:]]
    check(all(math.isfinite(v) and v > 0 for v in vals), "non-finite or non-positive metric")

    # the same weights and clouds on the CPU, through the plain versions;
    # CPU and card sum the MLP matmuls in other orders (float32 throughout)
    # and a near-tie merge can pick another neighbour, so the per-cloud
    # metrics agree to 1e-3 relative, not bit for bit
    run_eval(["--list_path", os.path.join(WORK, "ref.list"),
              "--results_dir", os.path.join(WORK, "cpu"), "--device", "cpu", *common])
    for g, c in zip(gpu_rows[:4], read_rows(os.path.join(WORK, "cpu"))):
        for gv, cv in zip(g[1:], c[1:]):
            rel = abs(float(gv) - float(cv)) / abs(float(cv))
            check(rel <= 1e-3, f"{g[0]}: card {gv} vs cpu {cv} (rel {rel:.3g})")
    print("serving: 16 finite CSV rows; first 4 match the CPU reference within 1e-3 relative")
    return counts


def forward_throughput(dev):
    """Phase 4: full-width forward at batch 32, timed to synchronize()."""
    import numpy as np
    import torch

    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.models import RFNet

    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    parts = np.stack([p for _, p, _ in synthetic_pairs(32, seed=3)])
    x = torch.from_numpy(parts).to(dev)
    with torch.inference_mode():
        for _ in range(2):
            out = model(x).out4
        torch.cuda.synchronize(dev)
        iters = 5
        t0 = time.time()
        for _ in range(iters):
            out = model(x).out4
        torch.cuda.synchronize(dev)
        dt = (time.time() - t0) / iters
    check(bool(torch.isfinite(out).all()) and out.shape == (32, 16384, 3), "b32 forward output")
    print(f"forward b32: {dt * 1e3:.3f} ms/batch, {32 / dt:.1f} clouds/s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from rfnet_tpu_torch import kernels  # absent when run outside the repository

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.time()
    kernels.build()
    print(f"kernel build: {time.time() - t0:.1f} s")
    with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        rows = check_kernels(dev)
        counts = serve(dev)
        forward_throughput(dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    src = {"fps": ("rfnet_tpu_torch/csrc/fps.cu", "rfnet_tpu/ops/pallas/fps.py:73"),
           "nn_coords": ("rfnet_tpu_torch/csrc/nn_coords.cu", "rfnet_tpu/ops/pallas/chamfer.py:153"),
           "nn_dyn": ("rfnet_tpu_torch/csrc/nn_dyn.cu", "rfnet_tpu/ops/pallas/chamfer_dyn.py:170")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": counts[name], "pass": True, **rows[name]}
        for name in ("fps", "nn_coords", "nn_dyn")
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

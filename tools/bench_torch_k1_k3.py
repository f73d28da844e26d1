#!/usr/bin/env python3
"""K1 (farthest point sampling) and K3 (early-exit NN scan) alone, on one card.

    python3 tools/bench_torch_k1_k3.py [--sweep]

Builds the kernels and prints ptxas' registers and spills for K1 and K3.
Then it runs ``chip_smoke.py``'s own checks of the two kernels, each result
held to its plain version before it is timed, at every shape of their rows
in PERF.md: K1 at the serving (4,3000)->32, the train step's (32,3000)->32,
(32,16384)->64 and ->1024, and at (1,70000)->64; K3 at the metrics' three
scans of completion-like clouds (the ground truth jittered by 0.005) at
batch 4, the losses' pair and re_chamfer scans at batch 32, and the same
scans on a random-init full-width RFNet's outputs. With ``--sweep`` it also
times K1 at every cluster size the cloud fits in registers with, each
checked against the plain result first. Each K1 and K3 line gives the kernel's device time alone
(``torch.profiler``) too, which the wrapper's host time hides at the
shortest calls.

It runs from an older checkout of the repository too, with this file copied
into its ``tools/``: it skips what that tree lacks (the 70 000-point cloud
where its K1 refuses it, the sweep), so one chip call can time parent and
change in turns.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rfnet_tpu_torch import kernels  # noqa: E402
from rfnet_tpu_torch.data.dataset import synthetic_pairs  # noqa: E402
from rfnet_tpu_torch.models import RFNet  # noqa: E402
from rfnet_tpu_torch.ops import chamfer, fps  # noqa: E402


def z_sorted(x):
    return chamfer.sort_by_z_with_order(x.contiguous())[0]


def k3_cases(dev) -> list:
    """(name, sorted queries, sorted targets, time cdist) at every K3 row."""
    pairs = list(synthetic_pairs(4, seed=7))
    partial4 = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)
    gt4 = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    out4 = gt4 + 0.005 * torch.randn(gt4.shape, generator=gen, device=dev)
    partial, gt = (x.to(dev) for x in chip_smoke.train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    out_a = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    out_b = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.inference_mode():
        res = model(partial)
    rnd_a, rnd_b = res.out3.clone(), res.out4.clone()
    g2, like2, rnd2 = (z_sorted(torch.cat(p, 0)) for p in
                       ((gt, gt), (out_a, out_b), (rnd_a, rnd_b)))
    gs, os_, ps = z_sorted(gt4), z_sorted(out4), z_sorted(partial4)
    slices = lambda x: z_sorted(x.reshape(256, 2048, 3))  # noqa: E731
    g4, r4 = z_sorted(gt[:4]), z_sorted(rnd_b[:4])
    return [
        ("out->gt", os_, gs, True), ("gt->out", gs, os_, True), ("partial->out", ps, os_, True),
        ("pair gt->out", g2, like2, False), ("pair out->gt", like2, g2, False),
        ("re_chamfer pred->gt", slices(out_a), slices(gt), True),
        ("re_chamfer gt->pred", slices(gt), slices(out_a), True),
        ("random-init out->gt", r4, g4, True), ("random-init gt->out", g4, r4, True),
        ("random-init pair gt->out", g2, rnd2, False),
        ("random-init pair out->gt", rnd2, g2, False),
        ("random-init re_chamfer pred->gt", slices(rnd_a), slices(gt), True),
    ]


def k1_cases(dev) -> list:
    pairs = list(synthetic_pairs(4, seed=7))
    partial4 = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)
    partial, gt = (x.to(dev) for x in chip_smoke.train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    big = torch.rand((1, 70000, 3), generator=gen, device=dev)
    cases = [(partial4, 32, 50), (partial, 32, 50), (gt, 64, 20), (gt, 1024, 20)]
    if hasattr(fps, "_fps_plan"):  # an older K1 refuses more than 58 044 points
        cases.append((big, 64, 10))
    return cases


def sweep(k1) -> None:
    """K1 at every cluster size its cloud fits in registers with."""
    for x, npoint, iters in k1:
        b, n = x.shape[0], x.shape[1]
        want = fps._fps_plain(x, npoint)
        for cluster in (1, 2, 4, 8):
            fits = [p for p in fps._FPS_PER_THREAD if cluster * fps._FPS_THREADS * p >= n]
            if not fits:
                continue
            plan = (cluster, fits[0])
            got = fps._fps_launch(x, npoint, *plan)
            chip_smoke.check(torch.equal(got, want), f"K1 {plan} differs from the plain loop")
            ms = chip_smoke.cuda_ms(lambda: fps._fps_launch(x, npoint, *plan), iters)
            print(f"sweep K1 ({b},{n},3)->{npoint} plan {plan}: indices identical, {ms:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"tree: {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}")
    kernels.build()
    with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
        entry = None
        for line in f:
            if "Compiling entry" in line:
                # the kernel's name and template arguments out of its mangled name
                entry = re.search(r"(fps_kernel|nn_dyn_kernel|cluster_\w+_kernel)(ILi(\d+)E)?",
                                  line)
            elif entry and ("registers" in line or "spill" in line):
                targs = f"<{entry.group(3)}>" if entry.group(3) else ""
                print(f"  ptxas {entry.group(1)}{targs}: {line.split(':', 1)[-1].strip()}")
    # each kernel's device time too (torch.profiler), which the wrappers' host
    # time hides at the shortest calls, where an older chip_smoke.py lacks it
    k1 = k1_cases(dev)
    for x, npoint, iters in k1:
        if "device_ms" not in chip_smoke.check_k1(x, npoint, iters):
            on_card = chip_smoke.device_ms(lambda: fps.farthest_point_sample(npoint, x), 10,
                                           "fps_kernel")
            print(f"  K1 ({x.shape[0]},{x.shape[1]},3)->{npoint} on the card alone: "
                  f"{chip_smoke.fmt_ms(on_card)} ms")
    k3 = k3_cases(dev)
    for name, qs, ts, library in k3:
        if "device_ms" not in chip_smoke.check_k3(name, qs, ts, library):
            on_card = chip_smoke.device_ms(lambda: chamfer.nn_dyn(qs, ts), 10, "nn_dyn_kernel")
            print(f"  K3 {name} on the card alone: {chip_smoke.fmt_ms(on_card)} ms")
    if args.sweep and hasattr(fps, "_fps_launch"):
        sweep(k1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

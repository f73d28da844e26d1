#!/usr/bin/env python3
"""K2 (NN + coordinates) and K4 (dense NN) alone, on one card.

    python3 tools/bench_torch_k2_k4.py [--sweep]

Builds the kernels and prints ptxas' registers and spills for the scan. Then
it runs K2 at the six shapes of its PERF.md rows, the merge layer's three
scans (64, 1024 and 16384 queries of a completion-like cloud, the ground
truth jittered by 0.005, into the 3000-point input) at the serving batch 4
and the train batch 32, and K4 at zero_groupnear's two scans of the train
step ((32,1024)->(32,64) and (32,16384)->(32,1024) between the ground
truth's FPS pyramids). Each is held to its plain version before it is timed
(``chip_smoke.check_scan``: distances bit for bit), beside ``cdist.min``;
each line gives the launch plan, the wrapper's time, the kernel's device time
alone (``torch.profiler``, and 20 calls captured in a CUDA graph, which
no host time separates) and the SASS issue slots a pair; at the two
train-batch shapes of 16384 queries also the SM clock and power draw while
the kernel runs back to back, and the issue floor at that clock. With
``--sweep`` it also times every plan (R queries a thread, W warps and C CTAs
splitting the targets, G as the plan would choose it, and every smaller G)
at each shape, each checked against the plain distances first, by device
time: 20 launches captured in a CUDA graph, replayed and timed with CUDA
events.

It runs from an older checkout of the repository too, with this file copied
into its ``tools/``: there it checks and times each shape with the tree's own
wrappers and skips the plan, the SASS and the sweep, so one chip call can
time parent and change in turns.
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
from rfnet_tpu_torch.ops import chamfer, fps  # noqa: E402


def cases(dev) -> list:
    """(kernel name, queries, targets) at every K2 and K4 row of PERF.md."""
    pairs = list(synthetic_pairs(4, seed=7))
    partial4 = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)
    gt4 = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    out4 = gt4 + 0.005 * torch.randn(gt4.shape, generator=gen, device=dev)
    partial, gt = (x.to(dev) for x in chip_smoke.train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    out = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    gt1 = fps.gather_point(gt, fps.farthest_point_sample(64, gt))
    gt2 = fps.gather_point(gt, fps.farthest_point_sample(1024, gt))
    rows = [("nn_coords", out4[:, :nq].contiguous(), partial4) for nq in (16384, 1024, 64)]
    rows += [("nn_coords", out[:, :nq].contiguous(), partial) for nq in (16384, 1024, 64)]
    return rows + [("nn_dense", gt, gt2), ("nn_dense", gt2, gt1)]


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms a call of ``fn``: ``launches`` calls captured in one CUDA
    graph and replayed, timed with CUDA events, so no host work stands
    between the kernels (each gap is the graph's own, about a microsecond)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return chip_smoke.cuda_ms(graph.replay, replays) / launches


def clock_under_load(name: str, q, t) -> None:
    """The SM clock and power draw nvidia-smi reads while the wrapper runs
    back to back on the card for about a second, and the issue floor of
    ``chip_smoke.check_scan`` taken at that clock instead of the highest."""
    import time

    fn = chamfer.nn_coords if name == "nn_coords" else chamfer.nn_dense
    calls = max(1, int(1.0 / (graph_ms(lambda: fn(q, t)) * 1e-3)))
    for _ in range(calls):
        fn(q, t)
    time.sleep(0.3)
    clock, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split(",")
    torch.cuda.synchronize()
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    line = (f"  {name} ({b},{n})->{m} run back to back: SM clock {float(clock):.0f} MHz, "
            f"power draw {float(power):.2f} W")
    if hasattr(chip_smoke, "sass_slots_a_pair"):
        slots = chip_smoke.sass_slots_a_pair(name == "nn_coords",
                                             chamfer._nn_scan_plan(b, n, m, fps._sm_count(q.device))[0])
        floor = slots * b * n * m / (fps._sm_count(q.device) * 128 * float(clock) * 1e6) * 1e3
        line += f"; issue floor at that clock {floor:.4f} ms"
    print(line)


def check_and_time(name: str, q, t) -> None:
    """The tree's own check where it has ``chip_smoke.check_scan``; else
    (an older tree) distances bit-equal to the plain scan, the wrapper's
    time, the profiler's device time and ``cdist.min``. Then, in either
    tree, the device time of the wrapper's call in a CUDA graph."""
    fn = chamfer.nn_coords if name == "nn_coords" else chamfer.nn_dense
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    if hasattr(chip_smoke, "check_scan"):
        chip_smoke.check_scan(name, q, t)
    else:
        kd, pd = fn(q, t)[0], chamfer._one_sided(q, t)[0]
        chip_smoke.check(torch.equal(kd, pd), f"{name}: distances differ from the plain scan")
        ms = chip_smoke.cuda_ms(lambda: fn(q, t), 20)
        dev_ms = chip_smoke.device_ms(lambda: fn(q, t), 10,
                                      f"nn_scan_kernel<{str(name == 'nn_coords').lower()}")
        lib_ms = chip_smoke.cuda_ms(lambda: torch.cdist(q, t).min(-1), 10)
        print(f"{name} ({b},{n},3)x({b},{m},3): distances bit-equal; kernel {ms:.4f} ms "
              f"({chip_smoke.fmt_ms(dev_ms)} on the card alone), cdist.min {lib_ms:.4f} ms")
    print(f"  {name} ({b},{n})->{m}: {graph_ms(lambda: fn(q, t)):.4f} ms on the card in a "
          f"CUDA graph")


def sweep(name: str, q, t) -> None:
    """Every plan at one shape, each checked against the plain distances,
    by device time (:func:`graph_ms`); the wrapper's own plan marked."""
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    sms = fps._sm_count(q.device)
    mine = chamfer._nn_scan_plan(b, n, m, sms)
    pd = chamfer._one_sided(q, t)[0]
    plans = []
    for r in (4, 8):
        for w in (1, 2, 4, 8):
            for c in (1, 2, 4, 8):
                top = chamfer._nn_scan_fill(b, n, m, r, w, c, 0)  # the largest G
                for g in (8, 4, 2, 1):
                    if g <= top[1]:
                        plans.append((r, g, w, c, top[4]))
    times = []
    for plan in plans:
        got = chamfer._nn_scan_launch(name, q, t, plan)[0]
        chip_smoke.check(torch.equal(got, pd), f"sweep {name} plan {plan}: distances differ")
        times.append(graph_ms(lambda plan=plan: chamfer._nn_scan_launch(name, q, t, plan)))
    for ms, plan in sorted(zip(times, plans)):
        mark = " <- the wrapper's plan" if plan == mine else ""
        print(f"sweep {name} ({b},{n})->{m} plan (R, G, W, C, tiles) {plan}: distances "
              f"bit-equal, {ms:.4f} ms on the card{mark}")


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
                entry = re.search(r"nn_scan_kernelILb([01])E(Li(\d+)E)?", line)
            elif entry and ("registers" in line or "spill" in line):
                targs = f"<{'true' if entry.group(1) == '1' else 'false'}" + (
                    f", {entry.group(3)}>" if entry.group(3) else ">")
                print(f"  ptxas nn_scan_kernel{targs}: {line.split(':', 1)[-1].strip()}")
    rows = cases(dev)
    for name, q, t in rows:
        check_and_time(name, q, t)
        if q.shape[1] == 16384 and q.shape[0] == 32:
            clock_under_load(name, q, t)
    if args.sweep and hasattr(chamfer, "_nn_scan_plan"):
        for name, q, t in rows:
            sweep(name, q, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())

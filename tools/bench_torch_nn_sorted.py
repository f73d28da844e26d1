#!/usr/bin/env python3
"""K7 (box-pruned NN, z-sorted) and K8 (best-first box-tile NN, Morton-sorted)
alone, on one card.

    python3 tools/bench_torch_nn_sorted.py [--sweep]

Builds the kernels, then runs K8 and K7 at every shape of their PERF.md
rows: the losses' pair (64, 16384)² and ``re_chamfer`` (256, 2048)², the
metrics' (4, 16384)², and K7 at the op API's (4, 16384)×(4, 3000), on
completion-like clouds (the ground truth jittered by 0.005) and on a
random-init full-width RFNet's outputs, which lie far from the ground truth.
Each kernel is first held to the plain scan, distances and indices bit for
bit. Each line gives the wrapper's time (CUDA events), the card's time alone
(20 calls captured in a CUDA graph, which no host time separates), K3
(``nn_dyn``) on the same clouds z-sorted in a CUDA graph, and, where the
tree has them, the launch plan (warps a block, targets a tile) and the SASS
issue slots a pair of the kernel's chunk loop. With ``--sweep`` it also
times every plan at each shape on the card, each checked against the plain
scan first.

It runs from an older checkout of the repository too, with this file copied
into its ``tools/``: there it checks and times each shape through the tree's
own wrappers and skips the plan, the SASS and the sweep, so one chip call can
time parent and change in turns.

Imports no JAX. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from bench_torch_k2_k4 import graph_ms  # noqa: E402
from rfnet_tpu_torch import kernels  # noqa: E402
from rfnet_tpu_torch.ops import chamfer, chamfer_pruned, chamfer_tile  # noqa: E402

KERNELS = {"nn_tile": ("K8", chamfer_tile.sort_by_morton_with_order, chamfer_tile.nn_tile),
           "nn_pruned": ("K7", chamfer.sort_by_z_with_order, chamfer_pruned.nn_pruned)}


def cases(dev) -> list:
    """(kernel, name, queries, targets) at every K7 and K8 row of PERF.md,
    on the clouds chip_smoke.py's phase 2c builds."""
    from rfnet_tpu_torch.models import RFNet

    partial, gt = (x.to(dev) for x in chip_smoke.train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    out_a = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    out_b = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.inference_mode():
        res = model(partial)
    rnd_a, rnd_b = res.out3.clone(), res.out4.clone()
    gt2 = torch.cat([gt, gt])
    pair_like, pair_rnd = torch.cat([out_a, out_b]), torch.cat([rnd_a, rnd_b])
    k8 = [("completion-like pair gt->out", gt2, pair_like),
          ("random-init pair gt->out", gt2, pair_rnd),
          ("random-init pair out->gt", pair_rnd, gt2),
          ("completion-like re_chamfer pred->gt", out_a.reshape(256, 2048, 3),
           gt.reshape(256, 2048, 3)),
          ("random-init re_chamfer pred->gt", rnd_a.reshape(256, 2048, 3),
           gt.reshape(256, 2048, 3)),
          ("random-init out->gt", rnd_b[:4], gt[:4]),
          ("completion-like out->gt", out_a[:4], gt[:4])]
    k7 = [("op API gt->partial", gt[:4], partial[:4]),
          ("completion-like pair gt->out", gt2, pair_like),
          ("random-init pair gt->out", gt2, pair_rnd)]
    return ([("nn_tile", n, q.contiguous(), t.contiguous()) for n, q, t in k8]
            + [("nn_pruned", n, q.contiguous(), t.contiguous()) for n, q, t in k7])


def check_and_time(kernel: str, name: str, q, t, sweep: bool) -> None:
    label, sort_fn, fn = KERNELS[kernel]
    qs, ts = sort_fn(q)[0], sort_fn(t)[0]
    qz, tz = chamfer.sort_by_z_with_order(q)[0], chamfer.sort_by_z_with_order(t)[0]
    kd, ki = fn(qs, ts)
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    chip_smoke.check(torch.equal(kd, pd) and torch.equal(ki, pi),
                     f"{label} {name}: differs from the plain scan")
    b, n, m = qs.shape[0], qs.shape[1], ts.shape[1]
    ms = chip_smoke.cuda_ms(lambda: fn(qs, ts), 20)
    card = graph_ms(lambda: fn(qs, ts))
    k3 = graph_ms(lambda: chamfer.nn_dyn(qz, tz))
    line = (f"{label} {kernel} {name} ({b},{n})x({b},{m}): distances and indices bit-equal; "
            f"wrapper {ms:.4f} ms, card {card:.4f} ms (CUDA graph), K3 on the same clouds "
            f"{k3:.4f} ms (CUDA graph)")
    plan_of = getattr(chamfer, "_nn_tiles_fit", None)
    if plan_of is not None:
        plan = {"nn_tile": chamfer_tile, "nn_pruned": chamfer_pruned}[kernel]._PLAN
        slots = chip_smoke.sass_tiles_slots_a_pair(kernel == "nn_tile")
        line += (f"; plan (warps, tile) {plan_of(kernel, n, m, plan)}, SASS "
                 f"{chip_smoke.fmt_ms(slots)} issue slots a pair")
    print(line, flush=True)
    if sweep and plan_of is not None:
        times = []
        for warps in (1, 2, 4, 8):
            for tile_m in (64, 128, 256, 512):
                plan = (warps, tile_m)
                d, i, visited = chamfer._nn_tiled(kernel, qs, ts, plan)
                chip_smoke.check(torch.equal(d, pd) and torch.equal(i, pi),
                                 f"sweep {label} {name} plan {plan}: differs")
                staged = float(visited.float().mean()) / -(-m // tile_m)
                times.append((graph_ms(lambda p=plan: chamfer._nn_tiled(kernel, qs, ts, p)),
                              plan, staged))
        for ms_p, plan, staged in sorted(times):
            print(f"  sweep {label} {name} plan {plan}: bit-equal, tiles staged {staged:.4%}, "
                  f"{ms_p:.4f} ms on the card", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_nn_sorted: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"tree: {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}")
    kernels.build()
    for kernel, name, q, t in cases(dev):
        check_and_time(kernel, name, q, t, args.sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())

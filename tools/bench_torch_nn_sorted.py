#!/usr/bin/env python3
"""Tile sizes of the port's two tile-pruned NN scans on one CUDA card.

    python3 tools/bench_torch_nn_sorted.py [--batch 4]

Times K7 (``nn_pruned``, z-sorted clouds) and K8 (``nn_tile``, Morton-sorted
clouds) over a grid of (queries a block) × (targets a tile), beside K3
(``nn_dyn``) on the same clouds, for two kinds of input at the metrics'
shape (batch, 16384, 3)²: completion-like (the ground truth jittered by
0.005) and a random-init full-width RFNet's output, which lies far from the
ground truth. Each configuration is first held to the plain scan bit for bit.
Prints one line a configuration: the share of target tiles the blocks loaded
and the time with CUDA events (the tile boxes included).

Imports no JAX. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TILE_N = (64, 128, 256)
TILE_M = (64, 128, 256, 512, 1024)


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--batch", type=int, default=4)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_nn_sorted: no CUDA device available", file=sys.stderr)
        return 1
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.models import RFNet
    from rfnet_tpu_torch.ops import chamfer, chamfer_tile

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    pairs = list(synthetic_pairs(args.batch, seed=11))
    partial = torch.from_numpy(np.stack([q for _, q, _ in pairs])).to(dev)
    gt = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    like = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.inference_mode():
        rnd = model(partial).out4.clone()

    sorts = {"nn_pruned": chamfer.sort_by_z_with_order,
             "nn_tile": chamfer_tile.sort_by_morton_with_order}
    for kind, out in (("completion-like", like), ("random-init", rnd)):
        for direction, q, t in (("out->gt", out, gt), ("gt->out", gt, out)):
            qz, tz = (chamfer.sort_by_z_with_order(x)[0] for x in (q, t))
            k3_ms = cuda_ms(lambda: chamfer.nn_dyn(qz, tz))
            print(f"{kind} {direction} {tuple(q.shape)}: K3 nn_dyn {k3_ms:.4f} ms")
            for kernel, sort_fn in sorts.items():
                qs, ts = sort_fn(q)[0], sort_fn(t)[0]
                pd, pi = chamfer._nn_sorted_plain(qs, ts)
                for tile_n in TILE_N:
                    for tile_m in TILE_M:
                        d, i, visited = chamfer._nn_tiled(kernel, qs, ts, tile_n, tile_m)
                        if not (torch.equal(d, pd) and torch.equal(i, pi)):
                            raise SystemExit(f"{kernel} {tile_n}x{tile_m}: differs from the "
                                             "plain scan")
                        loaded = float(visited.float().mean()) / -(-t.shape[1] // tile_m)
                        ms = cuda_ms(lambda: chamfer._nn_tiled(kernel, qs, ts, tile_n, tile_m))
                        print(f"  {kernel} {tile_n:4d} x {tile_m:5d}: tiles loaded "
                              f"{loaded:8.4%}, {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

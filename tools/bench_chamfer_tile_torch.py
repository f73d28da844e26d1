"""The presorted K3 pair against the K8 pair on one CUDA card (the
counterpart of ``tools/bench_chamfer_tile.py``).

    python3 tools/bench_chamfer_tile_torch.py [--iters 10]
    python3 tools/bench_chamfer_tile_torch.py --device cpu --tiny   # plain versions

Times the one-sided NN pair q -> gt + gt -> q, both clouds presorted in
each kernel's own order (z for K3, ``ops.chamfer.nn_dyn``; Morton for K8,
``ops.chamfer_tile.nn_tile`` at its one plan), at batch 32 and 16 384 points,
on the JAX tool's three regimes: the seeded random-init model's out3 for a
synthetic batch (``data.online.synthetic_batch(7, 0, ...)``) against its
ground truth, ``RandomState(0)`` uniform clouds, and a compact blob (0.05
·N(0, 1)) inside the spread ground truth. The sorts are left out, as
there: both pay one sort a cloud. Each pair's sum of distances must agree
between the kernels to 1e-5 relative (both exact; another summation order).
Times are ``_common_torch.timeit``'s; the last line is one JSON object.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch.data.online import synthetic_batch  # noqa: E402
from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from rfnet_tpu_torch.ops.chamfer_tile import _PLAN, nn_tile  # noqa: E402
from rfnet_tpu_torch.ops.chamfer_tile import sort_by_morton_with_order  # noqa: E402
from rfnet_tpu_torch.train import TrainConfig  # noqa: E402
from tools._common_torch import TINY, device_info, emit, require, resolve_device  # noqa: E402
from tools._common_torch import timeit, tool_model  # noqa: E402

B = 32
TINY_B = 4
SUM_RTOL = 1e-5
PAIRS = (("out3<->gt", "out3"), ("rand<->gt", "rand"), ("blob<->gt", "blob"))


def pair(scan, a, c) -> torch.Tensor:
    """Sum of the distances of a -> c and c -> a under ``scan``."""
    return scan(a, c)[0].sum() + scan(c, a)[0].sum()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a case")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = TrainConfig(**TINY) if args.tiny else TrainConfig()
    b = TINY_B if args.tiny else B
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; batch {b}; K3 slab "
          f"{chamfer._NN_DYN_SLAB}, K8 plan (warps, tile) "
          f"{chamfer._nn_tiles_fit('nn_tile', config.ptnum, config.ptnum, _PLAN)}",
          flush=True)
    partial, gt = synthetic_batch(7, 0, b, config.innum, config.ptnum, dev)
    with torch.no_grad():
        o3 = tool_model(config, dev)(partial).out3
    rng = np.random.RandomState(0)
    rnd = torch.from_numpy(rng.rand(b, config.ptnum, 3).astype(np.float32)).to(dev)
    blob = torch.from_numpy((0.05 * rng.randn(b, config.ptnum, 3)).astype(np.float32)).to(dev)
    data = {name: (chamfer.sort_by_z_with_order(x)[0], sort_by_morton_with_order(x)[0])
            for name, x in (("gt", gt), ("out3", o3), ("rand", rnd), ("blob", blob))}
    ms = {"dyn": {}, "tile": {}}
    sums = {}
    for label, key in PAIRS:
        for k, (backend, scan) in enumerate((("dyn", chamfer.nn_dyn), ("tile", nn_tile))):
            name = f"{'K3 z-slab' if k == 0 else 'K8 tile  '} {label}"
            ms[backend][label] = timeit(name, pair, scan, data[key][k], data["gt"][k],
                                        iters=args.iters, device=dev, width=44)
        sd = float(pair(chamfer.nn_dyn, data[key][0], data["gt"][0]))
        st = float(pair(nn_tile, data[key][1], data["gt"][1]))
        rel = abs(sd - st) / max(abs(sd), 1e-9)
        print(f"sum check {label}: dyn={sd:.6f} tile={st:.6f} rel={rel:.2e}", flush=True)
        require(rel <= SUM_RTOL, f"{label}: K3's and K8's sums differ by {rel:.3g} relative")
        sums[label] = {"dyn": sd, "tile": st, "rel": rel}
    return emit({"tool": "bench_chamfer_tile", "device": info, "batch": b, "ms": ms,
                 "sums": sums})


if __name__ == "__main__":
    main()

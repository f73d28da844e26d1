"""K3 on an untrained model's outputs on one CUDA card (the counterpart of
``tools/bench_dyn_realdata.py``).

    python3 tools/bench_dyn_realdata_torch.py [--iters 10]
    python3 tools/bench_dyn_realdata_torch.py --device cpu --tiny   # plain versions

Times the K3 pair (``ops.chamfer.nn_dyn`` out3 -> gt and gt -> out3, both
presorted by z) at batch 32 and 16 384 points on the seeded random-init
model's out3 for a synthetic batch (``data.online.synthetic_batch(7, 0,
...)``), and the same pair on ``RandomState(0)`` uniform clouds against that
ground truth. For each direction it prints the share of the dense pairs
that lie in K3's slabs (targets within a query's final distance in z) and
in the slabs its blocks must load (``tools/sim_prune_stats_torch.py``'s
formulas, which ``chip_smoke.py`` uses too). The TPU tool sweeps its
kernel's tile_n and rounds; K3 runs one plan (``bench_chamfer_dyn2_torch``
says why). Times are ``_common_torch.timeit``'s; the last line is one JSON
object. Imports no JAX.
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
from rfnet_tpu_torch.train import TrainConfig  # noqa: E402
from tools._common_torch import TINY, device_info, emit, rand_clouds  # noqa: E402
from tools._common_torch import resolve_device, timeit, tool_model  # noqa: E402
from tools.sim_prune_stats_torch import k3_block_pairs, k3_windows  # noqa: E402

B = 32
TINY_B = 4


def shares(qs: torch.Tensor, ts: torch.Tensor) -> dict:
    """K3's slab pairs and the pairs its blocks load, as shares of the
    dense pairs, for the z-sorted queries ``qs`` against ``ts``."""
    dist = chamfer.nn_dyn(qs, ts)[0]
    lo, hi = k3_windows(qs, ts, dist)
    dense = float(qs.shape[0] * qs.shape[1] * ts.shape[1])
    return {"slab_pairs": float((hi - lo).sum()) / dense,
            "block_pairs": k3_block_pairs(lo, hi, ts.shape[1]) / dense}


def pair(a, c) -> torch.Tensor:
    return chamfer.nn_dyn(a, c)[0].sum() + chamfer.nn_dyn(c, a)[0].sum()


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
    print(f"device: {info['smi'] or info['name']}; batch {b}; K3 slab {chamfer._NN_DYN_SLAB}",
          flush=True)
    partial, gt = synthetic_batch(7, 0, b, config.innum, config.ptnum, dev)
    with torch.no_grad():
        o3 = tool_model(config, dev)(partial).out3
    (rnd,) = rand_clouds(np.random.RandomState(0), b, (config.ptnum,), dev)
    gs, os_, rs = (chamfer.sort_by_z_with_order(x)[0] for x in (gt, o3, rnd))
    result = {"tool": "bench_dyn_realdata", "device": info, "batch": b}
    for label, q in (("real out3<->gt", os_), ("rand rnd<->gt", rs)):
        ms = timeit(label, pair, q, gs, iters=args.iters, device=dev)
        fwd, bwd = shares(q, gs), shares(gs, q)
        print(f"  q->gt slab pairs {fwd['slab_pairs']:.4%}, blocks load "
              f"{fwd['block_pairs']:.4%}; gt->q slab pairs {bwd['slab_pairs']:.4%}, blocks "
              f"load {bwd['block_pairs']:.4%}", flush=True)
        result[label] = {"ms": ms, "q_to_gt": fwd, "gt_to_q": bwd}
    return emit(result)


if __name__ == "__main__":
    main()

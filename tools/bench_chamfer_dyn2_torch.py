"""The sorted-space wrappers' glue and K3 at its one plan on one CUDA card
(the counterpart of ``tools/bench_chamfer_dyn2.py``).

    python3 tools/bench_chamfer_dyn2_torch.py [--iters 10]
    python3 tools/bench_chamfer_dyn2_torch.py --device cpu --tiny   # plain versions

1. The sort/unsort microbench at batch 32: the z sort of 16 384 and of 3 000
   points a cloud (``ops.chamfer.sort_by_z_with_order``), the z sort with a
   result's unsort and index remap (what ``nearest_neighbor_dyn`` adds to
   K3), the Morton sort (``ops.chamfer_tile.sort_by_morton_with_order``,
   K8's) alone and with the unsort of a (b, n, 3) gradient
   (``ops.chamfer._unsort_rows``, the chamfer backward's).
2. K3 (``ops.chamfer.nn_dyn``) on presorted uniform and flat (z all equal)
   16384² clouds beside K4 (``ops.chamfer.nn_dense``) on the same clouds.

The TPU tool sweeps its kernel's (tile_n, tile_m, rounds). Those knobs have
no counterpart here: K3's slab of 256 targets (``kSlab``) and its 256
queries a block are compile-time constants of ``csrc/nn_dyn.cu``, and the
port runs one plan; a sweep over them is work for a later change. Times are
``_common_torch.timeit``'s; the last line is one JSON object. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from rfnet_tpu_torch.ops.chamfer_tile import sort_by_morton_with_order  # noqa: E402
from tools._common_torch import device_info, emit, resolve_device, timeit  # noqa: E402
from tools.bench_chamfer_dyn_torch import clouds  # noqa: E402

B, N, M = 32, 16384, 3000
TINY_B, TINY_N, TINY_M = 2, 512, 96
KNOBS = ("K3's TPU sweep knobs (tile_n, tile_m, rounds) have no counterpart: its slab "
         "(kSlab = {slab} targets) and its queries a block are compile-time constants of "
         "csrc/nn_dyn.cu; one plan runs")


def sort_unsort_remap(x):
    """The z sort, then what ``nearest_neighbor_dyn`` does to a result: the
    unsort of a distance row and the remap and unsort of an index row."""
    xs, o = chamfer.sort_by_z_with_order(x)
    d = xs.sum(-1)  # stand-in results
    i = torch.zeros_like(o)
    qo = o.long()
    return (torch.empty_like(d).scatter_(1, qo, d),
            torch.empty_like(i).scatter_(1, qo, torch.gather(o, 1, i.long())))


def morton_unsort(x):
    """The Morton sort and the unsort of a (b, n, 3) row set, as the
    chamfer backward unsorts its gradients."""
    xs, o = sort_by_morton_with_order(x)
    return chamfer._unsort_rows(o, xs)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a case")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="small clouds (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    b, n, m = (TINY_B, TINY_N, TINY_M) if args.tiny else (B, N, M)
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; batch {b}", flush=True)

    def timed(name, fn, *fn_args):
        return timeit(name, fn, *fn_args, iters=args.iters, device=dev, width=34)

    def cloud(kind, k, seed):
        return torch.from_numpy(clouds(kind, b, k, seed)).to(dev)

    q, q3 = cloud("uniform", n, 1), cloud("uniform", m, 2)
    ms = {
        f"zsort {b}x{n}": timed(f"zsort {b}x{n} alone", chamfer.sort_by_z_with_order, q),
        f"zsort+unsort+remap {b}x{n}": timed(f"zsort+unsort+remap {b}x{n}", sort_unsort_remap,
                                               q),
        f"zsort {b}x{m}": timed(f"zsort {b}x{m} alone", chamfer.sort_by_z_with_order, q3),
        f"morton {b}x{n}": timed(f"morton sort {b}x{n} alone", sort_by_morton_with_order, q),
        f"morton+unsort {b}x{n}": timed(f"morton sort+unsort rows {b}x{n}", morton_unsort, q),
    }
    print(KNOBS.format(slab=chamfer._NN_DYN_SLAB), flush=True)
    for kind in ("uniform", "flat"):
        qq = chamfer.sort_by_z_with_order(cloud(kind, n, 3))[0]
        tt = chamfer.sort_by_z_with_order(cloud(kind, n, 4))[0]
        dense = timed(f"[{kind}] K4 dense (no sorts)", chamfer.nn_dense, qq, tt)
        dyn = timed(f"[{kind}] K3 presorted", chamfer.nn_dyn, qq, tt)
        print(f"[{kind}] K3 {dense / dyn:.2f}x K4", flush=True)
        ms[f"{kind} dense"], ms[f"{kind} dyn"] = dense, dyn
    return emit({"tool": "bench_chamfer_dyn2", "device": info, "batch": b, "ms": ms,
                 "knobs": KNOBS.format(slab=chamfer._NN_DYN_SLAB)})


if __name__ == "__main__":
    main()

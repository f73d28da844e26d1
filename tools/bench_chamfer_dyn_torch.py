"""The early-exit scan K3 with its wrapper against the dense scan K4 on one
CUDA card (the counterpart of ``tools/bench_chamfer_dyn.py``).

    python3 tools/bench_chamfer_dyn_torch.py [--iters 10]
    python3 tools/bench_chamfer_dyn_torch.py --device cpu --tiny   # plain versions

Cases at batch 32, the train step's loss shapes:

  one-sided 16384² on uniform clouds (the cd3/cd4 proxy), on shell clouds
  (radius 0.5 ± 0.02, surface-like) and on clouds whose z are all equal
  (no z pruning possible); one-sided 16384 queries -> 3000 targets (the
  merge layer's scan); both directions of one 16384² pair with the sorts
  shared (``chamfer_big``'s ``nn_distance`` work).

The K3 times include the wrapper's z sorts, unsorts and index remap
(``ops.chamfer.nearest_neighbor_dyn``), the cost a caller pays; K4 is
``ops.chamfer.nn_dense``. Every case holds K3's distances to K4's within
1e-5 (K4 expands |t|² − 2q·t, K3 sums squared differences: they round
otherwise, and their indices may differ at near ties, so indices are only
counted). Times are ``_common_torch.timeit``'s; the last line is one JSON
object. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from tools._common_torch import device_info, emit, require, resolve_device, timeit  # noqa: E402

B, N, M = 32, 16384, 3000
TINY_B, TINY_N, TINY_M = 2, 512, 96
DIST_ATOL = 1e-5


def clouds(kind: str, b: int, n: int, seed: int) -> np.ndarray:
    """The JAX tool's clouds: uniform, shell or flat (z all 0.25)."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.rand(b, n, 3).astype(np.float32)
    if kind == "shell":
        v = rng.randn(b, n, 3).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
        return (0.5 + 0.02 * rng.randn(b, n, 1).astype(np.float32)) * v
    if kind == "flat":
        c = rng.rand(b, n, 3).astype(np.float32)
        c[..., 2] = 0.25
        return c
    raise ValueError(kind)


def dyn_bidir(x1, x2):
    """Both directions through K3 with one z sort of each cloud."""
    x1s, o1 = chamfer.sort_by_z_with_order(x1)
    x2s, o2 = chamfer.sort_by_z_with_order(x2)
    out = []
    for qs, ts, qo, to in ((x1s, x2s, o1, o2), (x2s, x1s, o2, o1)):
        d, i = chamfer.nn_dyn(qs, ts)
        qo = qo.long()
        out.append(torch.empty_like(d).scatter_(1, qo, d))
        out.append(torch.empty_like(i).scatter_(1, qo, torch.gather(to, 1, i.long())))
    return tuple(out)


def dense_bidir(x1, x2):
    return (*chamfer.nn_dense(x1, x2), *chamfer.nn_dense(x2, x1))


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

    def cloud(kind, k, seed):
        return torch.from_numpy(clouds(kind, b, k, seed)).to(dev)

    def case(label, dense_fn, dyn_fn, x, y):
        t_dense = timeit("", dense_fn, x, y, iters=args.iters, device=dev)
        t_dyn = timeit("", dyn_fn, x, y, iters=args.iters, device=dev)
        ref, got = dense_fn(x, y), dyn_fn(x, y)
        err = max(float((g - r).abs().max()) for g, r in zip(got[::2], ref[::2]))
        match = float(torch.cat([(g == r).float().flatten() for g, r in zip(got[1::2], ref[1::2])])
                      .mean())
        print(f"{label:30s}: dense {t_dense:8.3f} ms   dyn {t_dyn:8.3f} ms   "
              f"({t_dense / t_dyn:4.2f}x); dist maxerr {err:.2e}, idx match {match:.5f}",
              flush=True)
        require(err <= DIST_ATOL, f"{label}: K3's distances differ from K4's by {err}")
        return {"dense_ms": t_dense, "dyn_ms": t_dyn, "max_abs_err": err, "index_match": match}

    cases = {}
    for kind in ("uniform", "shell", "flat"):
        cases[f"one-sided {n}^2 {kind}"] = case(
            f"one-sided {n}^2 {kind}", chamfer.nn_dense, chamfer.nearest_neighbor_dyn,
            cloud(kind, n, 1), cloud(kind, n, 2))
    cases[f"one-sided {n}->{m} merge"] = case(
        f"one-sided {n}->{m} merge", chamfer.nn_dense, chamfer.nearest_neighbor_dyn,
        cloud("uniform", n, 3), cloud("uniform", m, 4))
    cases[f"bidirectional {n}^2 pair"] = case(
        f"bidirectional {n}^2 pair", dense_bidir, dyn_bidir, cloud("uniform", n, 5),
        cloud("uniform", n, 6))
    return emit({"tool": "bench_chamfer_dyn", "device": info, "batch": b, "cases": cases})


if __name__ == "__main__":
    main()

"""Counts of what the port's exact sorted-space walks must load, on the CPU
(the counterpart of ``tools/sim_prune_stats.py``, which counts the TPU
kernels' z-slab and box-tile walks).

    python tools/sim_prune_stats_torch.py [--tiny]

For each regime, one cloud of queries against one of targets, from the
final nearest distances (the plain full scan):

* K3 (``csrc/nn_dyn.cu``), over z-sorted clouds: the slab pairs, the
  targets whose z lies within a query's final distance of its z; and the
  pairs of the slabs its blocks must load (:func:`k3_block_pairs`).
* K7 (``csrc/nn_pruned.cu``, z-sorted) and K8 (``csrc/nn_tile.cu``,
  Morton-sorted), which share ``csrc/nn_tiles.cuh``'s walk: the pairs of
  the 32-target chunks no exact box rule can skip, and the union a warp of
  64 queries scans (:func:`tiled_needed_pairs`); the tiles of each plan's
  size a block must stage (:func:`tiles_needed`).

Every count is what any exact walk of that structure must load, a lower
bound on the kernel's work; ``chip_smoke.py`` prints the same counts beside
the kernels' own on the card. The regimes are the JAX tool's: a random-init
model's out3 against its synthetic ground truth and back, a converged proxy
(the ground truth jittered by 0.01), uniform against uniform, a compact
blob inside a spread cloud and back. The model runs at batch 1 with its
seeded random init. Each line reads shares of the dense pairs (n·m). The
last line is one JSON object. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from rfnet_tpu_torch.ops.chamfer_pruned import _PLAN as K7_PLAN  # noqa: E402
from rfnet_tpu_torch.ops.chamfer_tile import _PLAN as K8_PLAN  # noqa: E402
from rfnet_tpu_torch.ops.chamfer_tile import sort_by_morton_with_order  # noqa: E402

# queries a block of K3 (kQueries a block in csrc/nn_dyn.cu)
K3_BLOCK = 256


def k3_windows(qs: torch.Tensor, ts: torch.Tensor, dist: torch.Tensor):
    """For each z-sorted query, the range [lo, hi) of z-sorted targets whose
    z lies within its final distance √``dist`` of the query's z: the slab
    pairs any exact z-slab walk must visit."""
    tz = ts[..., 2].contiguous()
    r = torch.sqrt(dist)
    lo = torch.searchsorted(tz, (qs[..., 2] - r).contiguous(), right=False)
    hi = torch.searchsorted(tz, (qs[..., 2] + r).contiguous(), right=True)
    return lo, hi


def k3_block_pairs(lo, hi, m: int) -> float:
    """Pairs K3's blocks scan at least: a block of 256 consecutive sorted
    queries loads every slab of ``chamfer._NN_DYN_SLAB`` targets that one of
    its queries' z-windows [lo, hi) reaches, for all its queries (a warp may
    still skip a loaded slab by its box)."""
    slab, tile = chamfer._NN_DYN_SLAB, K3_BLOCK
    b, nq = lo.shape
    pad = -nq % tile
    lo_b = torch.nn.functional.pad(lo, (0, pad), value=m).view(b, -1, tile).amin(-1)
    hi_b = torch.nn.functional.pad(hi, (0, pad), value=0).view(b, -1, tile).amax(-1)
    first = torch.minimum(lo_b, hi_b - 1).clamp(min=0) // slab
    last = (hi_b - 1).clamp(min=0) // slab
    targets = torch.clamp((last + 1) * slab, max=m) - first * slab
    live = torch.full_like(targets, tile)
    live[:, -1] = nq - (live.shape[1] - 1) * tile
    return float((live * targets).sum())


def tiled_needed_pairs(qs, ts, best, warp: int) -> tuple[float, float]:
    """Pairs that no exact box rule over 32-target runs of the sorted target
    can skip: for each query, the points of every run of 32 consecutive
    targets (the kernels' chunk, whatever their tile) whose box is no farther
    than the query's final best. One basis for K7 and K8 and their bounds.
    Also the pairs a warp of ``warp`` consecutive queries scans when it votes
    on each run with those final bests: the union of its queries' runs,
    times its queries."""
    n, m = qs.shape[1], ts.shape[1]
    boxes = chamfer._tile_boxes(ts, 32)
    sizes = torch.full((boxes.shape[1],), 32.0, device=qs.device)
    sizes[-1] = m - (boxes.shape[1] - 1) * 32
    live = torch.clamp(n - torch.arange(0, n, warp, device=qs.device), max=warp).float()
    pairs = union = 0.0
    for lo in range(0, qs.shape[0], 8):  # (8, n, m / 32) gaps at a time
        q, bx = qs[lo:lo + 8], boxes[lo:lo + 8]
        need = _box_gap2(q, bx) <= best[lo:lo + 8, :, None]
        pairs += float((need * sizes).sum())
        need = torch.nn.functional.pad(need, (0, 0, 0, -n % warp))
        wants = need.view(need.shape[0], -1, warp, need.shape[2]).any(2)
        union += float(((wants * sizes).sum(-1) * live).sum())
    return pairs, union


def _box_gap2(q: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """(b, n, k) squared distance from each query of ``q`` (b, n, 3) to each
    box [lo, hi] of ``bx`` (b, k, 6); 0 inside."""
    gap2 = torch.zeros((q.shape[0], q.shape[1], bx.shape[1]), device=q.device)
    for a in range(3):
        qa = q[:, :, None, a]
        g = torch.clamp(torch.maximum(bx[:, None, :, a] - qa, qa - bx[:, None, :, 3 + a]),
                        min=0.0)
        gap2 += g * g
    return gap2


def tiles_needed(qs, ts, best, block: int, tile_m: int) -> float:
    """Tiles of ``tile_m`` sorted targets that the blocks of ``block``
    consecutive sorted queries must stage, summed over blocks: a tile whose
    box is no farther than one of the block's queries' final best. The
    share of all (block, tile) pairs is this over blocks · tiles."""
    n = qs.shape[1]
    need = _box_gap2(qs, chamfer._tile_boxes(ts, tile_m)) <= best[..., None]
    need = torch.nn.functional.pad(need, (0, 0, 0, -n % block))
    return float(need.view(need.shape[0], -1, block, need.shape[2]).any(2).sum())


def walk_counts(q: torch.Tensor, t: torch.Tensor) -> dict:
    """The counts of the module docstring for the queries ``q`` (b, n, 3)
    against the targets ``t`` (b, m, 3), each a share of the dense pairs or
    of the (block, tile) pairs."""
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    dense = float(b * n * m)
    out = {}
    qs, ts = chamfer.sort_by_z_with_order(q)[0], chamfer.sort_by_z_with_order(t)[0]
    dist = chamfer._nn_sorted_plain(qs, ts)[0]
    lo, hi = k3_windows(qs, ts, dist)
    out["k3_slab_pairs"] = float((hi - lo).sum()) / dense
    out["k3_block_pairs"] = k3_block_pairs(lo, hi, m) / dense
    warp = 32 * chamfer._NN_TILES_R
    for name, kernel, sort_fn, plan in (
            ("k7", "nn_pruned", chamfer.sort_by_z_with_order, K7_PLAN),
            ("k8", "nn_tile", sort_by_morton_with_order, K8_PLAN)):
        qs, ts = sort_fn(q)[0], sort_fn(t)[0]
        best = chamfer._nn_sorted_plain(qs, ts)[0]
        pairs, union = tiled_needed_pairs(qs, ts, best, warp)
        warps, tile_m = chamfer._nn_tiles_fit(kernel, n, m, plan)
        block = warps * warp
        out[f"{name}_chunk_pairs"] = pairs / dense
        out[f"{name}_warp_pairs"] = union / dense
        out[f"{name}_tiles"] = (tiles_needed(qs, ts, best, block, tile_m)
                                / (b * -(-n // block) * -(-m // tile_m)))
    return out


def regimes(tiny: bool) -> dict:
    """{name: (queries (1, n, 3), targets (1, m, 3))}, the JAX tool's six."""
    from rfnet_tpu_torch.data.online import synthetic_batch
    from rfnet_tpu_torch.train import TrainConfig
    from tools._common_torch import TINY, tool_model

    config = TrainConfig(**TINY) if tiny else TrainConfig()
    n = config.ptnum
    rng = np.random.RandomState(0)
    gt_like = torch.from_numpy(rng.rand(1, n, 3).astype(np.float32))
    rand = torch.from_numpy(rng.rand(1, n, 3).astype(np.float32))
    blob = torch.from_numpy((0.05 * rng.randn(1, n, 3)).astype(np.float32) + 0.5)
    partial, gt = synthetic_batch(7, 0, 1, config.innum, config.ptnum, "cpu")
    with torch.no_grad():
        o3 = tool_model(config, torch.device("cpu"))(partial).out3
    proxy = gt + torch.from_numpy(0.01 * rng.randn(1, n, 3).astype(np.float32))
    return {"init out3->gt": (o3, gt), "gt->init out3": (gt, o3),
            "gt->gt' (converged proxy)": (proxy, gt), "rand->rand": (rand, gt_like),
            "blob->spread": (blob, gt_like), "spread->blob": (gt_like, blob)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    print(f"device: cpu (counts, no times); K7 plan {K7_PLAN}, K8 plan {K8_PLAN}, K3 slab "
          f"{chamfer._NN_DYN_SLAB} and {K3_BLOCK} queries a block", flush=True)
    result = {}
    for name, (q, t) in regimes(args.tiny).items():
        c = walk_counts(q, t)
        result[name] = c
        print(f"== {name}: K3 slab pairs {c['k3_slab_pairs']:.4%}, block pairs "
              f"{c['k3_block_pairs']:.4%}; " + "; ".join(
                  f"{k.upper()} chunk pairs {c[f'{k}_chunk_pairs']:.4%}, warp union "
                  f"{c[f'{k}_warp_pairs']:.4%}, tiles {c[f'{k}_tiles']:.4%}" for k in ("k7", "k8")),
              flush=True)
    print(json.dumps({"tool": "sim_prune_stats", "regimes": result}), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Exact nearest-neighbour scan over z-sorted clouds with box-pruned tiles.

Port of ``rfnet_tpu/ops/pallas/chamfer_pruned.py`` and of
``rfnet_tpu/ops/chamfer.py:nearest_neighbor_pruned``. Both clouds are sorted
by z, so a tile of consecutive targets is a thin slab; kernel K7
(``csrc/nn_pruned.cu``) visits the target tiles from the one at its queries'
middle z, wrapping, stages only the tiles some warp's query box can still
reach, and skips a tile or a chunk of 32 targets by a warp's vote on its
queries' point-to-box bounds. The kernel computes the boxes itself, in a
pass before its walk, as the JAX wrapper computes them outside its kernel
(plain version ``ops/chamfer.py:_tile_boxes``).

Distances are sums of squared differences and the lowest sorted index wins
ties, as in K3, so one plain version serves K3, K7 and K8
(``ops/chamfer.py:_nn_sorted_plain``, the full scan): on the same z-sorted
inputs K7 equals K3 bit for bit. A CUDA tensor launches the kernel; a CPU
tensor takes the plain version.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch.ops.chamfer import _nn_sorted_unsorted, _nn_tiled, sort_by_z_with_order

# The launch plan (warps a block, targets a tile): the best of
# tools/bench_torch_nn_sorted.py's sweep over the PERF.md shapes (PERF.md §6).
_PLAN = (4, 512)


def nn_pruned(query_sorted: torch.Tensor, target_sorted: torch.Tensor):
    """K7's wrapper: exact one-sided NN over z-SORTED clouds,
    (dist² (b,n), idx (b,n) int32 into the sorted target)."""
    return _nn_tiled("nn_pruned", query_sorted, target_sorted, _PLAN)[:2]


def nearest_neighbor_pruned(query: torch.Tensor, target: torch.Tensor):
    """One-sided NN through the box-pruned scan, z sorts included:
    (dist² (b,n), idx (b,n) int32), both in the original orders. Distances
    are bit-equal to :func:`rfnet_tpu_torch.ops.chamfer.nearest_neighbor_dyn`.
    Gradient-free."""
    return _nn_sorted_unsorted(query, target, sort_by_z_with_order, nn_pruned)

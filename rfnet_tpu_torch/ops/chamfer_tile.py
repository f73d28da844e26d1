"""Exact nearest-neighbour scan over Morton-sorted clouds, best-first by tile.

Port of ``rfnet_tpu/ops/pallas/chamfer_tile.py``. A z-sorted slab is a shell
across the whole x/y extent: when the query cloud sits far from the target
(an untrained model's output) the z gap prunes little. Sorting both clouds by
Morton code makes a run of consecutive points a compact box, and kernel K8
(``csrc/nn_tile.cu``) takes the target tiles of each query tile best-first by
the box-to-box gap until the least gap left exceeds every running best. The
Morton sort and the per-tile boxes (``ops/chamfer.py:_tile_boxes``) are glue
computed here, as the JAX wrapper computes them outside its kernel.

Distances are sums of squared differences and the lowest sorted index wins
ties, so the plain version is the full scan K3 and K7 share
(``ops/chamfer.py:_nn_sorted_plain``). The scan is exact for any input order;
the order only decides how much is skipped. A CUDA tensor launches the
kernel; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch.ops.chamfer import _gather_rows, _nn_tiled

# Queries a block (one thread each) and targets a tile; smaller boxes bound
# tighter, larger ones pay fewer block-wide rounds.
_TILE_N = 128
_TILE_M = 128


def morton_code(x: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(b, n, 3) float cloud -> (b, n) int32 Morton (Z-order) key.

    Coordinates are normalised to the cloud's own bounding box, quantised to
    ``bits`` bits an axis and bit-interleaved, x lowest: 30 bits, the sign
    bit clear. The division and the power-of-two scale are exactly rounded,
    so the codes are the JAX function's."""
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    u = (x - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((u * float(1 << bits)).to(torch.int32), 0, (1 << bits) - 1)

    def spread(v):  # 10 bits -> one bit every 3 positions (magic-mask spread)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)


def sort_by_morton_with_order(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each cloud by Morton code:
    (sorted (b,n,3), order (b,n) int32)."""
    _, order = torch.sort(morton_code(x), dim=1, stable=True)
    return _gather_rows(x, order), order.to(torch.int32)


def nn_tile(query_sorted: torch.Tensor, target_sorted: torch.Tensor):
    """K8's wrapper: exact one-sided NN over spatially sorted clouds,
    (dist² (b,n), idx (b,n) int32 into the sorted target). Any number of
    target tiles (the TPU kernel takes at most 128)."""
    return _nn_tiled("nn_tile", query_sorted, target_sorted, _TILE_N, _TILE_M)[:2]

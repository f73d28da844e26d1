"""Ball query, grouping gather and k-NN (port of ``rfnet_tpu/ops/grouping.py``).

Plain PyTorch on both devices: the JAX package has no kernel here either.

``query_ball_point``: for each query, the FIRST ``nsample`` cloud points in
index order whose euclidean distance, clamped below at 1e-20, is strictly
less than ``radius``; the remaining slots repeat the first hit; the hit count
(capped at ``nsample``) comes back too. A query with no neighbour gets index
0 throughout. ``group_point`` is a batched gather whose autograd transpose is
the scatter-add. ``knn_point`` returns the NEGATED squared distances of the
reference's ``top_k(-dist)``, nearest first, the lower index first among
equal distances.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch.ops.chamfer import _sq3, _sqrt_rn


def _pairwise_sq(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(b, n, 3), (b, m, 3) -> (b, m, n) squared distances (query-major),
    one rounding per op, so the card and the CPU agree bit for bit."""
    return _sq3(x2[:, :, None, :] - x1[:, None, :, :])


def query_ball_point(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """First-``nsample``-in-ball indices of the (b, n, 3) cloud ``xyz1`` around
    the (b, m, 3) queries ``xyz2``: idx (b, m, nsample) int32, pts_cnt (b, m)
    int32. Materialises the (b, m, n) distance matrix, as the JAX function."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    d = torch.clamp(_sqrt_rn(_pairwise_sq(xyz1, xyz2)), min=1e-20)
    mask = d < radius  # (b, m, n)
    rank = torch.cumsum(mask.to(torch.int32), dim=-1)  # 1-based rank of each hit
    cnt = torch.clamp(rank[..., -1], max=nsample)
    # each of the first nsample hits writes its index into the slot of its
    # rank; everything else goes to a dump slot that is dropped
    slot = torch.where(mask & (rank <= nsample), rank - 1, nsample)
    k_ids = torch.arange(n, dtype=torch.int32, device=xyz1.device).expand(b, m, n)
    idx = torch.zeros((b, m, nsample + 1), dtype=torch.int32, device=xyz1.device)
    idx = idx.scatter_(2, slot.long(), k_ids)[..., :nsample]
    first_hit = mask.to(torch.int8).argmax(dim=-1).to(torch.int32)  # 0 when no hit
    slot_ids = torch.arange(nsample, device=xyz1.device)
    idx = torch.where(slot_ids < cnt[..., None], idx, first_hit[..., None])
    return idx, cnt.to(torch.int32)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (b, n, c) at (b, m, k) -> (b, m, k, c); grad scatter-adds."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, idx.long()]


def _first_k_smallest(d2: torch.Tensor, k: int):
    """The k least entries of the last axis in ascending order, the lower
    index first among equal values (``lax.top_k``'s order; ``torch.topk``
    promises none among ties, so this is a stable sort)."""
    val, idx = torch.sort(d2, dim=-1, stable=True)
    return val[..., :k], idx[..., :k].to(torch.int32)


def knn_point(k: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """k nearest neighbours of each xyz2 query among xyz1: (val (b, m, k), the
    NEGATED squared distance, nearest first; idx (b, m, k) int32)."""
    val, idx = _first_k_smallest(_pairwise_sq(xyz1, xyz2), k)
    return -val, idx

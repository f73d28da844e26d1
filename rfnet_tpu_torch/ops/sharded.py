"""Distance ops with the target axis split over the ranks of a mesh.

Port of ``rfnet_tpu/ops/sharded.py``. Every rank passes the full clouds and
scans its m/W slice of the targets for all the queries; collectives combine
the slices, so every rank returns the whole result. A
:class:`~rfnet_tpu_torch.parallel.Mesh` takes the place of the JAX ``Mesh``.

* :func:`nearest_neighbor_sharded` — each slice through the one-sided dense
  scan (K4, ``ops.chamfer.nearest_neighbor``), then two ``all_reduce(MIN)``:
  the distance, and the global index over the ranks whose distance equals
  the minimum (INT32_MAX elsewhere). Ties go to the lowest index, as in the
  unsplit scan and the JAX op's lowest-shard rule.
* :func:`approx_match_cost_sharded` — the plan-free approx-EMD recurrence in
  plain PyTorch, with ``all_reduce(SUM)`` where the JAX op has ``psum``: the
  row sums and the row mass at each level, and the cost at the end.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch.ops.chamfer import nearest_neighbor
from rfnet_tpu_torch.ops.emd import _capacities, _levels, _sq_dists
from rfnet_tpu_torch.parallel.mesh import Mesh

_NO_INDEX = torch.iinfo(torch.int32).max


def _my_targets(xyz2: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, int]:
    """This rank's slice of the targets and the index of its first one."""
    m = xyz2.shape[1]
    if m % mesh.size != 0:
        raise ValueError("target count must divide the mesh size")
    rows = mesh.rows(m)
    return xyz2[:, rows], rows.start


def nearest_neighbor_sharded(xyz1: torch.Tensor, xyz2: torch.Tensor, mesh: Mesh):
    """One-sided NN (dist² (b,n), idx (b,n) int32) with xyz2's points split
    over the mesh. Requires m divisible by the mesh size. Gradient-free."""
    targets, lo = _my_targets(xyz2, mesh)
    d, i = nearest_neighbor(xyz1, targets)
    dist = mesh.all_reduce_(d.clone(), "min")
    idx = torch.where(d == dist, i + lo, torch.full_like(i, _NO_INDEX))
    return dist, mesh.all_reduce_(idx, "min")


def nn_distance_sharded(xyz1: torch.Tensor, xyz2: torch.Tensor, mesh: Mesh):
    """Both directions of the Chamfer scan with the *opposite* cloud split
    over the mesh: (dist1, idx1, dist2, idx2) as ``ops.chamfer.nn_distance``
    gives them, without gradient."""
    d1, i1 = nearest_neighbor_sharded(xyz1, xyz2, mesh)
    d2, i2 = nearest_neighbor_sharded(xyz2, xyz1, mesh)
    return d1, i1, d2, i2


@torch.no_grad()
def approx_match_cost_sharded(xyz1: torch.Tensor, xyz2: torch.Tensor, mesh: Mesh):
    """Plan-free approx-EMD transport cost (b,) with xyz2's points split over
    the mesh: ``ops.emd.approx_match_cost``'s value up to the order of the
    float32 sums; no gradient. For clouds whose (n, m) level tiles one card
    cannot hold. Each rank holds (b, n, m/W) tiles: d², √d², the weights and
    the transported mass."""
    x2_loc, _ = _my_targets(xyz2, mesh)
    x1 = xyz1.detach().float()
    x2_loc = x2_loc.detach().float()
    b, n, _ = x1.shape
    multi_l, multi_r = _capacities(n, xyz2.shape[1])
    d2 = _sq_dists(x1, x2_loc)
    dd = torch.sqrt(d2)
    cost = torch.zeros(b, dtype=torch.float32, device=x1.device)
    remain_l = torch.full((b, n), multi_l, dtype=torch.float32, device=x1.device)
    remain_r = torch.full((b, x2_loc.shape[1]), multi_r, dtype=torch.float32,
                          device=x1.device)
    for level in _levels():
        w = torch.exp(level * d2)
        suml = 1e-9 + mesh.all_reduce_(torch.bmm(w, remain_r[:, :, None])[..., 0])
        ratio_l = remain_l / suml
        sumr = torch.bmm(w.transpose(1, 2), ratio_l[:, :, None])[..., 0] * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        delta = w.mul_(ratio_l[:, :, None]).mul_(ratio_r[:, None, :])
        cost += torch.sum(delta * dd, dim=(1, 2))
        remain_l = torch.clamp(remain_l - mesh.all_reduce_(delta.sum(2)), min=0.0)
    return mesh.all_reduce_(cost)

"""One-sided nearest-neighbour scans and the eval metrics built on them.

Port of the serving subset of ``rfnet_tpu/ops/chamfer.py``. Two kernels:

* K2 (``csrc/nn_coords.cu``) — the dense scan of ``e = |t|² − 2·q·t`` with
  strict ``<`` (first tie), returning ``max(e + |q|², 0)``, the argmin and
  the argmin's coordinates. It serves :func:`nearest_neighbor_coords` (the
  merge layer) and :func:`nearest_neighbor`.
* K3 (``csrc/nn_dyn.cu``) — the exact early-exit scan over z-sorted clouds,
  with distances taken as sums of squared differences and the lowest sorted
  index winning ties. It serves the eval metrics at every size. (The JAX
  package takes its dense expansion below 2²⁵ pairs and on the CPU; near
  d = 0 that expansion's rounding, magnified by the square root, moved the
  converged model's per-cloud CD by 1e-4 relative against float64, while
  sums of squares agree with float64 to 1e-7.)

Each kernel's wrapper launches the kernel for CUDA tensors and runs its plain
version (:func:`_one_sided`, :func:`_nn_sorted_plain`) for CPU tensors. The
plain versions round after every elementwise op exactly as the kernels do,
so the two agree bit for bit. Nothing here carries a gradient: callers
recompute distances from the returned coordinates to differentiate.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels

# Elements of one (b, chunk, m) temporary in the plain scans.
_PLAIN_CHUNK_ELEMS = 1 << 25


def _check_pair(query: torch.Tensor, target: torch.Tensor) -> None:
    for name, x in (("query", query), ("target", target)):
        if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
            raise ValueError(
                f"{name}: expected (b, n, 3) float32, got {tuple(x.shape)} {x.dtype}"
            )
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {x.device}")
    if query.device != target.device or query.shape[0] != target.shape[0]:
        raise ValueError(
            f"query {tuple(query.shape)} on {query.device} and target "
            f"{tuple(target.shape)} on {target.device} differ in batch or device"
        )
    if query.shape[1] == 0 or target.shape[1] == 0:
        raise ValueError("empty point cloud")


def _sq3(x: torch.Tensor) -> torch.Tensor:
    """(x² + y²) + z² over the last axis, one rounding per op."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def _chunk(b: int, m: int) -> int:
    return max(1, _PLAIN_CHUNK_ELEMS // (b * m))


def _pairwise_e(q: torch.Tensor, t: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """(b, n, m) ``e = |t|² − 2·q·t``: the squared distance less the query
    norm, which cannot change the argmin over targets. The query norm is
    added after the min, as K2 does (the JAX ``_pairwise_sq_dists`` adds it
    before, through a matmul)."""
    cross = (
        q[:, :, None, 0] * t[:, None, :, 0]
        + q[:, :, None, 1] * t[:, None, :, 1]
        + q[:, :, None, 2] * t[:, None, :, 2]
    )
    return s2[:, None, :] - 2.0 * cross


def _one_sided(x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dense scan: (dist² (b,n), idx (b,n) int32) of x1 into x2.

    The plain version of K2: ``e`` scanned in chunks of queries, first index
    of the least ``e``, then ``max(e + |q|², 0)``."""
    b, n, _ = x1.shape
    s1, s2 = _sq3(x1), _sq3(x2)
    step = _chunk(b, x2.shape[1])
    dist, idx = [], []
    for lo in range(0, n, step):
        e_min, i_min = _pairwise_e(x1[:, lo : lo + step], x2, s2).min(dim=-1)
        dist.append(torch.clamp(e_min + s1[:, lo : lo + step], min=0.0))
        idx.append(i_min.to(torch.int32))
    return torch.cat(dist, 1), torch.cat(idx, 1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def nn_coords(query: torch.Tensor, target: torch.Tensor):
    """K2's wrapper: (dist² (b,n), idx (b,n) int32, target[idx] (b,n,3))."""
    _check_pair(query, target)
    query = query.detach().contiguous()
    target = target.detach().contiguous()
    if not query.is_cuda:
        d, i = _one_sided(query, target)
        return d, i, _gather_rows(target, i)
    b, n, _ = query.shape
    m = target.shape[1]
    dist = torch.empty((b, n), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=query.device)
    coords = torch.empty((b, n, 3), dtype=torch.float32, device=query.device)
    kernels.launch("nn_coords", query.device, query, target, b, n, m, dist, idx, coords)
    return dist, idx, coords


def nearest_neighbor_coords(query: torch.Tensor, target: torch.Tensor):
    """One-sided NN returning (dist² (b,n), nn_coords (b,n,3) = target[argmin]).

    The merge layer's access pattern; outputs carry no gradient."""
    d, _, coords = nn_coords(query, target)
    return d, coords


def nearest_neighbor(query: torch.Tensor, target: torch.Tensor):
    """One-sided dense NN: (dist² (b,n), idx (b,n) int32), first-index ties.

    On the card this is K2 with the coordinates left unused (the dense-only
    kernel of the JAX package, ``nn_distance_pallas``, is not ported yet)."""
    d, i, _ = nn_coords(query, target)
    return d, i


def sort_by_z_with_order(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each cloud by z: (sorted (b,n,3), order (b,n) int32)."""
    _, order = torch.sort(x[..., 2], dim=1, stable=True)
    return _gather_rows(x, order), order.to(torch.int32)


def _nn_sorted_plain(qs: torch.Tensor, ts: torch.Tensor):
    """Plain version of K3: every pair's ((dx² + dy²) + dz²), first index of
    the least. Needs no sorting; the kernel needs it only to exit early."""
    b, n, _ = qs.shape
    step = _chunk(b, ts.shape[1])
    dist, idx = [], []
    for lo in range(0, n, step):
        q = qs[:, lo : lo + step]
        dx = q[:, :, None, 0] - ts[:, None, :, 0]
        dy = q[:, :, None, 1] - ts[:, None, :, 1]
        dz = q[:, :, None, 2] - ts[:, None, :, 2]
        d_min, i_min = (dx * dx + dy * dy + dz * dz).min(dim=-1)
        dist.append(d_min)
        idx.append(i_min.to(torch.int32))
    return torch.cat(dist, 1), torch.cat(idx, 1)


def nn_dyn(query_sorted: torch.Tensor, target_sorted: torch.Tensor):
    """K3's wrapper: exact one-sided NN over z-SORTED clouds,
    (dist² (b,n), idx (b,n) int32 into the sorted target)."""
    _check_pair(query_sorted, target_sorted)
    qs = query_sorted.detach().contiguous()
    ts = target_sorted.detach().contiguous()
    if not qs.is_cuda:
        return _nn_sorted_plain(qs, ts)
    b, n, _ = qs.shape
    m = ts.shape[1]
    dist = torch.empty((b, n), dtype=torch.float32, device=qs.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=qs.device)
    kernels.launch("nn_dyn", qs.device, qs, ts, b, n, m, dist, idx)
    return dist, idx


def nearest_neighbor_dyn(query: torch.Tensor, target: torch.Tensor):
    """One-sided NN through the early-exit scan, sorts included:
    (dist² (b,n), idx (b,n) int32), both in the original orders."""
    qs, q_ord = sort_by_z_with_order(query.detach())
    ts, t_ord = sort_by_z_with_order(target.detach())
    d_s, i_s = nn_dyn(qs, ts)
    q_ord = q_ord.long()
    d = torch.empty_like(d_s).scatter_(1, q_ord, d_s)
    i = torch.empty_like(i_s).scatter_(1, q_ord, torch.gather(t_ord, 1, i_s.long()))
    return d, i


def _metric_dist(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """One-sided NN distances² for the metrics, in sorted query order (means
    need no unsort): both clouds z-sorted, then the early-exit scan."""
    _check_pair(query, target)
    qs, _ = sort_by_z_with_order(query.detach())
    ts, _ = sort_by_z_with_order(target.detach())
    return nn_dyn(qs, ts)[0]


def chamfer_sample_means(pcd1: torch.Tensor, pcd2: torch.Tensor):
    """Per-sample mean √NN distance, both directions: ((b,), (b,)). The eval
    CD metric; gradient-free. Both scans run through K3 on the card and its
    plain version on the CPU, so the value does not depend on the device."""
    return (torch.sqrt(_metric_dist(pcd1, pcd2)).mean(dim=1),
            torch.sqrt(_metric_dist(pcd2, pcd1)).mean(dim=1))


def nn_sample_mean_one(query: torch.Tensor, target: torch.Tensor):
    """Per-sample mean √ one-sided NN distance: (b,). The fidelity metric
    (the eval CSV's ``emd`` column); gradient-free."""
    return torch.sqrt(_metric_dist(query, target)).mean(dim=1)

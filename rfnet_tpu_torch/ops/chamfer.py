"""Nearest-neighbour scans, the chamfer means with their gradients, and the
eval metrics built on them.

Port of ``rfnet_tpu/ops/chamfer.py``. Three kernels here, and two more
exact sorted-space scans in ``ops/chamfer_pruned.py`` (K7) and
``ops/chamfer_tile.py`` (K8), which share :func:`_nn_sorted_plain` with K3:

* K2 (``csrc/nn_coords.cu``) — the dense scan of ``e = |t|² − 2·q·t`` with
  strict ``<`` (first tie), returning ``max(e + |q|², 0)``, the argmin and
  the argmin's coordinates. It serves :func:`nearest_neighbor_coords` (the
  merge layer), as the custom operator ``rfnet::nn_coords`` (so an
  exported forward holds the kernel).
* K4 (``csrc/nn_dense.cu``) — the same scan without the coordinates. It
  serves :func:`nearest_neighbor` (``zero_groupnear``) and both directions of
  :func:`nn_distance`. K2 and K4 split the targets where the queries are too
  few to fill the card; :func:`_nn_scan_plan` chooses how.
* K3 (``csrc/nn_dyn.cu``) — the exact early-exit scan over z-sorted clouds,
  with distances taken as sums of squared differences and the lowest sorted
  index winning ties. It serves the eval metrics and the losses'
  :func:`chamfer_means` / :func:`chamfer_means_pair` at every size and on
  both devices, whose backward scatters through K5 (``ops/nn_grad.py``).
  (The JAX package takes its dense expansion below 2²⁵ pairs and on the CPU;
  near d = 0 that expansion's rounding, magnified by the square root, moved
  the converged model's per-cloud CD by 1e-4 relative against float64, while
  sums of squares agree with float64 to 1e-7.)

Each kernel's wrapper launches the kernel for CUDA tensors and runs its plain
version (:func:`_one_sided`, :func:`_nn_sorted_plain`) for CPU tensors. The
plain versions round after every elementwise op exactly as the kernels do,
so the two agree bit for bit. The scans carry no gradient themselves; the
autograd Functions here apply the reference's gradient formulas.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels, tracing
from rfnet_tpu_torch.ops.fps import _sm_count
from rfnet_tpu_torch.ops.nn_grad import index_add_rows, nn_grad_scatter

# Elements of one (b, chunk, m) temporary in the plain scans.
_PLAIN_CHUNK_ELEMS = 1 << 25
# K3: consecutive sorted targets in one shared-memory slab (kSlab in
# csrc/nn_dyn.cu, which refuses another value)
_NN_DYN_SLAB = 256
# K2/K4 (csrc/nn_scan.cuh, which checks them): warps a CTA, CTAs a cluster
# and bytes of shared memory a block may have; then the plan's aims: live
# warps an SM, and the fewest targets a warp scans where the targets are split
_NN_SCAN_WARPS = 8
_NN_SCAN_CLUSTER = 8
_NN_SCAN_SHARED = 232448
_NN_SCAN_WARPS_PER_SM = 8
_NN_SCAN_MIN_CHAIN = 32


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


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 √x, correctly rounded on every device. PyTorch's CPU float32
    sqrt is one ulp off on about 0.6 % of inputs while the card's is
    correctly rounded, which set the chamfer gradients of the two devices
    apart where the backward's terms cancel. The float64 root rounded once
    to float32 is the correctly rounded float32 root."""
    return torch.sqrt(x.double()).float()


def _chunk(b: int, m: int) -> int:
    """Queries a chunk of the plain scans. While ``torch.export`` traces, the
    batch may be symbolic and the chunk may not depend on it: the chunk of
    one cloud then (a chunk splits queries, so no value changes)."""
    if torch.compiler.is_exporting():
        b = 1
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


def _nn_scan_shared(m: int, plan: tuple[int, int, int, int, int]) -> int:
    """Bytes of shared memory a CTA of K2/K4 takes under ``plan``: its
    range's tile (two where the range is tiled) and, where the targets are
    split, an (e, j) partial for each query slot (mirrors
    ``csrc/nn_scan.cuh:nn_scan_shared_bytes``)."""
    r, g, w, c, tiles = plan
    tile = -(-(-(-m // c)) // tiles)
    part = 8 * 32 * r * g * w if w * c > 1 else 0
    return (1 if tiles == 1 else 2) * 16 * tile + part


def _nn_scan_fill(b: int, n: int, m: int, r: int, w: int, c: int, sms: int):
    """The plan (R, G, W, C, tiles) of K2/K4 with R, W and C chosen: G, the
    query warps a CTA, is the largest power of two the CTA has room for
    (G·W ≤ 8) that the cloud's query warps fill and that leaves at least
    ``sms`` CTAs (1 where even that leaves fewer); the CTA's range of
    ``ceil(m / C)`` targets is staged whole where it fits shared memory,
    else in the fewest tiles two of which fit."""
    qw = -(-n // (32 * r))
    g = min(_NN_SCAN_WARPS // w, 1 << (qw - 1).bit_length())
    while g > 1 and b * -(-qw // g) * c < sms:
        g //= 2
    tiles = 1
    while _nn_scan_shared(m, (r, g, w, c, tiles)) > _NN_SCAN_SHARED:
        tiles += 1
    return r, g, w, c, tiles


def _nn_scan_plan(b: int, n: int, m: int, sms: int) -> tuple[int, int, int, int, int]:
    """K2/K4's launch for ``b`` clouds of ``n`` queries and ``m`` targets on
    a card with ``sms`` SMs: (R queries a thread, G query warps a CTA, W
    warps that split a CTA's targets, C CTAs of a cluster that split the
    cloud's targets, tiles a CTA stages its range in). Plain Python.

    R is 8 where one warp a cloud per 256 queries already gives
    ``_NN_SCAN_WARPS_PER_SM`` live warps an SM, else 4. The split S = W·C
    doubles, up to 64, while the live warps (b · query warps · S) are fewer
    than that and a warp keeps at least ``_NN_SCAN_MIN_CHAIN`` targets, so a
    chain that is long enough is never cut. The warps of a CTA take a split
    up to 8 (W = S, C = 1); a larger one spreads over clusters of 8 CTAs
    (C = 8, W = S / 8). (On an H100 the block scheduler packs clusters onto
    few SMs: at (32,1024)→3000, 256 CTAs of 8 warps in clusters of 8 took
    0.0659 ms, the same split within CTAs 0.0436.) :func:`_nn_scan_fill`
    chooses G and the tiles."""
    aim = _NN_SCAN_WARPS_PER_SM * sms
    r = 8 if b * -(-n // 256) >= aim else 4
    qw = -(-n // (32 * r))
    s = 1
    while (s < _NN_SCAN_WARPS * _NN_SCAN_CLUSTER and b * qw * s < aim
           and -(-m // (2 * s)) >= _NN_SCAN_MIN_CHAIN):
        s *= 2
    c = 1 if s <= _NN_SCAN_WARPS else _NN_SCAN_CLUSTER
    return _nn_scan_fill(b, n, m, r, s // c, c, sms)


def _nn_scan_launch(name: str, query: torch.Tensor, target: torch.Tensor, plan):
    """Launch K2 (``name`` "nn_coords") or K4 ("nn_dense") on contiguous
    CUDA tensors under ``plan``: (dist² (b,n), idx (b,n) int32) and, for K2,
    target[idx] (b,n,3). The kernel refuses a plan it cannot run."""
    b, n, _ = query.shape
    out = [torch.empty((b, n), dtype=torch.float32, device=query.device),
           torch.empty((b, n), dtype=torch.int32, device=query.device)]
    if name == "nn_coords":
        out.append(torch.empty((b, n, 3), dtype=torch.float32, device=query.device))
    kernels.launch(name, query.device, query, target, b, n, target.shape[1], *plan, *out)
    return tuple(out)


def _nn_scan_cuda(name: str, query: torch.Tensor, target: torch.Tensor):
    b, n, _ = query.shape
    plan = _nn_scan_plan(b, n, target.shape[1], _sm_count(query.device))
    return _nn_scan_launch(name, query, target, plan)


def _nn_coords_cuda(query: torch.Tensor, target: torch.Tensor):
    """K2 on CUDA tensors: the body of ``rfnet::nn_coords``; its plan is
    chosen here, at run time, as K1's is."""
    return _nn_scan_cuda("nn_coords", query.contiguous(), target.contiguous())


def _nn_coords_fake(query: torch.Tensor, target: torch.Tensor):
    b, n, _ = query.shape
    return (query.new_empty((b, n)), query.new_empty((b, n), dtype=torch.int32),
            query.new_empty((b, n, 3)))


kernels.define_op("nn_coords(Tensor query, Tensor target) -> (Tensor, Tensor, Tensor)",
                  _nn_coords_cuda, _nn_coords_fake)


def nn_coords(query: torch.Tensor, target: torch.Tensor):
    """K2's wrapper: (dist² (b,n), idx (b,n) int32, target[idx] (b,n,3)),
    through ``rfnet::nn_coords`` for CUDA tensors."""
    _check_pair(query, target)
    query = query.detach().contiguous()
    target = target.detach().contiguous()
    if not query.is_cuda:
        d, i = _one_sided(query, target)
        return d, i, _gather_rows(target, i)
    return torch.ops.rfnet.nn_coords(query, target)


def nearest_neighbor_coords(query: torch.Tensor, target: torch.Tensor):
    """One-sided NN returning (dist² (b,n), nn_coords (b,n,3) = target[argmin]).

    The merge layer's access pattern; outputs carry no gradient."""
    d, _, coords = nn_coords(query, target)
    return d, coords


def nn_dense(query: torch.Tensor, target: torch.Tensor):
    """K4's wrapper: (dist² (b,n), idx (b,n) int32) of query into target."""
    _check_pair(query, target)
    query = query.detach().contiguous()
    target = target.detach().contiguous()
    if not query.is_cuda:
        return _one_sided(query, target)
    return _nn_scan_cuda("nn_dense", query, target)


def nearest_neighbor(query: torch.Tensor, target: torch.Tensor):
    """One-sided dense NN: (dist² (b,n), idx (b,n) int32), first-index ties.
    Gradient-free."""
    return nn_dense(query, target)


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1 = nn_dense(xyz1, xyz2)
        d2, i2 = nn_dense(xyz2, xyz1)
        ctx.save_for_backward(xyz1, xyz2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        # ∂dist1/∂xyz1 = 2 (xyz1 − xyz2[idx1]); ∂dist1/∂xyz2 = −(same), routed
        # to the argmin rows (rfnet_tpu/ops/chamfer.py:_bwd)
        xyz1, xyz2, i1, i2 = ctx.saved_tensors
        diff1 = xyz1 - _gather_rows(xyz2, i1)
        diff2 = xyz2 - _gather_rows(xyz1, i2)
        d1 = 2.0 * g1[..., None] * diff1
        d2 = 2.0 * g2[..., None] * diff2
        d1 = d1 + index_add_rows(xyz1.shape, i2, -2.0 * g2[..., None] * diff2)
        d2 = d2 + index_add_rows(xyz2.shape, i1, -2.0 * g1[..., None] * diff1)
        return d1, d2


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Squared NN distances + argmin indices in both directions:
    (dist1 (b,n), idx1 (b,n), dist2 (b,m), idx2 (b,m)). Both scans are K4;
    the distances carry the reference gradient, the indices none."""
    return _NNDistance.apply(xyz1, xyz2)


def sort_by_z_with_order(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each cloud by z: (sorted (b,n,3), order (b,n) int32)."""
    _, order = torch.sort(x[..., 2], dim=1, stable=True)
    return _gather_rows(x, order), order.to(torch.int32)


def _unsort_rows(order: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Undo a row permutation: out[order[k]] = rows[k]."""
    index = order.long()[..., None].expand(-1, -1, rows.shape[-1])
    return torch.empty_like(rows).scatter_(1, index, rows)


def _nn_sorted_plain(qs: torch.Tensor, ts: torch.Tensor):
    """Plain version of K3, K7 and K8: every pair's ((dx² + dy²) + dz²), first
    index of the least. Needs no sorting; the kernels need it only to skip
    work."""
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
    (dist² (b,n), idx (b,n) int32 into the sorted target). While a profiler
    records, K3 adds the pairs of the slabs its blocks loaded to the counter
    ``k3.pairs_loaded``, and ``k3.pairs_dense`` takes b·n·m (``tracing.py``);
    the plain version counts nothing."""
    _check_pair(query_sorted, target_sorted)
    qs = query_sorted.detach().contiguous()
    ts = target_sorted.detach().contiguous()
    if not qs.is_cuda:
        return _nn_sorted_plain(qs, ts)
    b, n, _ = qs.shape
    m = ts.shape[1]
    dist = torch.empty((b, n), dtype=torch.float32, device=qs.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=qs.device)
    loaded = tracing.device_counter("k3.pairs_loaded", qs.device)
    tracing.count("k3.pairs_dense", b * n * m)
    kernels.launch("nn_dyn", qs.device, qs, ts, b, n, m, _NN_DYN_SLAB, dist, idx, loaded)
    return dist, idx


def _tile_boxes(ts: torch.Tensor, tile_m: int) -> torch.Tensor:
    """(b, mt, 6) boxes [lo x y z, hi x y z] over each run of ``tile_m``
    consecutive points of ``ts`` (b, m, 3); the ragged last run counts its
    real points only. The plain version of the box pass K7 and K8 run before
    their walk (at 32 targets a chunk and at their tile size), and the glue
    K6 takes beside its sorted clouds."""
    b, m, _ = ts.shape
    mt = -(-m // tile_m)
    pad = (0, 0, 0, mt * tile_m - m)
    lo = torch.nn.functional.pad(ts, pad, value=float("inf")).view(b, mt, tile_m, 3).amin(2)
    hi = torch.nn.functional.pad(ts, pad, value=float("-inf")).view(b, mt, tile_m, 3).amax(2)
    return torch.cat([lo, hi], dim=-1).contiguous()


_NN_TILES_R = 2  # queries a thread of K7 and K8 (kR)
_NN_TILES_CHUNK = 32  # targets of a chunk, their finest skip (kChunk)
# shared memory a block may have, less the walk's static part
# (kTilesMaxShared - kTilesStaticShared)
_NN_TILES_MAX_SHARED = 232448 - 8 * 7 * 4


def _nn_tiles_shared(name: str, m: int, tile_m: int) -> int:
    """Dynamic shared memory of a K7 or K8 block (nn_tiles_shared_bytes):
    two buffers of ``tile_m`` float4s and, for K8, its tiles' 8-byte sort
    keys, padded to a power of two."""
    mt = -(-m // tile_m)
    keys = 1 << (mt - 1).bit_length() if name == "nn_tile" else 0
    return 32 * tile_m + 8 * keys


def _nn_tiles_fit(name: str, n: int, m: int, plan: tuple) -> tuple:
    """The plan (warps a block, targets a tile) that K7 (``nn_pruned``) or
    K8 (``nn_tile``) runs at ``n`` queries and ``m`` targets: the warps cut
    to the fewest (a power of two) that hold n queries at two a thread; the
    tile cut to m rounded up to a chunk and, where K8's sort keys would not
    fit shared memory (m > 2 097 152 at 128 a tile), doubled until they do.
    The kernel refuses warps other than a power of two up to 8, a tile that
    is not a multiple of 32, and a block that does not fit; so does this
    beyond 2^25 targets a cloud."""
    warps, tile_m = plan
    need = -(-n // (32 * _NN_TILES_R))
    while warps > 1 and warps // 2 >= need:
        warps //= 2
    c = _NN_TILES_CHUNK
    tile_m = min(tile_m, -(-m // c) * c)
    while _nn_tiles_shared(name, m, tile_m) > _NN_TILES_MAX_SHARED:
        if 64 * tile_m > _NN_TILES_MAX_SHARED:  # the doubled tile's buffers alone
            raise ValueError(f"{name}: {m} targets a cloud is more than its tiles can hold")
        tile_m *= 2
    return warps, tile_m


def _nn_tiled(name: str, query_sorted: torch.Tensor, target_sorted: torch.Tensor, plan: tuple):
    """The wrapper body K7 (``nn_pruned``) and K8 (``nn_tile``) share: the
    plain full scan for CPU tensors, the kernel ``name`` under ``plan``
    (warps, tile_m; :func:`_nn_tiles_fit`) for CUDA tensors. The kernel
    computes its chunk and tile boxes itself, into scratch. Returns (dist²,
    idx, visited): ``visited`` (b, query blocks) int32 counts the target
    tiles each block staged (every tile on the CPU, which prunes nothing)."""
    _check_pair(query_sorted, target_sorted)
    qs = query_sorted.detach().contiguous()
    ts = target_sorted.detach().contiguous()
    b, n, _ = qs.shape
    m = ts.shape[1]
    warps, tile_m = _nn_tiles_fit(name, n, m, plan)
    nt, mt = -(-n // (32 * warps * _NN_TILES_R)), -(-m // tile_m)
    if not qs.is_cuda:
        return (*_nn_sorted_plain(qs, ts), torch.full((b, nt), mt, dtype=torch.int32))
    mc = -(-m // _NN_TILES_CHUNK)
    boxes = torch.empty(b * (mc + mt) * 6, dtype=torch.float32, device=qs.device)
    dist = torch.empty((b, n), dtype=torch.float32, device=qs.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=qs.device)
    visited = torch.empty((b, nt), dtype=torch.int32, device=qs.device)
    kernels.launch(name, qs.device, qs, ts, boxes, b, n, m, warps, tile_m, dist, idx, visited)
    return dist, idx, visited


def _nn_sorted_unsorted(query, target, sort_fn, nn_fn):
    """Sort both clouds with ``sort_fn``, run the sorted-space scan ``nn_fn``,
    and map (dist², idx) back to the callers' orders. Gradient-free."""
    qs, q_ord = sort_fn(query.detach())
    ts, t_ord = sort_fn(target.detach())
    d_s, i_s = nn_fn(qs, ts)
    q_ord = q_ord.long()
    d = torch.empty_like(d_s).scatter_(1, q_ord, d_s)
    i = torch.empty_like(i_s).scatter_(1, q_ord, torch.gather(t_ord, 1, i_s.long()))
    return d, i


def nearest_neighbor_dyn(query: torch.Tensor, target: torch.Tensor):
    """One-sided NN through the early-exit scan, sorts included:
    (dist² (b,n), idx (b,n) int32), both in the original orders."""
    return _nn_sorted_unsorted(query, target, sort_by_z_with_order, nn_dyn)


def nearest_neighbor_tile(query: torch.Tensor, target: torch.Tensor):
    """One-sided NN through the best-first box-tile scan K8, Morton sorts
    included: (dist² (b,n), idx (b,n) int32) in the original orders. Exact:
    distances bit-equal to :func:`nearest_neighbor_dyn`, the lowest index in
    Morton-sorted space winning ties."""
    from rfnet_tpu_torch.ops.chamfer_tile import nn_tile, sort_by_morton_with_order

    return _nn_sorted_unsorted(query, target, sort_by_morton_with_order, nn_tile)


# Which sorted-space scan the losses and the eval metrics use: "dyn" = z sort
# + K3's slab walk, "tile" = Morton sort + K8's best-first box-tile walk. Both
# are exact; they differ in how much of the scan the data lets them skip. Read
# at call time, so a benchmark can flip it. The backward takes any index.
_NN_SORTED_BACKEND = "dyn"


def _sorted_nn_fns():
    """(sort function, sorted-space scan) of the current backend."""
    if _NN_SORTED_BACKEND == "tile":
        from rfnet_tpu_torch.ops.chamfer_tile import nn_tile, sort_by_morton_with_order

        return sort_by_morton_with_order, nn_tile
    return sort_by_z_with_order, nn_dyn


def nn_sample_mean_one(query: torch.Tensor, target: torch.Tensor):
    """Per-sample mean √ one-sided NN distance: (b,). The fidelity metric
    (the eval CSV's ``emd`` column); gradient-free. Both clouds are sorted
    (means need no unsort), then the backend's sorted-space scan."""
    _check_pair(query, target)
    sort_fn, nn_fn = _sorted_nn_fns()
    qs, _ = sort_fn(query.detach())
    ts, _ = sort_fn(target.detach())
    return _sqrt_rn(nn_fn(qs, ts)[0]).mean(dim=1)


def _inv_sqrt_scale(g: torch.Tensor, count: float, d: torch.Tensor) -> torch.Tensor:
    """d(mean √d)/d(d) times the cotangent, with the safe-sqrt guard:
    g / (count·2·max(√d, 1e-7))."""
    return g / (count * 2.0 * torch.clamp(_sqrt_rn(d), min=1e-7))


class _ChamferSampleMeans(torch.autograd.Function):
    """Per-cloud (mean √NN-dist pcd1→pcd2 (b,), mean √ pcd2→pcd1 (b,)), all
    in sorted space (z or Morton, as ``_NN_SORTED_BACKEND`` says;
    ``rfnet_tpu/ops/chamfer.py:_chamfer_means_dyn``): means need no unsort;
    the backward applies the reference gradient in sorted space, scatters
    the reverse-routed term through K5, and unsorts the two gradients. A
    cloud that needs no gradient (a ground truth) costs no scatter."""

    @staticmethod
    def forward(ctx, pcd1, pcd2):
        _check_pair(pcd1, pcd2)
        sort_fn, nn_fn = _sorted_nn_fns()
        x1s, o1 = sort_fn(pcd1.detach())
        x2s, o2 = sort_fn(pcd2.detach())
        d1, i1 = nn_fn(x1s, x2s)
        d2, i2 = nn_fn(x2s, x1s)
        ctx.save_for_backward(x1s, o1, x2s, o2, d1, i1, d2, i2)
        return _sqrt_rn(d1).mean(dim=1), _sqrt_rn(d2).mean(dim=1)

    @staticmethod
    def backward(ctx, g1, g2):
        x1s, o1, x2s, o2, d1, i1, d2, i2 = ctx.saved_tensors
        n, m = x1s.shape[1], x2s.shape[1]
        gd1 = _inv_sqrt_scale(g1[:, None], float(n), d1)
        gd2 = _inv_sqrt_scale(g2[:, None], float(m), d2)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            sp2, sw2 = nn_grad_scatter(x2s, gd2, i2, n)
            diff1 = x1s - _gather_rows(x2s, i1)
            ga_s = 2.0 * gd1[..., None] * diff1 - 2.0 * sp2 + 2.0 * x1s * sw2[..., None]
            ga = _unsort_rows(o1, ga_s)
        if ctx.needs_input_grad[1]:
            sp1, sw1 = nn_grad_scatter(x1s, gd1, i1, m)
            diff2 = x2s - _gather_rows(x1s, i2)
            gb_s = 2.0 * gd2[..., None] * diff2 - 2.0 * sp1 + 2.0 * x2s * sw1[..., None]
            gb = _unsort_rows(o2, gb_s)
        return ga, gb


def chamfer_sample_means(pcd1: torch.Tensor, pcd2: torch.Tensor):
    """Per-sample mean √NN distance, both directions: ((b,), (b,)). The eval
    CD metric, and the loss's chamfer means below; differentiable. Forward the
    backend's scan (K3, or K8) both ways (its plain version on the CPU, so the
    value does not depend on the device); backward K5 for each cloud that
    needs a gradient."""
    return _ChamferSampleMeans.apply(pcd1, pcd2)


def chamfer_means(pcd1: torch.Tensor, pcd2: torch.Tensor):
    """(mean √NN-dist both directions), differentiable: the chamfer_big
    reduction without indices. One formula on both devices and at every
    size (the JAX package takes its dense scan below 2²⁵ pairs)."""
    m1, m2 = chamfer_sample_means(pcd1, pcd2)
    return m1.mean(), m2.mean()


def chamfer_means_pair(gt: torch.Tensor, out_a: torch.Tensor, out_b: torch.Tensor):
    """(m_a1, m_a2, m_b1, m_b2) = chamfer_means(gt, out_a) ++ chamfer_means(gt,
    out_b), with the two outputs stacked on the batch axis against gt
    stacked twice, so each direction is one launch of the backend's scan and
    the outputs' backward one K5 launch (``_chamfer_means_pair_dyn``). The
    outputs must have one shape."""
    b = gt.shape[0]
    m1, m2 = chamfer_sample_means(torch.cat([gt, gt]), torch.cat([out_a, out_b]))
    return m1[:b].mean(), m2[:b].mean(), m1[b:].mean(), m2[b:].mean()

"""Approximate Earth Mover's Distance: multiscale soft matching + cost.

Port of ``rfnet_tpu/ops/emd.py`` (itself the reference ``ApproxMatch`` /
``MatchCost`` GPU ops, with the GPU level schedule j = 7 … −2):

  capacities: multiL = 1, multiR = n//m  if n ≥ m  (integer division),
  else multiL = m//n, multiR = 1.
  for level j in 7, 6, …, −1, −2 with λ = −4^j (λ = 0 at j = −2):
      w_kl       = exp(λ · d²(xyz1_k, xyz2_l))
      ratioL_k   = remainL_k / (1e−9 + Σ_l w_kl · remainR_l)
      s_l        = (Σ_k w_kl · ratioL_k) · remainR_l
      ratioR_l   = min(remainR_l / (s_l + 1e−9), 1) · remainR_l
      remainR_l  = max(0, remainR_l − s_l)
      Δ_kl       = w_kl · ratioL_k · ratioR_l
      match     += Δ;  remainL_k = max(0, remainL_k − Σ_l Δ_kl)

with d² = max((|x1|² + |x2|²) − 2·x1·x2, 0), the JAX package's expansion.

* :func:`approx_match` — the transport plan (b, m, n); no gradient.
* :func:`match_cost` — Σ ‖p1−p2‖·match with the reference's hand-written
  gradient; the plan gets none.
* :func:`approx_match_cost_diff` — the train path: one pass of the level
  recurrence that accumulates the cost and its gradient (no plan, no
  separate cost pass); plain PyTorch, as it is plain XLA in the reference.
* :func:`approx_match_cost` — the eval's plan-free cost: kernel K6
  (``csrc/emd_cost.cu``) for CUDA tensors, the chunked plain recurrence
  :func:`_approx_match_cost_plain` for CPU tensors. Chunks are ragged where n
  is not a multiple of the chunk, so no padded row (and no mass for one)
  ever exists.

K6 is bound by its operations (about 109 a pair, nothing of size n·m kept),
so the wrapper prepares what lets the kernel skip pairs: both clouds sorted
by Morton code (the cost is a sum over all pairs, so nothing is ever
unsorted); the kernel takes a box over every run of :data:`_TILE` points. At
level λ the kernel's weight ``2^(λ·log2(e)·d²)`` is exactly 0 once the
argument falls below −126, and the kernel skips a (64-point, 128-point) tile
pair whose boxes lie that far apart: :func:`_band_skips` is that rule in
plain PyTorch and :func:`_kernel_weight` the kernel's weight, for the tests
that hold "skipped" to "weight exactly 0".
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels
from rfnet_tpu_torch.ops.chamfer import _tile_boxes
from rfnet_tpu_torch.ops.chamfer_tile import sort_by_morton_with_order
from rfnet_tpu_torch.ops.nn_grad import _sm_count

# The whole (b, n, m) matrix is held while b·n·m stays below this many
# elements; above it the recurrence streams row chunks of _CHUNK.
_FULL_PATH_MAX_ELEMS = 160 * 1024 * 1024
_CHUNK = 512

# K6's tiles: points of the walked cloud under one box (csrc/emd_cost.cu
# kTile) and consecutive points a warp holds of its own cloud (32·kQ).
_TILE = 128
_WARP_TILE = 64
_BLOCK_POINTS = 256  # points of its own cloud a block holds (kRows)
_BLOCKS_PER_SM = 64  # blocks of a sweep an SM should get, and
_MAX_PARTS = 64  # the most blocks that share one walk
# K6's weight is ex2.approx.ftz(λ·log2(e)·d²): exactly 0 below 2^-126. The
# rule skips where the argument is under −_ZERO_ARG after taking off the
# expansion's rounding error, at most _SLACK·(|a|² + |b|²).
_ZERO_ARG = 128.0
_SLACK = 2.0**-19


def _levels() -> list[float]:
    """λ = −4^j for j = 7 … −1, then 0 (all exact in float32)."""
    return [-(4.0**j) for j in range(7, -2, -1)] + [0.0]


def _capacities(n: int, m: int) -> tuple[float, float]:
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(b, n, 3), (b, m, 3) -> (b, n, m) squared distances in fp32."""
    s1 = torch.sum(x1 * x1, dim=-1)
    s2 = torch.sum(x2 * x2, dim=-1)
    cross = torch.bmm(x1, x2.transpose(1, 2))
    return torch.clamp(s1[:, :, None] + s2[:, None, :] - 2.0 * cross, min=0.0)


def _check(xyz1: torch.Tensor, xyz2: torch.Tensor) -> None:
    for name, x in (("xyz1", xyz1), ("xyz2", xyz2)):
        if x.dim() != 3 or x.shape[-1] != 3 or x.shape[1] == 0:
            raise ValueError(f"{name}: expected (b, n>0, 3), got {tuple(x.shape)}")
    if xyz1.shape[0] != xyz2.shape[0] or xyz1.device != xyz2.device:
        raise ValueError(f"xyz1 {tuple(xyz1.shape)} on {xyz1.device} and xyz2 "
                         f"{tuple(xyz2.shape)} on {xyz2.device} differ in batch or device")


def _exp_weight(level: float, d2: torch.Tensor) -> torch.Tensor:
    return torch.exp(level * d2)


def _level_deltas(xyz1: torch.Tensor, xyz2: torch.Tensor, weight=_exp_weight, delta_weight=None):
    """The level recurrence, streamed: yields ``(lo, d2, delta)`` for every
    level and row chunk ``[lo, lo + rows)`` of xyz1, where ``d2`` and
    ``delta`` are that chunk's (b, rows, m) tiles. The consumer reads a tile
    before the next is made; remain_l is updated after each yield.
    ``weight(level, d2)`` is w in the ratios and ``delta_weight`` (the same
    by default) w in delta: K6 takes them in other ways than ``exp``, and the
    tests run the recurrence with its ways."""
    delta_weight = delta_weight or weight
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = _capacities(n, m)
    chunk = n if b * n * m <= _FULL_PATH_MAX_ELEMS else _CHUNK
    starts = range(0, n, chunk)
    whole = _sq_dists(xyz1, xyz2) if chunk >= n else None

    def d2_tile(lo):
        return whole if whole is not None else _sq_dists(xyz1[:, lo : lo + chunk], xyz2)

    remain_l = torch.full((b, n), multi_l, dtype=torch.float32, device=xyz1.device)
    remain_r = torch.full((b, m), multi_r, dtype=torch.float32, device=xyz1.device)
    for level in _levels():
        ratio_l = torch.empty_like(remain_l)
        sumr = torch.zeros_like(remain_r)
        # ratio_l is row-local and sumr adds up over chunks, so one w tile
        # serves both
        for lo in starts:
            w = weight(level, d2_tile(lo))
            suml = 1e-9 + torch.bmm(w, remain_r[:, :, None])[..., 0]
            rl = remain_l[:, lo : lo + chunk] / suml
            ratio_l[:, lo : lo + chunk] = rl
            sumr += torch.bmm(w.transpose(1, 2), rl[:, :, None])[..., 0]
        sumr = sumr * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        for lo in starts:
            d2 = d2_tile(lo)
            w = delta_weight(level, d2)
            delta = w * ratio_l[:, lo : lo + chunk, None] * ratio_r[:, None, :]
            yield lo, d2, delta
            remain_l[:, lo : lo + chunk] = torch.clamp(
                remain_l[:, lo : lo + chunk] - delta.sum(2), min=0.0)


@torch.no_grad()
def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Transport plan (b, m, n) between xyz1 (b, n, 3) and xyz2 (b, m, 3).
    Not differentiable, like the reference op."""
    _check(xyz1, xyz2)
    xyz1, xyz2 = xyz1.detach().float(), xyz2.detach().float()
    b, n, _ = xyz1.shape
    match = torch.zeros((b, xyz2.shape[1], n), dtype=torch.float32, device=xyz1.device)
    for lo, _, delta in _level_deltas(xyz1, xyz2):
        match[:, :, lo : lo + delta.shape[1]] += delta.transpose(1, 2)
    return match


@torch.no_grad()
def _approx_match_cost_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, weight=_exp_weight,
                             delta_weight=None) -> torch.Tensor:
    """Plain version of K6: the chunked recurrence with the cost summed per
    level, Σ δ·√d², and no plan."""
    cost = torch.zeros(xyz1.shape[0], dtype=torch.float32, device=xyz1.device)
    for _, d2, delta in _level_deltas(xyz1, xyz2, weight, delta_weight):
        cost += torch.sum(delta * torch.sqrt(d2), dim=(1, 2))
    return cost


def _lam2(level: float) -> torch.Tensor:
    """λ·log2(e) rounded to float32, as the kernel's host code rounds it."""
    return torch.tensor(level * 1.4426950408889634, dtype=torch.float64).float()


def _kernel_weight(level: float, d2: torch.Tensor) -> torch.Tensor:
    """K6's weight of a pair at ``level``: 2^(λ·log2(e)·d²) with results
    under 2^-126 flushed to 0, as ``ex2.approx.ftz`` flushes them."""
    w = torch.exp2(d2 * _lam2(level))
    return torch.where(w < 2.0**-126, torch.zeros_like(w), w)


def _kernel_delta_weight(level: float, d2: torch.Tensor) -> torch.Tensor:
    """The weight in K6's delta: its fused row sweep ends level λ while it
    starts λ/4, and takes w_λ = (w_{λ/4}²)² from the one exponential; the
    level before λ = 0 takes its own, and λ = 0 none."""
    if level == 0.0:
        return torch.ones_like(d2)
    if level / 4.0 not in _levels():
        return _kernel_weight(level, d2)
    w2 = _kernel_weight(level / 4.0, d2) ** 2
    return w2 * w2


def _band_skips(boxes_a: torch.Tensor, boxes_b: torch.Tensor, level: float) -> torch.Tensor:
    """K6's skip rule: (b, ta, tb) bool, true where every pair of a point in
    box ``boxes_a[:, i]`` and a point in ``boxes_b[:, j]`` (each (b, t, 6) =
    [lo x y z, hi x y z]) has weight exactly 0 at ``level``. The kernel's
    own float32 operations, in its order."""
    if level == 0.0:
        return torch.zeros((boxes_a.shape[0], boxes_a.shape[1], boxes_b.shape[1]),
                           dtype=torch.bool, device=boxes_a.device)
    a, o = boxes_a[:, :, None, :], boxes_b[:, None, :, :]
    g = torch.clamp(torch.maximum(o[..., :3] - a[..., 3:], a[..., :3] - o[..., 3:]), min=0.0)
    gap2 = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]

    def r2(box):
        far = torch.maximum(box[..., :3].abs(), box[..., 3:].abs())
        return far[..., 0] * far[..., 0] + far[..., 1] * far[..., 1] + far[..., 2] * far[..., 2]

    safe = gap2 - _SLACK * (r2(a) + r2(o))
    return safe * -_lam2(level) > _ZERO_ARG


def _skipped_shares(xyz1_sorted: torch.Tensor, xyz2_sorted: torch.Tensor) -> list[float]:
    """Share of K6's (warp, tile) pairs of the row direction that the skip
    rule drops at each level."""
    own = _tile_boxes(xyz1_sorted, min(_WARP_TILE, xyz1_sorted.shape[1]))
    other = _tile_boxes(xyz2_sorted, min(_TILE, xyz2_sorted.shape[1]))
    return [float(_band_skips(own, other, level).float().mean()) for level in _levels()]


def _sorted_with_boxes(x: torch.Tensor):
    """What K6 works on, in plain PyTorch: the cloud in Morton order and the
    boxes of its tiles (the kernel takes the boxes itself)."""
    xs, _ = sort_by_morton_with_order(x)
    xs = xs.contiguous()
    return xs, _tile_boxes(xs, _TILE)


def _morton_sorted_pair(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Both clouds in Morton order, contiguous. Clouds of one size share one
    sort: its many small ops cost the host more than the card."""
    if xyz1.shape == xyz2.shape:
        both = sort_by_morton_with_order(torch.cat([xyz1, xyz2]))[0].contiguous()
        return both[: xyz1.shape[0]], both[xyz1.shape[0]:]
    return (sort_by_morton_with_order(xyz1)[0].contiguous(),
            sort_by_morton_with_order(xyz2)[0].contiguous())


def _approx_match_cost_kernel(xyz1: torch.Tensor, xyz2: torch.Tensor,
                              band_skip: bool = True) -> torch.Tensor:
    """K6's wrapper for float32 contiguous CUDA clouds: sorts, scratch, one
    launch. ``band_skip=False`` turns the skip rule off, for the tests that
    show it changes no bit of the cost."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = _capacities(n, m)
    x1s, x2s = _morton_sorted_pair(xyz1, xyz2)
    f32 = dict(dtype=torch.float32, device=xyz1.device)
    boxes1 = torch.empty((b, -(-n // _TILE), 6), **f32)  # the kernel fills them
    boxes2 = torch.empty((b, -(-m // _TILE), 6), **f32)
    # the walk over the other cloud's tiles is split over as many blocks as
    # give every SM _BLOCKS_PER_SM short blocks over the sweep, which evens
    # out how much each can skip
    blocks = b * -(-max(n, m) // _BLOCK_POINTS)
    parts = max(1, min(_MAX_PARTS, _BLOCKS_PER_SM * _sm_count(xyz1.device) // blocks,
                       -(-min(n, m) // _TILE)))
    part_sums = torch.empty((parts, max(3 * b * n, b * m)), **f32)
    remain_l, ratio_l, rowcost = (torch.empty((b, n), **f32) for _ in range(3))
    remain_r, ratio_r = (torch.empty((b, m), **f32) for _ in range(2))
    cost = torch.empty((b,), **f32)
    kernels.launch("emd_cost", xyz1.device, x1s, x2s, boxes1, boxes2, b, n, m, _TILE, parts,
                   multi_l, multi_r, remain_l, ratio_l, rowcost, remain_r, ratio_r, part_sums,
                   cost, int(band_skip))
    return cost


def approx_match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """``match_cost(xyz1, xyz2, approx_match(xyz1, xyz2))`` without the plan:
    (b,) costs, no gradient. K6 on the card, the plain recurrence on the CPU;
    the two differ in the order of fp32 sums and in a few units in the last
    place of each weight."""
    _check(xyz1, xyz2)
    for name, x in (("xyz1", xyz1), ("xyz2", xyz2)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 points, got {x.dtype}")
    xyz1 = xyz1.detach().contiguous()
    xyz2 = xyz2.detach().contiguous()
    if not xyz1.is_cuda:
        return _approx_match_cost_plain(xyz1, xyz2)
    return _approx_match_cost_kernel(xyz1, xyz2)


def _cost_grads(xyz1, xyz2, d2, match_t):
    """The reference's match_cost gradient for plan ``match_t`` (b, n, m):
    c = match·rsqrt(max(d², 1e−20)); g1 = (Σ_l c)·x1 − c·x2, g2 likewise."""
    c = match_t * torch.rsqrt(torch.clamp(d2, min=1e-20))
    g1 = c.sum(2)[..., None] * xyz1 - torch.bmm(c, xyz2)
    g2 = c.sum(1)[..., None] * xyz2 - torch.bmm(c.transpose(1, 2), xyz1)
    return g1, g2


class _MatchCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, match):
        d2 = _sq_dists(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, match)
        return torch.sum(torch.sqrt(d2) * match.transpose(1, 2), dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, match = ctx.saved_tensors
        g1, g2 = _cost_grads(xyz1, xyz2, _sq_dists(xyz1, xyz2), match.transpose(1, 2))
        gb = g[:, None, None]
        return gb * g1, gb * g2, None  # the plan gets no cotangent


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """Σ euclidean‖p1 − p2‖ · match -> (b,); match layout (b, m, n)."""
    _check(xyz1, xyz2)
    return _MatchCost.apply(xyz1.float(), xyz2.float(), match.detach())


class _AmcDiff(torch.autograd.Function):
    """Cost and gradient of match_cost(approx_match(...)) in one pass of the
    recurrence (``rfnet_tpu/ops/emd.py:_amc_diff``): both are linear in the
    plan, which is the sum of the per-level deltas, so the cost, the row and
    column sums of c = δ·rsqrt(max(d², 1e−20)) and the moments Σ c·x2,
    Σ cᵀ·x1 add up level by level. Saves only the two gradient fields."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        xyz1, xyz2 = xyz1.detach(), xyz2.detach()
        b = xyz1.shape[0]
        cost = torch.zeros(b, dtype=torch.float32, device=xyz1.device)
        row = torch.zeros(xyz1.shape[:2], dtype=torch.float32, device=xyz1.device)
        col = torch.zeros(xyz2.shape[:2], dtype=torch.float32, device=xyz1.device)
        p1, p2 = torch.zeros_like(xyz1), torch.zeros_like(xyz2)
        for _, d2, delta in _level_deltas(xyz1, xyz2):
            cost += torch.sum(delta * torch.sqrt(d2), dim=(1, 2))
            c = delta * torch.rsqrt(torch.clamp(d2, min=1e-20))
            row += c.sum(2)
            col += c.sum(1)
            p1 += torch.bmm(c, xyz2)
            p2 += torch.bmm(c.transpose(1, 2), xyz1)
        ctx.save_for_backward(row[..., None] * xyz1 - p1, col[..., None] * xyz2 - p2)
        return cost

    @staticmethod
    def backward(ctx, g):
        g1, g2 = ctx.saved_tensors
        gb = g[:, None, None]
        return gb * g1, gb * g2


def approx_match_cost_diff(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Differentiable ``match_cost(x1, x2, approx_match(x1, x2))``: (b,) costs.
    The fused single pass below the full-matrix cap; above it, the plan and
    the cost op composed."""
    _check(xyz1, xyz2)
    if xyz1.shape[0] * xyz1.shape[1] * xyz2.shape[1] > _FULL_PATH_MAX_ELEMS:
        return match_cost(xyz1, xyz2, approx_match(xyz1, xyz2))
    return _AmcDiff.apply(xyz1.float(), xyz2.float())

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
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels

# The whole (b, n, m) matrix is held while b·n·m stays below this many
# elements; above it the recurrence streams row chunks of _CHUNK.
_FULL_PATH_MAX_ELEMS = 160 * 1024 * 1024
_CHUNK = 512


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


def _level_deltas(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The level recurrence, streamed: yields ``(lo, d2, delta)`` for every
    level and row chunk ``[lo, lo + rows)`` of xyz1, where ``d2`` and
    ``delta`` are that chunk's (b, rows, m) tiles. The consumer reads a tile
    before the next is made; remain_l is updated after each yield."""
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
            w = torch.exp(level * d2_tile(lo))
            suml = 1e-9 + torch.bmm(w, remain_r[:, :, None])[..., 0]
            rl = remain_l[:, lo : lo + chunk] / suml
            ratio_l[:, lo : lo + chunk] = rl
            sumr += torch.bmm(w.transpose(1, 2), rl[:, :, None])[..., 0]
        sumr = sumr * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        for lo in starts:
            d2 = d2_tile(lo)
            delta = torch.exp(level * d2) * ratio_l[:, lo : lo + chunk, None] * ratio_r[:, None, :]
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
def _approx_match_cost_plain(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: the chunked recurrence with the cost summed per
    level, Σ δ·√d², and no plan."""
    cost = torch.zeros(xyz1.shape[0], dtype=torch.float32, device=xyz1.device)
    for _, d2, delta in _level_deltas(xyz1, xyz2):
        cost += torch.sum(delta * torch.sqrt(d2), dim=(1, 2))
    return cost


def approx_match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """``match_cost(xyz1, xyz2, approx_match(xyz1, xyz2))`` without the plan:
    (b,) costs, no gradient. K6 on the card, the plain recurrence on the CPU;
    the two differ only in the order of fp32 sums."""
    _check(xyz1, xyz2)
    xyz1 = xyz1.detach().float().contiguous()
    xyz2 = xyz2.detach().float().contiguous()
    if not xyz1.is_cuda:
        return _approx_match_cost_plain(xyz1, xyz2)
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multi_l, multi_r = _capacities(n, m)
    f32 = dict(dtype=torch.float32, device=xyz1.device)
    remain_l, ratio_l, rowcost = (torch.empty((b, n), **f32) for _ in range(3))
    remain_r, ratio_r = (torch.empty((b, m), **f32) for _ in range(2))
    cost = torch.empty((b,), **f32)
    kernels.launch("emd_cost", xyz1.device, xyz1, xyz2, b, n, m, multi_l, multi_r,
                   remain_l, ratio_l, rowcost, remain_r, ratio_r, cost)
    return cost


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

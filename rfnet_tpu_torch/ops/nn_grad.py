"""The chamfer backward's scatter (port of ``rfnet_tpu/ops/pallas/nn_grad.py``).

    nn_grad_scatter(x1_sorted (b,n,3), g (b,n), idx (b,n) int32, m)
        -> S_p (b,m,3) = Σ_{i: idx[i]=j} g[i]·x1[i],   S_w (b,m) = Σ g[i]

The chamfer backward folds these into ``d_x2[j] = −2·S_p[j] + 2·x2[j]·S_w[j]``.
A CUDA tensor goes through kernel K5 (``csrc/nn_grad.cu``), which does the
whole function itself, one block a cloud: it groups the queries by target in
shared memory (integer counters, a prefix sum, placement) and adds each run
in ascending query index, a lane for a short run, a warp for a long one, with
no load waiting for a sum. Nothing here sorts. The
function is bound by its bytes (20 a query, 16 a target); the kernel's time
goes into the grouping and into one block's latency a cloud. A CPU tensor
goes through :func:`_scatter_plain`, ``index_add_`` into zeros, which adds
the rows in the same order with the same rounding, so the two agree bit for
bit. Both are deterministic: the kernel's only atomics count integers.
"""

from __future__ import annotations

import functools

import torch

from rfnet_tpu_torch import kernels


# Most blocks one cloud's targets are split over (each block reads every index).
_MAX_PARTS = 4
# Longest run one lane sums alone: kShort of csrc/nn_grad.cu, which sizes the
# kernel's list of longer runs.
_SHORT = 8


def _block_scratch(n: int, m_part: int) -> int:
    """Ints of scratch one block of K5 indexes (``block_scratch`` of
    ``csrc/nn_grad.cu``, which refuses a smaller stride): the sorted queries
    of its long runs (n), the list of those runs (n / _SHORT + 1), and its
    counters and slots (m_part + n) for sizes that do not fit in a block's
    shared memory."""
    return 2 * n + m_part + n // _SHORT + 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch_shape(b: int, n: int, m: int, device: torch.device) -> tuple[int, int]:
    """``(parts, width)`` of K5's (b, parts, width) int32 scratch: as many
    blocks a cloud as fill the card, each with a range of the targets."""
    parts = max(1, min(_MAX_PARTS, _sm_count(device) // b, m))
    return parts, _block_scratch(n, -(-m // parts))


def index_add_rows(shape, idx: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """(b, k, c) updates added into rows ``idx`` (b, k) of zeros ``shape``
    (b, n, c), one row after the other in index order."""
    b, n, c = shape
    rows = (idx.long() + n * torch.arange(b, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros(b * n, c, dtype=updates.dtype, device=updates.device)
    return out.index_add_(0, rows, updates.reshape(-1, c)).reshape(b, n, c)


def _scatter_plain(x1: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, m: int):
    """Plain version of K5: one ``index_add_`` of the rows [g·x, g·y, g·z, g]."""
    src = torch.cat([g[..., None] * x1, g[..., None]], dim=-1)
    out = index_add_rows((x1.shape[0], m, 4), idx, src)
    return out[..., :3].contiguous(), out[..., 3].contiguous()


def nn_grad_scatter(x1_sorted: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, m: int):
    """K5's wrapper: ``(S_p (b,m,3), S_w (b,m))``; exact for any ``idx``."""
    if x1_sorted.dim() != 3 or x1_sorted.shape[-1] != 3 or x1_sorted.dtype != torch.float32:
        raise ValueError(f"x1: expected (b, n, 3) float32, got {tuple(x1_sorted.shape)}")
    b, n, _ = x1_sorted.shape
    if g.shape != (b, n) or idx.shape != (b, n) or g.dtype != torch.float32:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} / idx {tuple(idx.shape)} do not "
                         f"match x1 {tuple(x1_sorted.shape)}")
    if not (x1_sorted.device == g.device == idx.device):
        raise ValueError("x1, g and idx lie on different devices")
    if n == 0 or m <= 0:
        raise ValueError(f"empty scatter: n={n}, m={m}")
    x1 = x1_sorted.detach().contiguous()
    g = g.detach().contiguous()
    if not x1.is_cuda:
        return _scatter_plain(x1, g, idx, m)
    idx = idx.to(torch.int32).contiguous()
    sp = torch.empty((b, m, 3), dtype=torch.float32, device=x1.device)
    sw = torch.empty((b, m), dtype=torch.float32, device=x1.device)
    parts, width = _scratch_shape(b, n, m, x1.device)
    slots = torch.empty((b, parts, width), dtype=torch.int32, device=x1.device)
    kernels.launch("nn_grad", x1.device, x1, g, idx, b, n, m, parts, slots, width, sp, sw)
    return sp, sw

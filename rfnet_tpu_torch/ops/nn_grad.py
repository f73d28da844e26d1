"""The chamfer backward's scatter (port of ``rfnet_tpu/ops/pallas/nn_grad.py``).

    nn_grad_scatter(x1_sorted (b,n,3), g (b,n), idx (b,n) int32, m)
        -> S_p (b,m,3) = Σ_{i: idx[i]=j} g[i]·x1[i],   S_w (b,m) = Σ g[i]

The chamfer backward folds these into ``d_x2[j] = −2·S_p[j] + 2·x2[j]·S_w[j]``.
A CUDA tensor goes through kernel K5 (``csrc/nn_grad.cu``): a stable sort of
each row of ``idx`` groups the queries of each target in ascending query
index, and one thread a target sums them in that order. A CPU tensor goes
through :func:`_scatter_plain`, ``index_add_`` into zeros, which adds the
rows in the same order with the same rounding, so the two agree bit for bit.
Both are deterministic: no atomics.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels


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
    sidx, order = torch.sort(idx.to(torch.int32), dim=1, stable=True)
    sp = torch.empty((b, m, 3), dtype=torch.float32, device=x1.device)
    sw = torch.empty((b, m), dtype=torch.float32, device=x1.device)
    kernels.launch("nn_grad", x1.device, x1, g, sidx.contiguous(), order.contiguous(),
                   b, n, m, sp, sw)
    return sp, sw

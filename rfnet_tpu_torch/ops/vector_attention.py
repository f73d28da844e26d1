"""k-NN vector attention: SnowflakeNet's point transformer after its k-NN
(kernel K11, ``csrc/attn.cu``).

``vector_attention(pos, idx, query, key, value, mlps, packed)`` returns, for
each point i of each cloud and its neighbours j = ``idx[i]`` (the point
itself among them),

    Σ_j softmax_j(attn_mlp(q_i − k_j + pe_ij)) ⊙ (v_i + pe_ij),
    pe_ij = pos_mlp(p_i − p_j),

the softmax per channel over the neighbours, each MLP two 1×1 layers with a
ReLU between them and its BatchNorm folded into the first (:class:`AttnMLPs`).

CUDA tensors go through K11, one fused float32 kernel in which the (b, n,
k, c) pair tensors stay on chip. It is built for the published widths only
(k = 16 neighbours, 64 channels, the MLPs 3 → 64 → 64 and 64 → 256 → 64):
other widths on the card are an error, not a slower path, and so is a call
that autograd would record (K11 has no backward). It reads the weights as
one buffer laid out by :func:`pack`, which a caller makes once and passes as
``packed``. CPU tensors go through the plain version
:func:`_attention_plain`, the eager pair tensors of the published code,
which takes any widths. The two sum in another order, so they agree to
float32 rounding, not bit for bit. Each K11 launch adds its ``b·n·k``
pairs to the counter ``attn.pairs`` and one to ``attn.launches`` while a
profiler records (``tracing.py``); the plain version counts nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from rfnet_tpu_torch import kernels, tracing
from rfnet_tpu_torch.ops.fps import _sm_count
from rfnet_tpu_torch.ops.grouping import group_point

# the widths K11 is built for (csrc/attn.cu): neighbours, channels, the
# position MLP's and the attention MLP's hidden channels
ATTN_KERNEL_K, ATTN_KERNEL_DIM, ATTN_KERNEL_POS_HIDDEN, ATTN_KERNEL_HIDDEN = 16, 64, 64, 256
PACKED_FLOATS = 37_504  # csrc/attn.cu:kAttnWeights


class AttnMLPs(NamedTuple):
    """The position MLP (3 → P → D) and the attention MLP (D → H → D), each
    layer's weight ``(out, in)`` and bias; BatchNorm folded into each
    first layer."""

    pos_w1: torch.Tensor
    pos_b1: torch.Tensor
    pos_w2: torch.Tensor
    pos_b2: torch.Tensor
    attn_w1: torch.Tensor
    attn_b1: torch.Tensor
    attn_w2: torch.Tensor
    attn_b2: torch.Tensor


def pack(mlps: AttnMLPs) -> torch.Tensor:
    """The weights as K11 reads them, one float32 buffer on their device:
    ``pos_w1`` (P, 3), ``pos_b1``, ``pos_w2`` transposed (P, D), ``pos_b2``,
    ``attn_w1`` transposed (D, H), ``attn_b1``, ``attn_w2`` transposed (H,
    D), ``attn_b2``."""
    m = [t.detach() for t in mlps]
    parts = (m[0], m[1], m[2].t(), m[3], m[4].t(), m[5], m[6].t(), m[7])
    return torch.cat([p.reshape(-1) for p in parts])


def _attention_plain(pos, idx, query, key, value, mlps: AttnMLPs) -> torch.Tensor:
    """Plain version of K11: the pair tensors, eagerly, at any widths."""
    qk_rel = query[:, :, None, :] - group_point(key, idx)  # (b, n, k, dim)
    pos_rel = pos[:, :, None, :] - group_point(pos, idx)  # (b, n, k, 3)
    pe = F.linear(F.relu(F.linear(pos_rel, mlps.pos_w1, mlps.pos_b1), inplace=True),
                  mlps.pos_w2, mlps.pos_b2)
    hidden = F.relu(F.linear(qk_rel.add_(pe), mlps.attn_w1, mlps.attn_b1), inplace=True)
    attn = torch.softmax(F.linear(hidden, mlps.attn_w2, mlps.attn_b2), dim=2)
    return (attn * pe.add_(value[:, :, None, :])).sum(2)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte boundary (K11 reads float4s)."""
    x = x.detach().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _attention_launch(pos, idx, query, key, value, packed) -> torch.Tensor:
    b, n, _ = query.shape
    out = torch.empty((b, n, ATTN_KERNEL_DIM), dtype=torch.float32, device=query.device)
    kernels.launch("attn", query.device, pos.detach().contiguous(), idx.contiguous(),
                   _aligned(query), _aligned(key), _aligned(value), _aligned(packed), b, n,
                   _sm_count(query.device), out)
    tracing.count("attn.pairs", b * n * ATTN_KERNEL_K)
    tracing.count("attn.launches", 1)
    return out


def _check(pos, idx, query, key, value, mlps: AttnMLPs, packed) -> None:
    b, n = query.shape[:2]
    if pos.dim() != 3 or pos.shape != (b, n, 3):
        raise ValueError(f"pos: expected ({b}, {n}, 3), got {tuple(pos.shape)}")
    if idx.dim() != 3 or idx.shape[:2] != (b, n) or idx.dtype != torch.int32:
        raise ValueError(f"idx: expected ({b}, {n}, k) int32, got {tuple(idx.shape)} {idx.dtype}")
    for name, x in (("query", query), ("key", key), ("value", value)):
        if x.dim() != 3 or x.shape != query.shape:
            raise ValueError(f"{name}: expected {tuple(query.shape)}, got {tuple(x.shape)}")
    dim, hidden, pos_hidden = query.shape[2], mlps.attn_w1.shape[0], mlps.pos_w1.shape[0]
    want = AttnMLPs((pos_hidden, 3), (pos_hidden,), (dim, pos_hidden), (dim,), (hidden, dim),
                    (hidden,), (dim, hidden), (dim,))
    for name, x, shape in zip(AttnMLPs._fields, mlps, want):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(x.shape)}")
    tensors = (pos, query, key, value, *mlps) + (() if packed is None else (packed,))
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("pos, query, key, value and the weights must be float32")
    if any(x.device != query.device for x in tensors + (idx,)):
        raise ValueError("every tensor must be on the queries' device")
    if query.is_cuda:
        _check_kernel(idx, query, mlps, packed, (pos, query, key, value))


def _check_kernel(idx, query, mlps: AttnMLPs, packed, inputs) -> None:
    """Raises unless K11 can take the call: the widths it is built for, the
    weights packed, and no autograd graph to record through ``inputs`` or
    the weights."""
    widths = (idx.shape[2], query.shape[2], mlps.pos_w1.shape[0], mlps.attn_w1.shape[0])
    if widths != (ATTN_KERNEL_K, ATTN_KERNEL_DIM, ATTN_KERNEL_POS_HIDDEN, ATTN_KERNEL_HIDDEN):
        raise ValueError(f"(k, dim, pos hidden, hidden) = {widths}: K11 is built for "
                         f"({ATTN_KERNEL_K}, {ATTN_KERNEL_DIM}, {ATTN_KERNEL_POS_HIDDEN}, "
                         f"{ATTN_KERNEL_HIDDEN}) only")
    if packed is None or packed.shape != (PACKED_FLOATS,):
        got = None if packed is None else tuple(packed.shape)
        raise ValueError(f"packed: expected ({PACKED_FLOATS},) (see pack), got {got}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*inputs, *mlps)):
        raise ValueError("K11 has no backward: call it under torch.no_grad or "
                         "torch.inference_mode, or with no tensor that requires grad")


def vector_attention(pos: torch.Tensor, idx: torch.Tensor, query: torch.Tensor,
                     key: torch.Tensor, value: torch.Tensor, mlps: AttnMLPs,
                     packed: torch.Tensor | None = None) -> torch.Tensor:
    """(b, n, dim) attention of the (b, n, 3) points ``pos`` over their
    neighbours ``idx`` (b, n, k) int32 in [0, n), with the per-point
    projections ``query``, ``key`` and ``value`` (b, n, dim) float32 and the
    MLPs ``mlps``. On the card ``packed`` is :func:`pack` of ``mlps``, and
    autograd must be off or nothing require grad; the CPU reads neither."""
    _check(pos, idx, query, key, value, mlps, packed)
    if not query.is_cuda:
        return _attention_plain(pos, idx, query, key, value, mlps)
    return _attention_launch(pos, idx, query, key, value, packed)

"""Point-MLP primitives (port of ``rfnet_tpu/nn.py``).

The whole network is stacks of per-point dense layers over ``(b, npts, c)``
tensors (the reference's 1×1 convolutions). Init follows TF1's
``xavier_initializer``: uniform ±√(6/(fan_in+fan_out)), biases zero.
Parameters are drawn on the CPU from the ``torch.Generator`` the model
passes in, so the same seed gives the same weights on every device.

``StepDense`` keeps the reference's reuse quirk: recurrent steps share the
weight but each trains its own bias, stored as one ``(n_steps, ch)`` table.

Every layer takes a computation ``dtype`` (None = float32), as the JAX
package's ``nn.dense(dtype)`` does: input, weight and bias are cast to it,
as flax's ``promote_dtype`` casts them, and the output stays in it. The
parameters stay float32, so one ``state_dict`` serves both modes, and their
gradients come back float32 through the casts.

A layer's input is one tensor or a list of blocks, the columns of its input
in order, as ``torch.cat(blocks, -1)`` would join them. A block whose point
dimension is 1 while another block's is larger is the same vector for every
point of its cloud (a codeword, a state, a max-pooled feature): its columns
of the weight multiply it once a cloud, into a per-cloud term ``(b, 1,
out)`` added to the product of the per-point blocks, which alone are
multiplied at every point. That is W·[x; g] + c = (W_x·x + c) + W_g·g, the
same products summed in another order. Where every block has the same point
count they are joined and multiplied as one tensor.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from rfnet_tpu_torch import tracing

Blocks = torch.Tensor | Sequence[torch.Tensor]


def _xavier_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    fan_out, fan_in = weight.shape
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-lim, lim, generator=generator)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``. Eager ``x.to(dtype)`` of a tensor already in it
    returns ``x``, but a ``torch.export`` trace records it as two operators
    (a metadata check and the cast), which an exported forward of the
    float32 model would run at every layer: the cast is traced only where
    the dtype changes."""
    return x if x.dtype == dtype else x.to(dtype)


def _count(x: torch.Tensor, cloud_cols: int, out: int) -> None:
    """A layer call's multiply-adds at every point of its per-point input
    ``x``, and those over ``cloud_cols`` per-cloud columns that it did once
    a cloud instead (host counters, while a profiler records)."""
    if tracing.active():
        points = x.numel() // x.shape[-1]
        tracing.count("dense.macs_per_point", points * x.shape[-1] * out)
        tracing.count("dense.macs_per_cloud_saved", points * cloud_cols * out)


def _dense(x: Blocks, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``F.linear(cat(x, -1), weight, bias)`` in ``dtype``, each per-cloud
    block of ``x`` multiplied once a cloud into a per-cloud term ``(b, 1,
    out)``, added in place to the per-point product and its bias (module
    docstring)."""
    w, c = _cast(weight, dtype), _cast(bias, dtype)
    if not isinstance(x, torch.Tensor) and len({blk.shape[-2] for blk in x}) == 1:
        x = torch.cat(list(x), -1)
    if isinstance(x, torch.Tensor):
        x = _cast(x, dtype)
        _count(x, 0, w.shape[0])
        return F.linear(x, w, c)
    lo, cloud_cols, cloud = 0, 0, None
    points, spans = [], []  # per-point blocks, their weight columns (adjacent ones joined)
    for blk in x:
        ch = blk.shape[-1]
        if blk.shape[-2] == 1:  # (b, 1, ch) @ (ch, out) a cloud: one matrix-vector product
            wt = w[:, lo:lo + ch].t().expand(blk.shape[0], ch, w.shape[0])
            blk = _cast(blk, dtype)
            cloud = torch.bmm(blk, wt) if cloud is None else torch.baddbmm(cloud, blk, wt)
            cloud_cols += ch
        else:
            points.append(_cast(blk, dtype))
            if spans and spans[-1][1] == lo:
                spans[-1][1] = lo + ch
            else:
                spans.append([lo, lo + ch])
        lo += ch
    xp = points[0] if len(points) == 1 else torch.cat(points, -1)
    wp = torch.cat([w[:, a:z] for a, z in spans], 1) if len(spans) > 1 else w[:, slice(*spans[0])]
    _count(xp, cloud_cols, w.shape[0])
    return F.linear(xp, wp, c).add_(cloud)


class Dense(nn.Linear):
    """One per-point dense layer (the JAX ``dense``): xavier-uniform weight,
    zero bias, computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__(in_ch, out_ch)
        self.dtype = dtype or torch.float32
        _xavier_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """No-op: ``nn.Linear`` would draw from the global RNG; the
        constructor draws from the model's generator instead."""

    def forward(self, x: Blocks) -> torch.Tensor:
        return _dense(x, self.weight, self.bias, self.dtype)


class StepDense(nn.Module):
    """Dense layer with a SHARED weight and PER-STEP biases ``(n_steps, ch)``."""

    def __init__(self, in_ch: int, out_ch: int, n_steps: int,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch))
        self.bias = nn.Parameter(torch.zeros(n_steps, out_ch))
        _xavier_(self.weight, generator)

    def forward(self, x: Blocks, step: int) -> torch.Tensor:
        return _dense(x, self.weight, self.bias[step], self.dtype)


class PointMLP(nn.Module):
    """Stack of dense layers named ``l0, l1, …``; ReLU after each layer, the
    last one's activation given by ``last_act`` (None = linear).

    ``n_steps > 1`` makes every layer a :class:`StepDense`, and the call then
    takes the recurrent step index. The first layer takes the input as one
    tensor or a list of blocks (module docstring)."""

    def __init__(self, in_ch: int, features: tuple, last_act: Callable | None = F.relu,
                 n_steps: int = 1, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.n_steps = n_steps
        self.last_act = last_act
        self.n_layers = len(features)
        for i, ch in enumerate(features):
            layer = (
                StepDense(in_ch, ch, n_steps, generator, dtype) if n_steps > 1
                else Dense(in_ch, ch, generator, dtype)
            )
            self.add_module(f"l{i}", layer)
            in_ch = ch

    def forward(self, x: Blocks, step: int = 0) -> torch.Tensor:
        for i in range(self.n_layers):
            layer = getattr(self, f"l{i}")
            x = layer(x, step) if self.n_steps > 1 else layer(x)
            act = F.relu if i < self.n_layers - 1 else self.last_act
            if act is F.relu:  # the layer's own fresh output
                x = F.relu(x, inplace=True)
            elif act is not None:
                x = act(x)
        return x


def l2_regularizer(module: nn.Module, rate: float = 1e-5) -> torch.Tensor:
    """Σ rate·‖W‖²/2 over dense weights — the term the reference computes
    but never applies to its loss."""
    weights = [p for name, p in module.named_parameters() if name.endswith("weight")]
    if not weights:
        return torch.zeros(())
    return rate * 0.5 * sum(torch.sum(w * w) for w in weights)

"""Point-MLP primitives (port of ``rfnet_tpu/nn.py``).

The whole network is stacks of per-point dense layers over ``(b, npts, c)``
tensors (the reference's 1×1 convolutions). Init follows TF1's
``xavier_initializer``: uniform ±√(6/(fan_in+fan_out)), biases zero.
Parameters are drawn on the CPU from the ``torch.Generator`` the model
passes in, so the same seed gives the same weights on every device.

``StepDense`` keeps the reference's reuse quirk: recurrent steps share the
weight but each trains its own bias, stored as one ``(n_steps, ch)`` table.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch
from torch import nn
from torch.nn import functional as F


def _xavier_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    fan_out, fan_in = weight.shape
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-lim, lim, generator=generator)


class Dense(nn.Linear):
    """One per-point dense layer (the JAX ``dense``): xavier-uniform weight,
    zero bias."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator | None = None):
        super().__init__(in_ch, out_ch)
        _xavier_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def reset_parameters(self) -> None:
        """No-op: ``nn.Linear`` would draw from the global RNG; the
        constructor draws from the model's generator instead."""


class StepDense(nn.Module):
    """Dense layer with a SHARED weight and PER-STEP biases ``(n_steps, ch)``."""

    def __init__(self, in_ch: int, out_ch: int, n_steps: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch))
        self.bias = nn.Parameter(torch.zeros(n_steps, out_ch))
        _xavier_(self.weight, generator)

    def forward(self, x: torch.Tensor, step: int) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias[step])


class PointMLP(nn.Module):
    """Stack of dense layers named ``l0, l1, …``; ReLU after each layer, the
    last one's activation given by ``last_act`` (None = linear).

    ``n_steps > 1`` makes every layer a :class:`StepDense`, and the call then
    takes the recurrent step index."""

    def __init__(self, in_ch: int, features: tuple, last_act: Callable | None = F.relu,
                 n_steps: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.n_steps = n_steps
        self.last_act = last_act
        self.n_layers = len(features)
        for i, ch in enumerate(features):
            layer = (
                StepDense(in_ch, ch, n_steps, generator) if n_steps > 1
                else Dense(in_ch, ch, generator)
            )
            self.add_module(f"l{i}", layer)
            in_ch = ch

    def forward(self, x: torch.Tensor, step: int = 0) -> torch.Tensor:
        for i in range(self.n_layers):
            layer = getattr(self, f"l{i}")
            x = layer(x, step) if self.n_steps > 1 else layer(x)
            act = F.relu if i < self.n_layers - 1 else self.last_act
            if act is not None:
                x = act(x)
        return x


def l2_regularizer(module: nn.Module, rate: float = 1e-5) -> torch.Tensor:
    """Σ rate·‖W‖²/2 over dense weights — the term the reference computes
    but never applies to its loss."""
    weights = [p for name, p in module.named_parameters() if name.endswith("weight")]
    if not weights:
        return torch.zeros(())
    return rate * 0.5 * sum(torch.sum(w * w) for w in weights)

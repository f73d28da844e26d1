"""Three-nearest-neighbour search and inverse-distance interpolation (port of
``rfnet_tpu/ops/interpolate.py``). Plain PyTorch on both devices.

* ``three_nn`` returns the three least SQUARED distances in ascending order
  with their indices, the lower index first among equal distances; it has no
  gradient.
* ``three_interpolate``'s gradient goes to ``points`` only: the reference's
  registered gradient stops at ``idx`` and ``weight``, so the weight's
  gradient is exactly zero.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch.ops.grouping import _first_k_smallest, _pairwise_sq, group_point
from rfnet_tpu_torch.ops.nn_grad import index_add_rows


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """(b, n, 3) unknown, (b, m, 3) known -> dist (b, n, 3) squared, idx int32."""
    return _first_k_smallest(_pairwise_sq(xyz2.detach(), xyz1.detach()), 3)


class _ThreeInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx, weight):
        ctx.save_for_backward(idx, weight)
        ctx.points_shape = points.shape
        return (group_point(points, idx) * weight[..., None]).sum(dim=2)

    @staticmethod
    def backward(ctx, g):
        # the reference's gradient kernel scatter-adds w·g into the source
        # points and stops at idx and weight
        idx, weight = ctx.saved_tensors
        b, n, k = idx.shape
        upd = weight[..., None] * g[:, :, None, :]  # (b, n, 3, c)
        d_points = index_add_rows(ctx.points_shape, idx.reshape(b, n * k),
                                  upd.reshape(b, n * k, -1))
        return d_points, None, torch.zeros_like(weight)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor):
    """Weighted gather: out[b, i] = Σ_k weight[b, i, k] · points[b, idx[b, i, k]].

    points (b, m, c), idx (b, n, 3), weight (b, n, 3) -> (b, n, c)."""
    return _ThreeInterpolate.apply(points, idx, weight)

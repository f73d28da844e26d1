"""Loss zoo, schedules and the composite training objective.

Port of ``rfnet_tpu/losses.py`` (the reference's ``vv_recon.py:365-500``):

* ``chamfer_big`` = ½(mean√dist1 + mean√dist2), the mean-of-roots CD;
* ``fidelity_loss`` = one-sided mean√dist, partial → output;
* ``emd_func`` = radius-normalised EMD of the auction's assignment;
* ``earth_mover`` = approx-EMD cost / num_points (train path, with
  gradient); ``earth_mover_eval`` the same value with no gradient (K6);
* ``re_chamfer`` = CD over 8 contiguous equal index slices, folded into the
  batch axis;
* ``zero_groupnear`` = relu(mean‖decode offsets‖² − 0.4·mean NN-dist²);
* ``total_loss`` with the reference's weights and schedules.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rfnet_tpu_torch.ops.auction import auction_match
from rfnet_tpu_torch.ops.chamfer import (
    _sqrt_rn,
    chamfer_means,
    chamfer_means_pair,
    nearest_neighbor,
    nn_distance,
)
from rfnet_tpu_torch.ops.emd import approx_match_cost, approx_match_cost_diff
from rfnet_tpu_torch.ops.fps import gather_point


class _SafeSqrt(torch.autograd.Function):
    """Forward-exact sqrt whose derivative is capped at 1/(2·1e-7).

    Autograd forms the gradient of √(‖a−b‖²) as 2(a−b) × 1/(2√d²), which is
    0 × inf = NaN where the squared distance is exactly 0 (the distance scans
    clamp tiny negatives to 0); capping the sqrt's derivative keeps the
    composite the right unit vector and the forward untouched. The root is
    the correctly rounded one on every device (``ops/chamfer.py:_sqrt_rn``),
    so ``chamfer_big`` and ``fidelity_loss`` do not differ between the card
    and the CPU by the CPU root's stray ulp."""

    @staticmethod
    def forward(ctx, x):
        y = _sqrt_rn(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (2.0 * torch.clamp(y, min=1e-7))


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return _SafeSqrt.apply(x)


def chamfer_big(pcd1: torch.Tensor, pcd2: torch.Tensor):
    """Symmetric mean-√ Chamfer distance; also returns idx1."""
    dist1, idx1, dist2, _ = nn_distance(pcd1, pcd2)
    return (_safe_sqrt(dist1).mean() + _safe_sqrt(dist2).mean()) / 2.0, idx1


def fidelity_loss(pcd1: torch.Tensor, pcd2: torch.Tensor) -> torch.Tensor:
    """One-sided mean-√ NN distance pcd1 → pcd2."""
    dist1, _, _, _ = nn_distance(pcd1, pcd2)
    return _safe_sqrt(dist1).mean()


def _equal_sizes(pcd1: torch.Tensor, pcd2: torch.Tensor) -> None:
    if pcd1.shape[1] != pcd2.shape[1]:
        raise ValueError(f"earth_mover requires equal sizes, got {pcd1.shape[1]} "
                         f"and {pcd2.shape[1]}")


def earth_mover(pcd1: torch.Tensor, pcd2: torch.Tensor) -> torch.Tensor:
    """Approx-EMD cost per point, meaned over the batch; differentiable."""
    _equal_sizes(pcd1, pcd2)
    return torch.mean(approx_match_cost_diff(pcd1, pcd2) / float(pcd1.shape[1]))


def earth_mover_eval(pcd1: torch.Tensor, pcd2: torch.Tensor) -> torch.Tensor:
    """`earth_mover` for no-gradient contexts, through the plan-free cost."""
    _equal_sizes(pcd1, pcd2)
    return torch.mean(approx_match_cost(pcd1, pcd2) / float(pcd1.shape[1]))


def emd_func(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Radius-normalised EMD of the auction's one-to-one assignment. Off the
    train and eval paths, as in the reference."""
    matchl, _ = auction_match(pred, gt)
    matched = gather_point(gt, matchl)
    dist = _sqrt_rn(torch.sum((pred - matched) ** 2, dim=-1)).mean(dim=-1)
    cens = pred.mean(dim=1, keepdim=True)
    radius = _sqrt_rn(torch.sum((pred - cens) ** 2, dim=-1).amax(dim=-1))
    return torch.mean(dist / radius)


def re_chamfer(gt: torch.Tensor, pred: torch.Tensor, part: int = 8) -> torch.Tensor:
    """CD averaged over `part` contiguous 1/part index slices. The slices are
    equal-size sub-problems, so they fold into the batch axis: one
    (b·part, n/part)² call, whose global mean equals the average of the
    per-slice means."""
    b, n, _ = gt.shape
    interval = n // part
    used = part * interval
    gs = gt[:, :used].reshape(b * part, interval, 3)
    ps = pred[:, :used].reshape(b * part, interval, 3)
    m1, m2 = chamfer_means(ps, gs)
    return (m1 + m2) / 2.0


def groupin_near(ptmat: torch.Tensor) -> torch.Tensor:
    """Mean squared decode-offset magnitude."""
    return torch.mean(torch.sum(ptmat**2, dim=-1))


def zero_groupnear(ptcens: torch.Tensor, rawpts: torch.Tensor, outmat: torch.Tensor,
                   mesh=None):
    """Hinge density regulariser: decode offsets must stay below 0.4× the
    mean NN gap of the ground-truth pyramids (both constants of the loss, so
    the one-sided scan carries no gradient).

    With a ``mesh`` (a :class:`~rfnet_tpu_torch.parallel.Mesh`) each rank
    holds its rows of the global batch, and the hinge is taken on the two
    GLOBAL means (all-reduced, detached): the value is the global one on
    every rank, and each rank's term carries its local gradient times the
    global hinge's indicator, so the mean of the ranks' gradients is the
    global batch's. A relu of each rank's own means would not be."""
    dist2, _ = nearest_neighbor(rawpts, ptcens)
    near = groupin_near(outmat)
    if mesh is None:
        return torch.relu(near - 0.4 * dist2.mean())
    near_g, gap_g = mesh.mean(torch.stack([near.detach().float(), dist2.mean()]))
    hinge = near_g - 0.4 * gap_g
    return torch.relu(hinge) + (hinge > 0).to(hinge.dtype) * (near - near.detach())


# ---------------------------------------------------------------------------
# Training schedules (vv_recon.py:479-482)
# ---------------------------------------------------------------------------


def piecewise_constant(step: int, boundaries, values) -> float:
    # TF's tf.train.piecewise_constant keeps the EARLIER value through
    # step <= boundary, hence strict >
    return values[sum(step > b for b in boundaries)]


def learning_rate(step: int, scale: float = 1.0) -> float:
    """Adam LR: 5e-4 → 1e-5 over [50k, 100k, 150k, 200k]; ``scale``
    compresses the boundaries (values untouched; 1 = the reference)."""
    return piecewise_constant(
        step, [b * scale for b in (50_000, 100_000, 150_000, 200_000)],
        [0.0005, 0.0002, 0.0002, 0.0001, 0.00001],
    )


def decfactor_weight(step: int, scale: float = 1.0) -> float:
    """α₁ penalty weight: 0.01 → 0.001 at 150k, boundaries scaled likewise."""
    return piecewise_constant(step, [50_000 * scale, 150_000 * scale], [0.01, 0.01, 0.001])


class LossBreakdown(NamedTuple):
    """Every printed diagnostic of the reference train loop."""

    total: torch.Tensor
    cd1_emd: torch.Tensor  # earth_mover(gt1, points1_pre)
    cd2_emd: torch.Tensor  # earth_mover(gt2, points2_pre)
    cd3: torch.Tensor  # chamfer_big(gt, out3)
    cd4: torch.Tensor  # chamfer_big(gt, out4)
    recd3: torch.Tensor
    moveloss: torch.Tensor
    loss_d1: torch.Tensor
    loss_d2: torch.Tensor
    loss_dec: torch.Tensor


def total_loss(outputs, gt, gt1, gt2, step: int, schedule_scale: float = 1.0,
               mesh=None) -> LossBreakdown:
    """The composite objective; gt1/gt2 are the 64/1024-point FPS pyramids
    of gt, computed by the train step. With a ``mesh``, this rank's terms
    over its rows of the global batch: every term but ``zero_groupnear``'s
    is a mean over equal-size rows, so the ranks' mean of each is the
    global batch's."""
    cd1 = earth_mover(gt1, outputs.points1_pre)
    cd2 = earth_mover(gt2, outputs.points2_pre)
    m3a, m3b, m4a, m4b = chamfer_means_pair(gt, outputs.out3, outputs.out4)
    cd3 = (m3a + m3b) / 2.0
    cd4 = (m4a + m4b) / 2.0
    recd3 = re_chamfer(gt, outputs.out3, part=8)
    moveloss = torch.mean(torch.sum(outputs.final_move**2, dim=-1))
    loss = 0.2 * (cd1 + cd2) + cd3 + cd4 + 0.2 * recd3 + 0.1 * moveloss
    loss_d1 = 0.05 * zero_groupnear(gt1, gt2, outputs.moves1, mesh)
    loss_d2 = 0.05 * zero_groupnear(gt2, gt, outputs.moves2, mesh)
    loss_dec = torch.sum(outputs.decfactor_sq)
    alpha1 = decfactor_weight(step, schedule_scale)
    loss = loss + loss_d1 + loss_d2 + alpha1 * loss_dec
    return LossBreakdown(
        total=loss, cd1_emd=cd1, cd2_emd=cd2, cd3=cd3, cd4=cd4, recd3=recd3,
        moveloss=moveloss, loss_d1=loss_d1, loss_d2=loss_d2, loss_dec=loss_dec,
    )

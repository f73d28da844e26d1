"""Plain PyTorch training objective and Adam steps of RFNet.

The reference's ``vv_recon.py`` loss (its lines 365-500): the pyramid EMDs
of the pre-merge points against the ground truth's FPS pyramids, the
chamfer distances of the last two outputs, the sliced chamfer, the final
move, the two density hinges and the decline factors, with the learning
rate and α₁ schedules. Imports nothing of the program.

* Chamfer: each point's nearest neighbour by brute force, without
  gradient; the distance recomputed from the neighbour's coordinates with
  gradient, and its square root's derivative capped at 1/(2·1e-7), so a
  point that sits on its neighbour gets a zero gradient and not NaN.
* Approx-EMD: the transport plan of the multiscale soft matching (the
  reference's ``approx_match`` recurrence, levels λ = −4^j for j = 7 … −1,
  then 0), without gradient; the cost Σ plan·‖p1 − p2‖ with gradient, the
  plan held constant as the reference's ``match_cost`` holds it.
* Adam at b1 0.9, b2 0.999, eps 1e-8 (``torch.optim.Adam``, one tensor at
  a time), the learning rate of the updates done so far.
"""

from __future__ import annotations

import torch

from .rfnet import Net, fps, gather, matmul, nearest


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (2.0 * torch.clamp(y, min=1e-7))


def _nn_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance of each point of ``a`` to its nearest in ``b``, with
    gradient in both clouds through the (constant) neighbour choice."""
    _, idx = nearest(a.detach(), b.detach())
    return ((a - gather(b, idx)) ** 2).sum(-1)


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """½(mean √d(a → b) + mean √d(b → a)) over the batch's points."""
    return (_SafeSqrt.apply(_nn_dist(a, b)).mean() + _SafeSqrt.apply(_nn_dist(b, a)).mean()) / 2


def re_chamfer(gt: torch.Tensor, pred: torch.Tensor, part: int = 8) -> torch.Tensor:
    """Chamfer averaged over ``part`` contiguous equal slices of the points."""
    b, n, _ = gt.shape
    k = n // part
    return chamfer(pred[:, :part * k].reshape(b * part, k, 3), gt[:, :part * k].reshape(b * part, k, 3))


def _levels() -> list[float]:
    return [-(4.0 ** j) for j in range(7, -2, -1)] + [0.0]


@torch.no_grad()
def approx_match(x1: torch.Tensor, x2: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """The approximate transport plan (b, n, m) between x1 (b, n, 3) and x2
    (b, m, 3): at each level λ, weights exp(λ·d²) spread the remaining mass
    of both sides in proportion, then the matched mass leaves both sides."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    multi_l, multi_r = (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)
    s1 = (x1 * x1).sum(-1)
    s2 = (x2 * x2).sum(-1)
    d2 = torch.clamp(s1[:, :, None] + s2[:, None, :]
                     - 2.0 * matmul(x1, x2.transpose(1, 2), precision), min=0.0)
    remain_l = torch.full((b, n), multi_l, dtype=x1.dtype, device=x1.device)
    remain_r = torch.full((b, m), multi_r, dtype=x1.dtype, device=x1.device)
    plan = torch.zeros((b, n, m), dtype=x1.dtype, device=x1.device)
    for level in _levels():
        w = torch.exp(level * d2)
        ratio_l = remain_l / (1e-9 + matmul(w, remain_r[:, :, None], precision)[..., 0])
        sumr = matmul(w.transpose(1, 2), ratio_l[:, :, None], precision)[..., 0] * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        delta = w * ratio_l[:, :, None] * ratio_r[:, None, :]
        plan += delta
        remain_l = torch.clamp(remain_l - delta.sum(2), min=0.0)
    return plan


def earth_mover(x1: torch.Tensor, x2: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Mean over the batch of Σ plan·‖x1 − x2‖ / n."""
    plan = approx_match(x1.detach(), x2.detach(), precision)
    d2 = sum((x1[:, :, None, c] - x2[:, None, :, c]) ** 2 for c in range(3))
    cost = (torch.sqrt(torch.clamp(d2, min=1e-20)) * plan).sum((1, 2))
    return (cost / x1.shape[1]).mean()


def zero_groupnear(cens: torch.Tensor, raw: torch.Tensor, moves: torch.Tensor) -> torch.Tensor:
    """relu(mean ‖move‖² − 0.4 · mean nearest squared gap raw → cens)."""
    gap, _ = nearest(raw, cens)
    return torch.relu((moves ** 2).sum(-1).mean() - 0.4 * gap.mean())


def _piecewise(step: int, bounds, values) -> float:
    return values[sum(step > x for x in bounds)]


def learning_rate(step: int) -> float:
    return _piecewise(step, (50_000, 100_000, 150_000, 200_000),
                      (0.0005, 0.0002, 0.0002, 0.0001, 0.00001))


def alpha1(step: int) -> float:
    return _piecewise(step, (50_000, 150_000), (0.01, 0.01, 0.001))


def total_loss(out: dict, gt, gt1, gt2, step: int, precision: str = "fp32") -> torch.Tensor:
    loss = (0.2 * (earth_mover(gt1, out["points1_pre"], precision)
                   + earth_mover(gt2, out["points2_pre"], precision))
            + chamfer(gt, out["out3"]) + chamfer(gt, out["out4"])
            + 0.2 * re_chamfer(gt, out["out3"])
            + 0.1 * (out["final_move"] ** 2).sum(-1).mean())
    loss = loss + 0.05 * zero_groupnear(gt1, gt2, out["moves1"])
    loss = loss + 0.05 * zero_groupnear(gt2, gt, out["moves2"])
    return loss + alpha1(step) * out["decfactor_sq"].sum()


class Trainer:
    """Adam steps of the reference network from ``params`` (flax paths),
    the schedule starting at ``step``."""

    def __init__(self, params: dict[str, torch.Tensor], step: int, precision: str = "fp32"):
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.net = Net(self.params, precision)
        self.precision = precision
        self.step_count = step
        self.opt = torch.optim.Adam(list(self.params.values()), lr=learning_rate(step),
                                    betas=(0.9, 0.999), eps=1e-8, foreach=False)

    def step(self, partial: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """One step on a batch; returns the loss (detached). The parameters'
        ``.grad`` hold the step's gradients afterwards."""
        s = self.net.n_seed
        gt1 = gather(gt, fps(gt, 2 * s))
        gt2 = gather(gt, fps(gt, 2 * s * self.net.up_ratio))
        self.opt.zero_grad(set_to_none=True)
        loss = total_loss(self.net(partial), gt, gt1, gt2, self.step_count, self.precision)
        loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = learning_rate(self.step_count)
        self.opt.step()
        self.step_count += 1
        return loss.detach()

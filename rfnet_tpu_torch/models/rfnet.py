"""RFNet — Recurrent Forward Network for dense point-cloud completion.

Port of ``rfnet_tpu/models/rfnet.py``: 3 recurrent steps of encode →
decode/upsample ×16 → merge-with-input → refine, growing a partial
3000-point cloud into a 64 → 1024 → 16384-point completion pyramid.

Module and parameter names follow the flax tree (``cell/state_mlp/l0`` …),
so ``compat.convert`` maps one onto the other by renaming alone. Weight
sharing is the reference's:
  * ``cell`` is one module applied at all 3 steps and ``decode_cell`` one
    applied at steps 2 and 3; their weights are shared, their biases are
    per step (:class:`~rfnet_tpu_torch.nn.StepDense` tables);
  * the ``recover*`` and ``refine_layer*`` modules are per step;
  * codewords are residual: code2 = code1 + Δ, code3 = code2 + Δ.

All tensors are channels-last ``(b, npts, c)``. FPS runs through kernel K1
and each merge's nearest-neighbour scan through kernel K2 when the input is
on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from rfnet_tpu_torch.nn import Dense, PointMLP, StepDense
from rfnet_tpu_torch.ops.chamfer import nearest_neighbor_coords
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point


def _bcast(x: torch.Tensor, n: int) -> torch.Tensor:
    """(b, 1, c) -> (b, n, c)."""
    return x.expand(x.shape[0], n, x.shape[-1])


class GlobalMLP(nn.Module):
    """Per-point MLP + max-pool codeword (``global_mlp``)."""

    def __init__(self, in_ch: int, features: tuple, g: torch.Generator):
        super().__init__()
        self.mlp = PointMLP(in_ch, features, generator=g)

    def forward(self, pts):
        return torch.amax(self.mlp(pts), dim=1, keepdim=True)  # (b, 1, c)


class EncodeCell(nn.Module):
    """The shared RNN cell: (points, state (b,1,S)) -> (code, new_state)."""

    def __init__(self, in_ch: int, state_len: int, n_steps: int, g: torch.Generator,
                 mlp=(256, 384), mlpout=(256, 256)):
        super().__init__()
        self.state_mlp = PointMLP(in_ch + state_len, mlp, n_steps=n_steps, generator=g)
        self.state_end = StepDense(mlp[-1], state_len, n_steps, g)
        self.code_mlp = PointMLP(state_len, mlpout, n_steps=n_steps, generator=g)

    def forward(self, pts, state, step: int):
        x = torch.cat([pts, _bcast(state, pts.shape[1])], -1)
        x = F.relu(self.state_end(self.state_mlp(x, step), step))
        new_state = torch.amax(x, dim=1, keepdim=True)
        return self.code_mlp(new_state, step), new_state


class RecoverCell(nn.Module):
    """Re-attends the codeword to the point set; linear final projection."""

    def __init__(self, code_ch: int, g: torch.Generator, mlp2=(256, 256)):
        super().__init__()
        self.mlp = PointMLP(code_ch + 3, mlp2, generator=g)
        self.out = Dense(mlp2[-1], mlp2[-1], g)

    def forward(self, code, pts):
        x = self.mlp(torch.cat([_bcast(code, pts.shape[1]), pts], -1))
        return self.out(torch.amax(x, dim=1, keepdim=True))


class InitMoveLayer(nn.Module):
    """Moves FPS seeds by tanh-bounded offsets and emits their state."""

    def __init__(self, code_ch: int, g: torch.Generator, mlp=(256, 256, 256),
                 mlp1=(256, 128), mlp2=(256, 128, 64), state_len=128):
        super().__init__()
        t1 = 3 + code_ch
        self.mlp = PointMLP(t1, mlp, generator=g)
        self.featmlp = PointMLP(t1 + mlp[-1], mlp1, generator=g)
        self.featout = Dense(mlp1[-1], state_len, g)
        self.ptsmlp = PointMLP(t1 + mlp[-1], mlp2, generator=g)
        self.ptsout = Dense(mlp2[-1], 3, g)

    def forward(self, startpts, code):
        k = startpts.shape[1]
        t1 = torch.cat([startpts, _bcast(code, k)], -1)
        maxt = torch.amax(self.mlp(t1), dim=1, keepdim=True)
        t = torch.cat([t1, _bcast(maxt, k)], -1)
        feats = F.relu(self.featout(self.featmlp(t)))
        pts = torch.tanh(self.ptsout(self.ptsmlp(t)))
        return startpts + pts, feats


class InitDecodeLayer(nn.Module):
    """Generates ``ptnum`` points from a code via a learned 3×3 map + shift."""

    def __init__(self, code_ch: int, ptnum: int, g: torch.Generator, mlp=(256, 256),
                 mlp2=(256, 256), state_len=128):
        super().__init__()
        self.ptnum = ptnum
        self.input_trans = Dense(code_ch, 256, g)
        self.mlp = PointMLP(256, mlp, generator=g)
        self.points_out = Dense(mlp[-1], 3 * ptnum + 12, g)
        self.state_out = Dense(mlp[-1], ptnum * 16, g)
        self.state_mlp = PointMLP(16 + mlp[-1], mlp2, generator=g)
        self.state_outo = Dense(mlp2[-1], state_len, g)

    def forward(self, code):
        b, p = code.shape[0], self.ptnum
        x = self.mlp(F.relu(self.input_trans(code)))  # (b, 1, 256)
        raw = self.points_out(x)
        transmat = raw[..., -12:-3].reshape(b, 3, 3)
        movemat = raw[..., -3:].reshape(b, 1, 3)
        pts = torch.tanh(raw[..., : 3 * p]).reshape(b, p, 3)
        pts = torch.einsum("bnc,bcd->bnd", pts, transmat) + movemat
        st = F.relu(self.state_out(x)).reshape(b, p, 16)
        st = self.state_mlp(torch.cat([st, _bcast(x, p)], -1))
        return pts, F.relu(self.state_outo(st))


class DecodeCell(nn.Module):
    """Recurrent ×``up_ratio`` upsampler.

    Returns (points (b, up·n, 3), state (b, up·n, S), moves (b, n, up, 3))."""

    def __init__(self, code_ch: int, state_in: int, up_ratio: int, n_steps: int,
                 g: torch.Generator, mlp=(256, 256), mlp1=(128, 64), mlp2=(128, 128),
                 mlp_mask=(128, 128), mlp_expand=(128,), state_len=128):
        super().__init__()
        self.up_ratio = up_ratio
        self.state_len = state_len
        ns = n_steps
        self.mask_mlp = PointMLP(3 + code_ch, mlp_mask, n_steps=ns, generator=g)
        self.mask_out = StepDense(mlp_mask[-1], code_ch, ns, g)
        self.input_trans = StepDense(code_ch, 256, ns, g)
        self.state_trans = StepDense(state_in, 128, ns, g)
        self.mlp = PointMLP(256 + 128, mlp, n_steps=ns, generator=g)
        self.points_mlp = PointMLP(mlp[-1], mlp1, n_steps=ns, generator=g)
        self.points_out = StepDense(mlp1[-1], 3 * up_ratio, ns, g)
        self.state_mlp = PointMLP(mlp[-1] + code_ch, mlp2, n_steps=ns, generator=g)
        ch = mlp2[-1]
        for i in range(up_ratio):
            self.add_module(f"expand{i}_pre", PointMLP(ch, mlp_expand, n_steps=ns, generator=g))
            self.add_module(f"expand{i}", StepDense(mlp_expand[-1], state_len, ns, g))
            ch = state_len

    def forward(self, code, center, state, step: int):
        b, n, _ = center.shape
        code_n = _bcast(code, n)
        mask = self.mask_mlp(torch.cat([center, code_n], -1), step)
        mask = F.relu(self.mask_out(mask, step))
        info = F.relu(self.input_trans(mask * code, step))
        sinfo = F.relu(self.state_trans(state, step))
        x = self.mlp(torch.cat([info, sinfo], -1), step)
        p = self.points_mlp(x, step)
        p = torch.tanh(self.points_out(p, step))
        moves = p.reshape(b, n, self.up_ratio, 3)
        pts = (center[:, :, None, :] + moves).reshape(b, n * self.up_ratio, 3)
        cur = self.state_mlp(torch.cat([x, code_n], -1), step)
        branches = []
        for i in range(self.up_ratio):
            # branch i feeds branch i+1, as the reference chains them
            cur = getattr(self, f"expand{i}_pre")(cur, step)
            cur = F.leaky_relu(getattr(self, f"expand{i}")(cur, step), 0.01)
            branches.append(cur)
        smove = torch.stack(branches, dim=2)  # (b, n, up, S)
        new_state = (state[:, :, None, :] + smove).reshape(b, n * self.up_ratio, self.state_len)
        return pts, new_state, moves


class RefineLayer(nn.Module):
    """Residual tanh refinement of coords + state: (coords, state, move)."""

    def __init__(self, feat_ch: int, feat2_ch: int, g: torch.Generator,
                 mlp=(128, 64, 64), mlp2=(128, 128), mlpself=(128, 128)):
        super().__init__()
        self.self_mlp = PointMLP(3 + feat_ch, mlpself, generator=g)
        self.mlp = PointMLP(3 + mlpself[-1], mlp, generator=g)
        self.out = Dense(mlp[-1], 3, g)
        self.feat_mlp = PointMLP(3 + feat2_ch + feat_ch, mlp2, generator=g)
        self.feat_out = Dense(mlp2[-1], feat2_ch, g)

    def forward(self, pts, feat, feat2):
        n = pts.shape[1]
        feat_n = _bcast(feat, n)
        t = self.self_mlp(torch.cat([pts, feat_n], -1))
        maxt = torch.amax(t, dim=1, keepdim=True)
        t = self.mlp(torch.cat([pts, _bcast(maxt, n)], -1))
        move = torch.tanh(self.out(t))
        new_pts = pts + move
        s = self.feat_mlp(torch.cat([new_pts, feat2, feat_n], -1))
        s = torch.tanh(self.feat_out(s))
        return new_pts, feat2 + s, move


def merge_layer(rawpts, newpts, decfactor):
    """Pull each prediction toward its nearest input point with a learned
    Gaussian weight. The argmin carries no gradient; the distance is
    recomputed from the gathered neighbour, as the reference does."""
    _, nn_pts = nearest_neighbor_coords(newpts, rawpts)  # (b, np, 3), detached
    delta = nn_pts - newpts
    d2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    ratio = torch.exp(-d2 / (1e-8 + decfactor**2))
    return newpts + ratio * delta


@dataclass
class RFNetOutputs:
    """Structured outputs, field for field those of the JAX model."""

    out1: torch.Tensor  # (b, 2·n_seed, 3) step-1 coarse, post merge+refine
    out2: torch.Tensor  # (b, 2·n_seed·up, 3) step-2, post merge+refine
    out3: torch.Tensor  # (b, 2·n_seed·up², 3) step-3 raw decode output
    out4: torch.Tensor  # final, post merge+refine
    points1_pre: torch.Tensor  # step-1 points before the merge
    points2_pre: torch.Tensor  # step-2 points before the merge
    moves1: torch.Tensor  # (b, 2·n_seed, up, 3) decode offsets
    moves2: torch.Tensor  # (b, 2·n_seed·up, up, 3)
    final_move: torch.Tensor  # final refine move
    code1: torch.Tensor
    code2: torch.Tensor
    code3: torch.Tensor
    decfactor_sq: torch.Tensor  # (3,) squared decline factors


class RFNet(nn.Module):
    """The full 3-step completion pyramid.

    Parameters are drawn from ``generator`` (a CPU ``torch.Generator``; a
    fresh one seeded 0 when omitted); move the model with ``.to(device)``."""

    def __init__(self, state_len: int = 256, n_seed: int = 32, up_ratio: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.n_seed = n_seed
        code = 256  # width of every codeword (cell mlpout / recover mlp2)
        self.init_mlp = GlobalMLP(3, (64, 128, state_len), g)
        self.cell = EncodeCell(3, state_len, 3, g)
        self.recover1 = RecoverCell(code, g)
        self.recover2 = RecoverCell(code, g)
        self.recover3 = RecoverCell(code, g)
        self.init_move = InitMoveLayer(code, g)
        self.part_mlp = GlobalMLP(3, (64, 128, state_len), g)
        self.feat_trans = PointMLP(state_len + code, (256, 256), generator=g)
        self.init_cell = InitDecodeLayer(256, n_seed, g)
        self.decode_cell = DecodeCell(code, 128, up_ratio, 2, g)
        self.refine_layer1 = RefineLayer(code, 128, g)
        self.refine_layer2 = RefineLayer(code, 128, g)
        self.refine_layer_final = RefineLayer(code, 128, g)
        lim = math.sqrt(3.0)  # TF xavier on shape [1]: ±√(6/(1+1))
        for name in ("decline_factor0", "decline_factor1", "decline_factor"):
            p = nn.Parameter(torch.empty(1))
            with torch.no_grad():
                p.uniform_(-lim, lim, generator=g)
            self.register_parameter(name, p)

    def forward(self, pointcloud: torch.Tensor) -> RFNetOutputs:
        pc = pointcloud
        state = self.init_mlp(pc)

        # step 1: coarse = n_seed generated + n_seed moved FPS seeds
        code_raw, state = self.cell(pc, state, 0)
        code1 = self.recover1(code_raw, pc)
        seed = gather_point(pc, farthest_point_sample(self.n_seed, pc))
        moved, dstate_m = self.init_move(seed, code1)
        partfeat = self.part_mlp(torch.cat([pc, moved], dim=1))
        gen, dstate_g = self.init_cell(self.feat_trans(torch.cat([partfeat, code1], -1)))
        points1 = torch.cat([gen, moved], dim=1)  # generated first
        dstate = torch.cat([dstate_g, dstate_m], dim=1)
        points1_pre = points1
        points1 = merge_layer(pc, points1, self.decline_factor0)
        points1, dstate, _ = self.refine_layer1(points1, code1, dstate)

        # step 2: ×up_ratio
        pin = torch.cat([pc, points1], dim=1)
        code_raw, state = self.cell(pin, state, 1)
        code2 = code1 + self.recover2(code_raw, pin)
        points2, dstate, moves1 = self.decode_cell(code2, points1, dstate, 0)
        points2_pre = points2
        points2 = merge_layer(pc, points2, self.decline_factor1)
        points2, dstate, _ = self.refine_layer2(points2, code2, dstate)

        # step 3: ×up_ratio
        pin = torch.cat([pc, points2], dim=1)
        code_raw, state = self.cell(pin, state, 2)
        code3 = code2 + self.recover3(code_raw, pin)
        points3, dstate, moves2 = self.decode_cell(code3, points2, dstate, 1)
        points_final = merge_layer(pc, points3, self.decline_factor)
        points_final, _, final_move = self.refine_layer_final(points_final, code3, dstate)

        return RFNetOutputs(
            out1=points1, out2=points2, out3=points3, out4=points_final,
            points1_pre=points1_pre, points2_pre=points2_pre,
            moves1=moves1, moves2=moves2, final_move=final_move,
            code1=code1, code2=code2, code3=code3,
            decfactor_sq=torch.cat([
                self.decline_factor0**2, self.decline_factor1**2, self.decline_factor**2
            ]),
        )

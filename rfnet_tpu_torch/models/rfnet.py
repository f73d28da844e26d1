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

All tensors are channels-last ``(b, npts, c)``. A layer whose input joins
per-point columns with a per-cloud vector ``(b, 1, c)`` (a codeword, the
state, a max-pooled feature) takes them as a list of blocks and multiplies
the per-cloud one once a cloud (:mod:`rfnet_tpu_torch.nn`). FPS runs through
kernel K1 and each merge's nearest-neighbour scan through kernel K2 when the
input is on the card.

``RFNet(dtype=torch.bfloat16)`` computes the feature MLPs in bfloat16, as
the JAX ``RFNet(dtype=jnp.bfloat16)`` does, with the same dtype flow: a
layer's output stays in its dtype, a ``torch.cat`` or an add with float32
coordinates promotes to float32 as ``jnp.concatenate`` and ``+`` do (so every
coordinate that reaches a kernel is float32), and ``InitDecodeLayer``'s
generated seeds stay bfloat16 through the tanh, the ``transmat`` product and
``movemat``, until their concatenation with the moved seeds.
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
from rfnet_tpu_torch.tracing import span


class GlobalMLP(nn.Module):
    """Per-point MLP + max-pool codeword (``global_mlp``)."""

    def __init__(self, in_ch: int, features: tuple, g: torch.Generator, dtype=None):
        super().__init__()
        self.mlp = PointMLP(in_ch, features, generator=g, dtype=dtype)

    def forward(self, pts):
        return torch.amax(self.mlp(pts), dim=1, keepdim=True)  # (b, 1, c)


class EncodeCell(nn.Module):
    """The shared RNN cell: (points, state (b,1,S)) -> (code, new_state)."""

    def __init__(self, in_ch: int, state_len: int, n_steps: int, g: torch.Generator,
                 mlp=(256, 384), mlpout=(256, 256), dtype=None):
        super().__init__()
        self.state_mlp = PointMLP(in_ch + state_len, mlp, n_steps=n_steps, generator=g,
                                  dtype=dtype)
        self.state_end = StepDense(mlp[-1], state_len, n_steps, g, dtype)
        self.code_mlp = PointMLP(state_len, mlpout, n_steps=n_steps, generator=g, dtype=dtype)

    def forward(self, pts, state, step: int):
        x = F.relu(self.state_end(self.state_mlp([pts, state], step), step))
        new_state = torch.amax(x, dim=1, keepdim=True)
        return self.code_mlp(new_state, step), new_state


class RecoverCell(nn.Module):
    """Re-attends the codeword to the point set; linear final projection."""

    def __init__(self, code_ch: int, g: torch.Generator, mlp2=(256, 256), dtype=None):
        super().__init__()
        self.mlp = PointMLP(code_ch + 3, mlp2, generator=g, dtype=dtype)
        self.out = Dense(mlp2[-1], mlp2[-1], g, dtype)

    def forward(self, code, pts):
        x = self.mlp([code, pts])
        return self.out(torch.amax(x, dim=1, keepdim=True))


class InitMoveLayer(nn.Module):
    """Moves FPS seeds by tanh-bounded offsets and emits their state."""

    def __init__(self, code_ch: int, g: torch.Generator, mlp=(256, 256, 256),
                 mlp1=(256, 128), mlp2=(256, 128, 64), state_len=128, dtype=None):
        super().__init__()
        t1 = 3 + code_ch
        self.mlp = PointMLP(t1, mlp, generator=g, dtype=dtype)
        self.featmlp = PointMLP(t1 + mlp[-1], mlp1, generator=g, dtype=dtype)
        self.featout = Dense(mlp1[-1], state_len, g, dtype)
        self.ptsmlp = PointMLP(t1 + mlp[-1], mlp2, generator=g, dtype=dtype)
        self.ptsout = Dense(mlp2[-1], 3, g, dtype)

    def forward(self, startpts, code):
        maxt = torch.amax(self.mlp([startpts, code]), dim=1, keepdim=True)
        t = [startpts, code, maxt]
        feats = F.relu(self.featout(self.featmlp(t)))
        pts = torch.tanh(self.ptsout(self.ptsmlp(t)))
        return startpts + pts, feats


class InitDecodeLayer(nn.Module):
    """Generates ``ptnum`` points from a code via a learned 3×3 map + shift."""

    def __init__(self, code_ch: int, ptnum: int, g: torch.Generator, mlp=(256, 256),
                 mlp2=(256, 256), state_len=128, dtype=None):
        super().__init__()
        self.ptnum = ptnum
        self.input_trans = Dense(code_ch, 256, g, dtype)
        self.mlp = PointMLP(256, mlp, generator=g, dtype=dtype)
        self.points_out = Dense(mlp[-1], 3 * ptnum + 12, g, dtype)
        self.state_out = Dense(mlp[-1], ptnum * 16, g, dtype)
        self.state_mlp = PointMLP(16 + mlp[-1], mlp2, generator=g, dtype=dtype)
        self.state_outo = Dense(mlp2[-1], state_len, g, dtype)

    def forward(self, code):
        b, p = code.shape[0], self.ptnum
        x = self.mlp(F.relu(self.input_trans(code)))  # (b, 1, 256)
        raw = self.points_out(x)
        transmat = raw[..., -12:-3].reshape(b, 3, 3)
        movemat = raw[..., -3:].reshape(b, 1, 3)
        pts = torch.tanh(raw[..., : 3 * p]).reshape(b, p, 3)
        pts = torch.einsum("bnc,bcd->bnd", pts, transmat) + movemat
        st = F.relu(self.state_out(x)).reshape(b, p, 16)
        st = self.state_mlp([st, x])
        return pts, F.relu(self.state_outo(st))


class DecodeCell(nn.Module):
    """Recurrent ×``up_ratio`` upsampler.

    Returns (points (b, up·n, 3), state (b, up·n, S), moves (b, n, up, 3))."""

    def __init__(self, code_ch: int, state_in: int, up_ratio: int, n_steps: int,
                 g: torch.Generator, mlp=(256, 256), mlp1=(128, 64), mlp2=(128, 128),
                 mlp_mask=(128, 128), mlp_expand=(128,), state_len=128, dtype=None):
        super().__init__()
        self.up_ratio = up_ratio
        self.state_len = state_len
        ns, d = n_steps, dtype
        self.mask_mlp = PointMLP(3 + code_ch, mlp_mask, n_steps=ns, generator=g, dtype=d)
        self.mask_out = StepDense(mlp_mask[-1], code_ch, ns, g, d)
        self.input_trans = StepDense(code_ch, 256, ns, g, d)
        self.state_trans = StepDense(state_in, 128, ns, g, d)
        self.mlp = PointMLP(256 + 128, mlp, n_steps=ns, generator=g, dtype=d)
        self.points_mlp = PointMLP(mlp[-1], mlp1, n_steps=ns, generator=g, dtype=d)
        self.points_out = StepDense(mlp1[-1], 3 * up_ratio, ns, g, d)
        self.state_mlp = PointMLP(mlp[-1] + code_ch, mlp2, n_steps=ns, generator=g, dtype=d)
        ch = mlp2[-1]
        for i in range(up_ratio):
            self.add_module(f"expand{i}_pre",
                            PointMLP(ch, mlp_expand, n_steps=ns, generator=g, dtype=d))
            self.add_module(f"expand{i}", StepDense(mlp_expand[-1], state_len, ns, g, d))
            ch = state_len

    def forward(self, code, center, state, step: int):
        b, n, _ = center.shape
        mask = self.mask_mlp([center, code], step)
        mask = F.relu(self.mask_out(mask, step))
        info = F.relu(self.input_trans(mask * code, step))
        sinfo = F.relu(self.state_trans(state, step))
        x = self.mlp(torch.cat([info, sinfo], -1), step)
        p = self.points_mlp(x, step)
        p = torch.tanh(self.points_out(p, step))
        moves = p.reshape(b, n, self.up_ratio, 3)
        pts = (center[:, :, None, :] + moves).reshape(b, n * self.up_ratio, 3)
        cur = self.state_mlp([x, code], step)
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
                 mlp=(128, 64, 64), mlp2=(128, 128), mlpself=(128, 128), dtype=None):
        super().__init__()
        self.self_mlp = PointMLP(3 + feat_ch, mlpself, generator=g, dtype=dtype)
        self.mlp = PointMLP(3 + mlpself[-1], mlp, generator=g, dtype=dtype)
        self.out = Dense(mlp[-1], 3, g, dtype)
        self.feat_mlp = PointMLP(3 + feat2_ch + feat_ch, mlp2, generator=g, dtype=dtype)
        self.feat_out = Dense(mlp2[-1], feat2_ch, g, dtype)

    def forward(self, pts, feat, feat2):
        t = self.self_mlp([pts, feat])
        maxt = torch.amax(t, dim=1, keepdim=True)
        t = self.mlp([pts, maxt])
        move = torch.tanh(self.out(t))
        new_pts = pts + move
        s = self.feat_mlp([new_pts, feat2, feat])
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
    fresh one seeded 0 when omitted); move the model with ``.to(device)``.
    ``dtype`` is the feature MLPs' computation dtype (None = float32; the
    parameters stay float32 either way). ``input_points`` is the cloud size
    it is published for, to which the eval CLI resamples each partial;
    ``output_points`` is the size of ``out4``."""

    KEY = "init_cell.points_out.weight"  # a weight only RFNet has (models.network_of)

    def __init__(self, state_len: int = 256, n_seed: int = 32, up_ratio: int = 16,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None,
                 input_points: int = 3000):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.n_seed = n_seed
        self.input_points = input_points
        self.output_points = 2 * n_seed * up_ratio**2  # 2·n_seed points, ×up_ratio twice
        self.dtype = dtype or torch.float32
        d = dtype
        code = 256  # width of every codeword (cell mlpout / recover mlp2)
        self.init_mlp = GlobalMLP(3, (64, 128, state_len), g, d)
        self.cell = EncodeCell(3, state_len, 3, g, dtype=d)
        self.recover1 = RecoverCell(code, g, dtype=d)
        self.recover2 = RecoverCell(code, g, dtype=d)
        self.recover3 = RecoverCell(code, g, dtype=d)
        self.init_move = InitMoveLayer(code, g, dtype=d)
        self.part_mlp = GlobalMLP(3, (64, 128, state_len), g, d)
        self.feat_trans = PointMLP(state_len + code, (256, 256), generator=g, dtype=d)
        self.init_cell = InitDecodeLayer(256, n_seed, g, dtype=d)
        self.decode_cell = DecodeCell(code, 128, up_ratio, 2, g, dtype=d)
        self.refine_layer1 = RefineLayer(code, 128, g, dtype=d)
        self.refine_layer2 = RefineLayer(code, 128, g, dtype=d)
        self.refine_layer_final = RefineLayer(code, 128, g, dtype=d)
        lim = math.sqrt(3.0)  # TF xavier on shape [1]: ±√(6/(1+1))
        for name in ("decline_factor0", "decline_factor1", "decline_factor"):
            p = nn.Parameter(torch.empty(1))
            with torch.no_grad():
                p.uniform_(-lim, lim, generator=g)
            self.register_parameter(name, p)

    @classmethod
    def for_weights(cls, state_dict: dict, sizes: dict | None = None,
                    dtype: torch.dtype | None = None) -> RFNet:
        """An RFNet that ``state_dict`` loads into: its seed count and up
        ratio read off the ``points_out`` layers, its other sizes ``sizes``
        (as published where not given), its feature MLPs computing in
        ``dtype``."""
        n_seed = (state_dict["init_cell.points_out.weight"].shape[0] - 12) // 3
        up_ratio = state_dict["decode_cell.points_out.weight"].shape[0] // 3
        return cls(n_seed=n_seed, up_ratio=up_ratio, dtype=dtype, **(sizes or {}))

    def forward(self, pointcloud: torch.Tensor) -> RFNetOutputs:
        with span("rfnet.forward"):
            return self._forward(pointcloud)

    def _forward(self, pc: torch.Tensor) -> RFNetOutputs:
        # each step's four stages in a span of their own (tracing.py); they
        # launch all of the forward's kernels but decfactor_sq's at the end

        # step 1: coarse = n_seed generated + n_seed moved FPS seeds
        with span("rfnet.encode", step=1):
            state = self.init_mlp(pc)
            code_raw, state = self.cell(pc, state, 0)
            code1 = self.recover1(code_raw, pc)
        with span("rfnet.decode", step=1):
            seed = gather_point(pc, farthest_point_sample(self.n_seed, pc))
            moved, dstate_m = self.init_move(seed, code1)
            partfeat = self.part_mlp(torch.cat([pc, moved], dim=1))
            gen, dstate_g = self.init_cell(self.feat_trans(torch.cat([partfeat, code1], -1)))
            points1 = torch.cat([gen, moved], dim=1)  # generated first
            dstate = torch.cat([dstate_g, dstate_m], dim=1)
        points1_pre = points1
        with span("rfnet.merge", step=1):
            points1 = merge_layer(pc, points1, self.decline_factor0)
        with span("rfnet.refine", step=1):
            points1, dstate, _ = self.refine_layer1(points1, code1, dstate)

        # step 2: ×up_ratio
        with span("rfnet.encode", step=2):
            pin = torch.cat([pc, points1], dim=1)
            code_raw, state = self.cell(pin, state, 1)
            code2 = code1 + self.recover2(code_raw, pin)
        with span("rfnet.decode", step=2):
            points2, dstate, moves1 = self.decode_cell(code2, points1, dstate, 0)
        points2_pre = points2
        with span("rfnet.merge", step=2):
            points2 = merge_layer(pc, points2, self.decline_factor1)
        with span("rfnet.refine", step=2):
            points2, dstate, _ = self.refine_layer2(points2, code2, dstate)

        # step 3: ×up_ratio
        with span("rfnet.encode", step=3):
            pin = torch.cat([pc, points2], dim=1)
            code_raw, state = self.cell(pin, state, 2)
            code3 = code2 + self.recover3(code_raw, pin)
        with span("rfnet.decode", step=3):
            points3, dstate, moves2 = self.decode_cell(code3, points2, dstate, 1)
        with span("rfnet.merge", step=3):
            points_final = merge_layer(pc, points3, self.decline_factor)
        with span("rfnet.refine", step=3):
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

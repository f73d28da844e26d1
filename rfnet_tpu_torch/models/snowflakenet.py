"""SnowflakeNet: point cloud completion by snowflake point deconvolution
with skip-transformers (Xiang et al., ICCV 2021, arXiv:2108.04444; code
github.com/AllenXiangX/SnowflakeNet, ``models/model.py``,
``models/skip_transformer.py``, ``models/utils.py``).

Served, not trained: the port has its forward only. The published PCN
setting is the default: 2 048 input points, a 512-wide global feature, 256
generated seeds merged with the input into 512 points by FPS, then three
SPD stages that split each point into 1, 4 and 8 children: 512 → 512 →
2 048 → 16 384 points.

* The feature extractor: three set abstractions (FPS centres, the k = 16
  nearest points of each, ``cat(xyz_j − centre_i, points_j)`` through a
  point MLP and a max over the neighbours; the third groups all points) and
  a point transformer after each of the first two.
* The point transformer (:class:`Transformer`, and :class:`SkipTransformer`
  in every SPD) is k-NN vector attention over the k = 16 nearest points,
  the point itself included: ``a_ij = softmax_j(attn_mlp(q_i − k_j +
  pe_ij))`` per channel, with ``pe_ij = pos_mlp(p_i − p_j)``, and
  ``Σ_j a_ij ⊙ (v_i + pe_ij)`` (the published value path: the centre's
  value plus the embedding).
* The seed generator and each SPD stage are point MLPs on the per-point
  features with the global feature joined to every point, a transposed
  convolution that splits each point's feature into its children's, and a
  bounded offset ``tanh(·) / radius^i`` added to each child's parent.

Tensors are channels-last ``(b, points, channels)``, and every 1×1
convolution is a :class:`~rfnet_tpu_torch.nn.Dense` layer. Where a layer's
input joins the 512-wide global feature (or a max-pooled one) to every
point, it takes the blocks as a list and multiplies the per-cloud block
once a cloud (``nn._dense``). BatchNorm (only inside the transformers'
position and attention MLPs) serves with its running statistics, folded
into the convolution before it. FPS runs through kernel K1 and the k-NN
through K10 (``ops/knn.py``) on the card.

Module and parameter names follow the published modules (``feat_extractor.
sa_module_1.mlp_conv.0.conv.weight``, ``decoder.uppers.2.ps.weight``, …);
a 1×1 convolution's weight is stored as ``(out, in)`` (``load_state_dict``
also takes it with the published kernel dimensions, ``(out, in, 1)`` or
``(out, in, 1, 1)``), a transposed convolution's as published, ``(in, out,
kernel)``. Parameters are drawn
from a CPU ``torch.Generator`` with PyTorch's default initialisation of each
layer (uniform ±1/√fan_in), BatchNorm at its init (running mean 0, variance
1, weight 1, bias 0).

Spans (``tracing.py``): ``snow.forward`` around ``snow.extract``,
``snow.seed`` (the seed generator and the FPS that forms P0) and
``snow.spd`` (arg ``step`` 0-2), with ``snow.attn`` (arg ``block`` 0-4)
around each of the five attention blocks and their k-NN.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from rfnet_tpu_torch.nn import Dense
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point
from rfnet_tpu_torch.ops.grouping import group_point
from rfnet_tpu_torch.ops.knn import knn
from rfnet_tpu_torch.tracing import span

BN_EPS = 1e-5  # nn.BatchNorm's default, as published


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def _conv(in_ch: int, out_ch: int, g: torch.Generator, bias: bool = True) -> Dense:
    """A 1×1 convolution as a Dense layer, drawn as PyTorch initialises a
    convolution: weight and bias uniform ±1/√fan_in."""
    layer = Dense(in_ch, out_ch, g)
    _uniform_(layer.weight, 1.0 / math.sqrt(in_ch), g)
    if bias:
        _uniform_(layer.bias, 1.0 / math.sqrt(in_ch), g)
    return layer


class _ConvT(nn.Module):
    """A ``ConvTranspose1d(in, out, kernel)`` whose stride is its kernel (or
    whose input is one point): its weight ``(in, out, kernel)`` and bias as
    published, applied by :meth:`split` as one product."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, g: torch.Generator,
                 bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(out_ch * kernel)  # PyTorch's fan_in of a transposed conv
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel))
        _uniform_(self.weight, bound, g)
        if bias:
            self.bias = nn.Parameter(torch.empty(out_ch))
            _uniform_(self.bias, bound, g)
        else:
            self.bias = None

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(b, n, in) → (b, n·kernel, out): point i's kernel children at
        i·kernel + s, each ``x_i @ weight[:, :, s]`` (+ bias)."""
        b, n, _ = x.shape
        c_in, c_out, kernel = self.weight.shape
        y = (x @ self.weight.view(c_in, -1)).view(b, n, c_out, kernel)
        y = y.transpose(2, 3).reshape(b, n * kernel, c_out)
        return y if self.bias is None else y.add_(self.bias)


class _Holder(nn.Module):
    """A named container, so that parameter names follow the published
    ones (``mlp_conv.0.conv``, ``mlp.2``)."""

    def __init__(self, **children):
        super().__init__()
        for name, m in children.items():
            self.add_module(name, m)


def _seq(*layers: nn.Module | None) -> nn.Module:
    """Modules at the indices of a published ``nn.Sequential`` (None where
    it holds a parameter-free ReLU)."""
    return _Holder(**{str(i): m for i, m in enumerate(layers) if m is not None})


class MLPConv(nn.Module):
    """The published ``MLP_CONV`` (no BatchNorm): 1×1 convolutions with a
    ReLU between them and none after the last; named ``mlp.0``, ``mlp.2``, …"""

    def __init__(self, in_ch: int, dims: tuple, g: torch.Generator):
        super().__init__()
        layers: list[nn.Module | None] = []
        for i, ch in enumerate(dims):
            if i:
                layers.append(None)
            layers.append(_conv(in_ch, ch, g))
            in_ch = ch
        self.mlp = _seq(*layers)
        self.n = len(layers)

    def forward(self, x) -> torch.Tensor:
        for i in range(0, self.n, 2):
            x = getattr(self.mlp, str(i))(x)
            if i + 1 < self.n:
                x = F.relu(x, inplace=True)
        return x


class MLPRes(nn.Module):
    """The published ``MLP_Res``: conv_2(relu(conv_1(x))) + conv_shortcut(x)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, g: torch.Generator):
        super().__init__()
        self.conv_1 = _conv(in_dim, hidden, g)
        self.conv_2 = _conv(hidden, out_dim, g)
        self.conv_shortcut = _conv(in_dim, out_dim, g)

    def forward(self, x) -> torch.Tensor:
        shortcut = self.conv_shortcut(x)
        return self.conv_2(F.relu(self.conv_1(x), inplace=True)).add_(shortcut)


class _BNMLP(nn.Module):
    """``Sequential(Conv2d, BatchNorm2d, ReLU, Conv2d)`` of the transformers:
    the BatchNorm (running statistics) folded into the first convolution,
    refolded only when a parameter or statistic changes."""

    def __init__(self, in_ch: int, hidden: int, out_ch: int, g: torch.Generator):
        super().__init__()
        self.add_module("0", _conv(in_ch, hidden, g))
        self.add_module("1", nn.BatchNorm1d(hidden, eps=BN_EPS))
        self.add_module("3", _conv(hidden, out_ch, g))
        self._folded: tuple = ((), None)

    def _fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        conv, bn = getattr(self, "0"), getattr(self, "1")
        ts = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        key = tuple((t.data_ptr(), t._version) for t in ts)
        if self._folded[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                w = conv.weight * s[:, None]
                c = (conv.bias - bn.running_mean) * s + bn.bias
            self._folded = (key, (w, c))
        return self._folded[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, c = self._fold()
        return getattr(self, "3")(F.relu(F.linear(x, w, c), inplace=True))


class _Attention(nn.Module):
    """The k-NN vector attention shared by both transformers: key, query and
    value convolutions (``key_in`` channels → ``dim``), the position and
    attention MLPs, the weighted sum over each point's k nearest (itself
    included)."""

    def __init__(self, key_in: int, dim: int, k: int, pos_hidden: int, attn_mult: int,
                 g: torch.Generator):
        super().__init__()
        self.k = k
        self.conv_key = _conv(key_in, dim, g)
        self.conv_query = _conv(key_in, dim, g)
        self.conv_value = _conv(key_in, dim, g)
        self.pos_mlp = _BNMLP(3, pos_hidden, dim, g)
        self.attn_mlp = _BNMLP(dim, dim * attn_mult, dim, g)

    def attend(self, pos, key, query, value) -> torch.Tensor:
        """(b, n, dim) aggregated features of the (b, n, 3) points ``pos``."""
        _, idx = knn(self.k, pos, pos)  # (b, n, k)
        key = self.conv_key(key)
        query = self.conv_query(query)
        value = self.conv_value(value)
        qk_rel = query[:, :, None, :] - group_point(key, idx)  # (b, n, k, dim)
        pos_rel = pos[:, :, None, :] - group_point(pos, idx)  # (b, n, k, 3)
        pe = self.pos_mlp(pos_rel)
        attn = torch.softmax(self.attn_mlp(qk_rel.add_(pe)), dim=2)
        return (attn * pe.add_(value[:, :, None, :])).sum(2)


class Transformer(_Attention):
    """The encoder's point transformer: ``linear_start`` (c → dim), the
    attention over x's own key, query and value, ``linear_end`` (dim → c)
    plus the input."""

    def __init__(self, in_ch: int, g: torch.Generator, dim: int = 64, k: int = 16,
                 pos_hidden: int = 64, attn_mult: int = 4):
        super().__init__(dim, dim, k, pos_hidden, attn_mult, g)
        self.linear_start = _conv(in_ch, dim, g)
        self.linear_end = _conv(dim, in_ch, g)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        h = self.linear_start(x)
        return self.linear_end(self.attend(pos, h, h, h)).add_(x)


class SkipTransformer(_Attention):
    """The SPD's skip-transformer: v = ``mlp_v``(cat(key, query)), the
    attention with the keys from ``key`` (the previous stage's K), the
    queries from ``query`` and the values from v, ``conv_end`` (dim → c)
    plus v."""

    def __init__(self, in_ch: int, g: torch.Generator, dim: int = 64, k: int = 16,
                 pos_hidden: int = 64, attn_mult: int = 4):
        super().__init__(in_ch, dim, k, pos_hidden, attn_mult, g)
        self.mlp_v = MLPRes(2 * in_ch, in_ch, in_ch, g)
        self.conv_end = _conv(dim, in_ch, g)

    def forward(self, pos, key, query) -> torch.Tensor:
        value = self.mlp_v([key, query])
        return self.conv_end(self.attend(pos, key, query, value)).add_(value)


class SAModuleKNN(nn.Module):
    """``PointNet_SA_Module_KNN`` without BatchNorm (``if_bn=False``, as the
    published feature extractor builds it): ``npoint`` FPS centres (None:
    one group of every point), each grouped with its ``k`` nearest points,
    a 1×1 MLP with a ReLU after every layer but the last, a max over the
    group. Returns (centres (b, npoint, 3), features (b, npoint, out));
    with ``npoint`` None the features are (b, 1, out)."""

    def __init__(self, npoint: int | None, k: int, in_ch: int, dims: tuple, g: torch.Generator):
        super().__init__()
        self.npoint, self.k = npoint, k
        convs, last = {}, in_ch + 3
        for i, ch in enumerate(dims):
            convs[str(i)] = _Holder(conv=_conv(last, ch, g))
            last = ch
        self.mlp_conv = _Holder(**convs)
        self.n = len(dims)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor):
        if self.npoint is None:  # group all: cat(xyz, points) of every point
            new_xyz, x = None, [xyz, points]
        else:
            new_xyz = gather_point(xyz, farthest_point_sample(self.npoint, xyz))
            _, idx = knn(self.k, xyz, new_xyz)
            x = [group_point(xyz, idx).sub_(new_xyz[:, :, None, :]), group_point(points, idx)]
        for i in range(self.n):
            x = getattr(self.mlp_conv, str(i)).conv(x)
            if i + 1 < self.n:
                x = F.relu(x, inplace=True)
        return new_xyz, torch.amax(x, dim=-2, keepdim=self.npoint is None)


class FeatureExtractor(nn.Module):
    def __init__(self, g: torch.Generator, out_dim: int = 512, sa_points: tuple = (512, 128),
                 k: int = 16):
        super().__init__()
        self.sa_module_1 = SAModuleKNN(sa_points[0], k, 3, (64, 128), g)
        self.transformer_1 = Transformer(128, g, dim=64)
        self.sa_module_2 = SAModuleKNN(sa_points[1], k, 128, (128, 256), g)
        self.transformer_2 = Transformer(256, g, dim=64)
        self.sa_module_3 = SAModuleKNN(None, k, 256, (512, out_dim), g)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        """(b, n, 3) → the global feature (b, 1, out_dim)."""
        l1_xyz, l1 = self.sa_module_1(pc, pc)
        with span("snow.attn", block=0):
            l1 = self.transformer_1(l1, l1_xyz)
        l2_xyz, l2 = self.sa_module_2(l1_xyz, l1)
        with span("snow.attn", block=1):
            l2 = self.transformer_2(l2, l2_xyz)
        return self.sa_module_3(l2_xyz, l2)[1]


class SeedGenerator(nn.Module):
    def __init__(self, g: torch.Generator, dim_feat: int = 512, num_pc: int = 256):
        super().__init__()
        self.ps = _ConvT(dim_feat, 128, num_pc, g)
        self.mlp_1 = MLPRes(dim_feat + 128, 128, 128, g)
        self.mlp_2 = MLPRes(128, 64, 128, g)
        self.mlp_3 = MLPRes(dim_feat + 128, 128, 128, g)
        self.mlp_4 = _seq(_conv(128, 64, g), None, _conv(64, 3, g))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(b, 1, dim_feat) → the (b, num_pc, 3) generated seeds."""
        x1 = self.mlp_1([self.ps.split(feat), feat])  # (b, num_pc, 128) first
        x2 = self.mlp_2(x1)
        x3 = self.mlp_3([x2, feat])
        return getattr(self.mlp_4, "2")(F.relu(getattr(self.mlp_4, "0")(x3), inplace=True))


class SPD(nn.Module):
    """Snowflake point deconvolution, stage ``i``: each of the n points of
    ``pcd`` splits into ``up`` children, and the stage's K features (b,
    n·up, 128) go on to the next stage's skip-transformer as its keys."""

    def __init__(self, g: torch.Generator, dim_feat: int = 512, up: int = 2, i: int = 0,
                 radius: float = 1.0):
        super().__init__()
        self.i, self.up, self.radius = i, up, radius
        self.mlp_1 = MLPConv(3, (64, 128), g)
        self.mlp_2 = MLPConv(128 * 2 + dim_feat, (256, 128), g)
        self.skip_transformer = SkipTransformer(128, g, dim=64)
        self.mlp_ps = MLPConv(128, (64, 32), g)
        self.ps = _ConvT(32, 128, up, g, bias=False)
        self.mlp_delta_feature = MLPRes(256, 128, 128, g)
        self.mlp_delta = MLPConv(128, (64, 3), g)

    def forward(self, pcd, feat, k_prev):
        f1 = self.mlp_1(pcd)
        q = self.mlp_2([f1, torch.amax(f1, dim=1, keepdim=True), feat])
        with span("snow.attn", block=2 + self.i):
            h = self.skip_transformer(pcd, q if k_prev is None else k_prev, q)
        child = self.ps.split(self.mlp_ps(h))  # (b, n·up, 128)
        k_curr = self.mlp_delta_feature([child, self._up(h)])
        delta = torch.tanh(self.mlp_delta(F.relu(k_curr)))
        if self.radius ** self.i != 1:
            delta = delta / self.radius ** self.i
        return self._up(pcd) + delta, k_curr

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest upsampling: each point repeated ``up`` times in place."""
        return x if self.up == 1 else x.repeat_interleave(self.up, dim=1)


class Decoder(nn.Module):
    def __init__(self, g: torch.Generator, dim_feat: int = 512, num_pc: int = 256,
                 num_p0: int = 512, radius: float = 1.0, up_factors: tuple = (4, 8)):
        super().__init__()
        self.num_p0 = num_p0
        self.decoder_coarse = SeedGenerator(g, dim_feat, num_pc)
        self.uppers = nn.ModuleList(SPD(g, dim_feat, up, i, radius)
                                    for i, up in enumerate((1, *up_factors)))


@dataclass
class SnowflakeOutputs:
    """The seeds and every stage's points; ``out4`` is the served completion
    (the name the serving entry reads, as RFNet's final output)."""

    seeds: torch.Tensor  # (b, num_pc, 3) generated, Pc
    p0: torch.Tensor  # (b, num_p0, 3) FPS of cat(Pc, partial)
    stages: tuple  # P1, P2, P3: each SPD stage's points

    @property
    def out4(self) -> torch.Tensor:
        return self.stages[-1]


class SnowflakeNet(nn.Module):
    """SnowflakeNet at the published PCN widths by default (module
    docstring); ``input_points`` is the cloud size it is published for, to
    which the eval CLI resamples each partial. Parameters are drawn from
    ``generator`` (a CPU ``torch.Generator``; a fresh one seeded 0 when
    omitted)."""

    def __init__(self, dim_feat: int = 512, num_pc: int = 256, num_p0: int = 512,
                 radius: float = 1.0, up_factors: tuple = (4, 8), sa_points: tuple = (512, 128),
                 input_points: int = 2048, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_points = input_points
        self.feat_extractor = FeatureExtractor(g, dim_feat, sa_points)
        self.decoder = Decoder(g, dim_feat, num_pc, num_p0, radius, tuple(up_factors))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict``, where a 1×1 convolution's weight may
        also come with its kernel dimensions, as published checkpoints hold
        it."""
        own = self.state_dict()
        state_dict = {k: v.flatten(1) if k in own and own[k].dim() == 2 and v.dim() > 2
                      and v.shape[2:].numel() == 1 else v for k, v in state_dict.items()}
        return super().load_state_dict(state_dict, strict, assign)

    def forward(self, partial: torch.Tensor) -> SnowflakeOutputs:
        with span("snow.forward"):
            with span("snow.extract"):
                feat = self.feat_extractor(partial)
            dec = self.decoder
            with span("snow.seed"):
                seeds = dec.decoder_coarse(feat)
                merged = torch.cat([seeds, partial], dim=1)
                pcd = gather_point(merged, farthest_point_sample(dec.num_p0, merged))
            p0, stages, k_prev = pcd, [], None
            for step, upper in enumerate(dec.uppers):
                with span("snow.spd", step=step):
                    pcd, k_prev = upper(pcd, feat, k_prev)
                stages.append(pcd)
            return SnowflakeOutputs(seeds, p0, tuple(stages))

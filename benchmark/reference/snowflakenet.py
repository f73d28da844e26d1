"""Plain PyTorch SnowflakeNet: the forward, its k-NN and FPS.

The benchmark's reference for what the program computes, written from the
published code (github.com/AllenXiangX/SnowflakeNet: ``models/model.py``,
``models/skip_transformer.py``, ``models/utils.py``; Xiang et al., ICCV
2021, arXiv:2108.04444) in its own channels-first layout, with
``F.conv1d``/``F.conv2d``/``F.conv_transpose1d`` for its convolutions. It
imports nothing of the program. The weights are a state dict under the
published module names (``feat_extractor.sa_module_1.mlp_conv.0.conv.weight``,
``decoder.uppers.0.ps.weight``, …); a 1×1 convolution's weight may come as
``(out, in)`` or with its kernel dimensions. :func:`published_shapes` lists
that state dict's tensors in the published shapes, and :func:`draw_weights`
draws them from a seed (the benchmark's random weights, BatchNorm's running
statistics and affine parameters among them).

Departures from the published code, each deliberate:

* k-NN: the squared distance of a pair is summed from its coordinate
  differences, ``(dx² + dy²) + dz²``, where ``square_distance`` takes
  |a|² + |b|² − 2·a·b, so a point's distance to itself is exactly 0 (the
  point is its own first neighbour); the k least come from a stable sort,
  the lower index first among equal distances, where ``torch.argsort``
  promises no order among ties.
* FPS: starts at index 0 and takes the farthest point from the picks so far
  (running minimum of the same squared distances), the lowest index on
  ties; the published CUDA op also never picks a point within 1e-3 of the
  origin (by squared norm), which this one does not copy.
* BatchNorm (inside the transformers) in eval mode, on its running
  statistics.

``precision`` "fp32" is float32 throughout (run it under
:func:`full_fp32`: TensorFloat-32 off); "tf32" rounds both operands of
every convolution to TF32 (10 mantissa bits, to nearest) and accumulates in
float32, as a tensor-core TF32 product does: the control, one step below
the configuration's float32.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from benchmark.reference.rfnet import full_fp32, round_tf32  # noqa: F401  (full_fp32: callers')

BLOCK_ELEMS = 1 << 26  # elements of one (b, queries, targets) block of the k-NN
BN_EPS = 1e-5


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(b, n, 3), (b, m, 3) -> (b, n, m): (dx² + dy²) + dz² of a − b."""
    d = a[:, :, None, :] - b[:, None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def knn(k: int, targets: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(b, m, k) int64 indices of each query's k nearest targets, nearest
    first, the lower index first among ties; brute force in blocks of
    queries."""
    b, m, _ = queries.shape
    step = max(1, BLOCK_ELEMS // (b * targets.shape[1]))
    return torch.cat([torch.sort(sq_dist(queries[:, lo:lo + step], targets), dim=-1,
                                 stable=True)[1][..., :k] for lo in range(0, m, step)], 1)


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest point sampling of (b, n, 3): (b, npoint) int64 indices."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    mind = torch.full((b, n), 1e38, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(npoint - 1):
        mind = torch.minimum(mind, sq_dist(xyz[rows, last][:, None, :], xyz)[:, 0])
        last = torch.argmax(mind, dim=1)
        picks.append(last)
    return torch.stack(picks, dim=1)


def gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(b, c, n) at (b, m) -> (b, c, m)."""
    return x.gather(2, idx[:, None, :].expand(-1, x.shape[1], -1))


def group(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(b, c, n) at (b, m, k) -> (b, c, m, k) (``grouping_operation``)."""
    b, m, k = idx.shape
    return gather_points(x, idx.reshape(b, m * k)).reshape(b, x.shape[1], m, k)


def published_shapes(dim_feat: int = 512, num_pc: int = 256, up_factors=(4, 8), dim: int = 64,
                     pos_hidden: int = 64, attn_mult: int = 4) -> dict[str, tuple]:
    """Name → shape of every tensor in the published ``SnowflakeNet``'s
    state dict: ``Conv1d`` weights ``(out, in, 1)``, ``Conv2d`` weights
    ``(out, in, 1, 1)``, ``ConvTranspose1d`` weights ``(in, out, kernel)``.
    ``up_factors`` are those after the first SPD's 1, as the published
    config gives them."""
    shapes: dict[str, tuple] = {}

    def conv(name, c_in, c_out, dims=1, bias=True):
        shapes[name + ".weight"] = (c_out, c_in) + (1,) * dims
        if bias:
            shapes[name + ".bias"] = (c_out,)

    def bn(name, c):
        for t in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{t}"] = (c,)
        shapes[name + ".num_batches_tracked"] = ()

    def mlp_conv(name, c_in, dims):  # MLP_CONV: Conv1d at mlp.0, mlp.2, …
        for i, c_out in enumerate(dims):
            conv(f"{name}.mlp.{2 * i}", c_in, c_out)
            c_in = c_out

    def mlp_res(name, c_in, hidden, c_out):
        conv(name + ".conv_1", c_in, hidden)
        conv(name + ".conv_2", hidden, c_out)
        conv(name + ".conv_shortcut", c_in, c_out)

    def attention(name, c_in):
        for t in ("key", "query", "value"):
            conv(f"{name}.conv_{t}", c_in, dim)
        conv(name + ".pos_mlp.0", 3, pos_hidden, 2)
        bn(name + ".pos_mlp.1", pos_hidden)
        conv(name + ".pos_mlp.3", pos_hidden, dim, 2)
        conv(name + ".attn_mlp.0", dim, dim * attn_mult, 2)
        bn(name + ".attn_mlp.1", dim * attn_mult)
        conv(name + ".attn_mlp.3", dim * attn_mult, dim, 2)

    fe = "feat_extractor"
    for i, (c_in, dims) in enumerate(((6, (64, 128)), (131, (128, 256)), (259, (512, dim_feat)))):
        name = f"{fe}.sa_module_{i + 1}"
        for j, c_out in enumerate(dims):
            conv(f"{name}.mlp_conv.{j}.conv", c_in, c_out, 2)
            c_in = c_out
        if i < 2:  # the transformer after SA1 and SA2
            tr = f"{fe}.transformer_{i + 1}"
            attention(tr, dim)
            conv(tr + ".linear_start", dims[-1], dim)
            conv(tr + ".linear_end", dim, dims[-1])
    sg = "decoder.decoder_coarse"
    shapes[sg + ".ps.weight"] = (dim_feat, 128, num_pc)
    shapes[sg + ".ps.bias"] = (128,)
    mlp_res(sg + ".mlp_1", dim_feat + 128, 128, 128)
    mlp_res(sg + ".mlp_2", 128, 64, 128)
    mlp_res(sg + ".mlp_3", dim_feat + 128, 128, 128)
    conv(sg + ".mlp_4.0", 128, 64)
    conv(sg + ".mlp_4.2", 64, 3)
    for i, up in enumerate((1, *up_factors)):
        name = f"decoder.uppers.{i}"
        mlp_conv(name + ".mlp_1", 3, (64, 128))
        mlp_conv(name + ".mlp_2", 128 * 2 + dim_feat, (256, 128))
        st = name + ".skip_transformer"
        mlp_res(st + ".mlp_v", 256, 128, 128)
        attention(st, 128)
        conv(st + ".conv_end", dim, 128)
        mlp_conv(name + ".mlp_ps", 128, (64, 32))
        shapes[name + ".ps.weight"] = (32, 128, up)  # bias=False
        mlp_res(name + ".mlp_delta_feature", 256, 128, 128)
        mlp_conv(name + ".mlp_delta", 128, (64, 3))
    return shapes


def draw_weights(shapes: dict[str, tuple], seed: int) -> dict[str, torch.Tensor]:
    """A state dict of ``shapes`` drawn from a CPU generator seeded ``seed``,
    in the order of ``shapes``. Weights and biases as PyTorch initialises a
    convolution (uniform ±1/√fan_in; a transposed convolution's fan_in is
    out × kernel). BatchNorm as after training, not at its init: weight
    uniform in [0.5, 1.5], bias and running mean in [−0.25, 0.25], running
    variance in [0.25, 2], so that folding it is far from the identity."""
    g = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.empty(shape).uniform_(lo, hi, generator=g)

    out, fan_in = {}, 1
    for name, shape in shapes.items():
        layer, kind = name.rsplit(".", 1)
        if kind == "num_batches_tracked":
            out[name] = torch.tensor(0, dtype=torch.long)
        elif layer + ".running_var" in shapes:  # BatchNorm
            out[name] = {"weight": lambda s: uniform(s, 0.5, 1.5),
                         "running_var": lambda s: uniform(s, 0.25, 2.0)}.get(
                kind, lambda s: uniform(s, -0.25, 0.25))(shape)
        else:
            if kind == "weight":
                transposed = layer.endswith(".ps")
                fan_in = math.prod(shape[1:]) if not transposed else shape[1] * shape[2]
            bound = 1.0 / math.sqrt(fan_in)
            out[name] = uniform(shape, -bound, bound)
    return out


class Net:
    """The published ``SnowflakeNet`` forward on ``params``. The sizes that
    the weights do not hold (the set abstractions' centres and ``num_p0``)
    are given; the seeds, the global feature's width and the up factors are
    read off the weights. ``net(partial (b, n, 3))`` returns the seeds Pc
    and P0-P3, each (b, points, 3)."""

    def __init__(self, params: dict, precision: str = "fp32", num_p0: int = 512,
                 sa_points: tuple = (512, 128), k: int = 16, radius: float = 1.0):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.p, self.precision = params, precision
        self.num_p0, self.sa_points, self.k, self.radius = num_p0, sa_points, k, radius
        self.ups = []
        while f"decoder.uppers.{len(self.ups)}.ps.weight" in params:
            self.ups.append(params[f"decoder.uppers.{len(self.ups)}.ps.weight"].shape[2])

    # --- layers -------------------------------------------------------------

    def _ops(self, x, w):
        if self.precision == "tf32":
            return round_tf32(x), round_tf32(w)
        return x, w

    def conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A 1×1 ``Conv1d``/``Conv2d`` (by x's rank) under ``name``."""
        w = self.p[name + ".weight"]
        w = w.reshape(w.shape[0], w.shape[1], *([1] * (x.dim() - 2)))
        x, w = self._ops(x, w)
        conv = F.conv1d if x.dim() == 3 else F.conv2d
        return conv(x, w, self.p.get(name + ".bias"))

    def conv_t(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        x, w = self._ops(x, self.p[name + ".weight"])
        return F.conv_transpose1d(x, w, self.p.get(name + ".bias"), stride=stride)

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        p = self.p
        return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                            p[name + ".weight"], p[name + ".bias"], False, 0.0, BN_EPS)

    def mlp_conv(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        """``MLP_CONV`` without BatchNorm: n convolutions at mlp.0, mlp.2, …"""
        for i in range(n):
            x = self.conv(x, f"{name}.mlp.{2 * i}")
            if i + 1 < n:
                x = torch.relu(x)
        return x

    def mlp_res(self, x: torch.Tensor, name: str) -> torch.Tensor:
        shortcut = self.conv(x, name + ".conv_shortcut")
        return self.conv(torch.relu(self.conv(x, name + ".conv_1")), name + ".conv_2") + shortcut

    def bn_mlp(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``Sequential(Conv2d, BatchNorm2d, ReLU, Conv2d)``."""
        x = torch.relu(self.bn(self.conv(x, name + ".0"), name + ".1"))
        return self.conv(x, name + ".3")

    # --- blocks -------------------------------------------------------------

    def attention(self, name: str, pos, key, query, value) -> torch.Tensor:
        """The transformers' shared k-NN vector attention: (b, dim, n)."""
        b, _, n = pos.shape
        pos_t = pos.permute(0, 2, 1).contiguous()
        idx = knn(self.k, pos_t, pos_t)
        key = self.conv(key, name + ".conv_key")
        query = self.conv(query, name + ".conv_query")
        value = self.conv(value, name + ".conv_value")
        qk_rel = query.reshape(b, -1, n, 1) - group(key, idx)
        pos_rel = pos.reshape(b, -1, n, 1) - group(pos, idx)
        pe = self.bn_mlp(pos_rel, name + ".pos_mlp")
        attention = torch.softmax(self.bn_mlp(qk_rel + pe, name + ".attn_mlp"), -1)
        value = value.reshape(b, -1, n, 1) + pe
        return (attention * value).sum(-1)

    def transformer(self, name: str, x, pos) -> torch.Tensor:
        identity = x
        x = self.conv(x, name + ".linear_start")
        return self.conv(self.attention(name, pos, x, x, x), name + ".linear_end") + identity

    def skip_transformer(self, name: str, pos, key, query) -> torch.Tensor:
        value = self.mlp_res(torch.cat([key, query], 1), name + ".mlp_v")
        return self.conv(self.attention(name, pos, key, query, value), name + ".conv_end") + value

    def sa_knn(self, name: str, xyz, points, npoint):
        """``PointNet_SA_Module_KNN`` (if_bn False): (new_xyz, features)."""
        xyz_t = xyz.permute(0, 2, 1).contiguous()
        new_xyz = gather_points(xyz, fps(xyz_t, npoint))
        idx = knn(self.k, xyz_t, new_xyz.permute(0, 2, 1).contiguous())
        x = torch.cat([group(xyz, idx) - new_xyz[..., None], group(points, idx)], 1)
        x = torch.relu(self.conv(x, name + ".mlp_conv.0.conv"))
        return new_xyz, torch.max(self.conv(x, name + ".mlp_conv.1.conv"), 3)[0]

    def extract(self, pc: torch.Tensor) -> torch.Tensor:
        """(b, 3, n) -> the global feature (b, dim_feat, 1)."""
        fe = "feat_extractor"
        l1_xyz, l1 = self.sa_knn(fe + ".sa_module_1", pc, pc, self.sa_points[0])
        l1 = self.transformer(fe + ".transformer_1", l1, l1_xyz)
        l2_xyz, l2 = self.sa_knn(fe + ".sa_module_2", l1_xyz, l1, self.sa_points[1])
        l2 = self.transformer(fe + ".transformer_2", l2, l2_xyz)
        x = torch.cat([l2_xyz, l2], 1).unsqueeze(2)  # sample_and_group_all
        x = torch.relu(self.conv(x, fe + ".sa_module_3.mlp_conv.0.conv"))
        return torch.max(self.conv(x, fe + ".sa_module_3.mlp_conv.1.conv"), 3)[0]

    def seed_generator(self, feat: torch.Tensor) -> torch.Tensor:
        sg = "decoder.decoder_coarse"
        x1 = self.conv_t(feat, sg + ".ps")
        x1 = self.mlp_res(torch.cat([x1, feat.repeat(1, 1, x1.shape[2])], 1), sg + ".mlp_1")
        x2 = self.mlp_res(x1, sg + ".mlp_2")
        x3 = self.mlp_res(torch.cat([x2, feat.repeat(1, 1, x2.shape[2])], 1), sg + ".mlp_3")
        return self.conv(torch.relu(self.conv(x3, sg + ".mlp_4.0")), sg + ".mlp_4.2")

    def spd(self, i: int, pcd_prev, feat_global, k_prev):
        name, up = f"decoder.uppers.{i}", self.ups[i]
        n = pcd_prev.shape[2]
        feat_1 = self.mlp_conv(pcd_prev, name + ".mlp_1", 2)
        feat_1 = torch.cat([feat_1, torch.max(feat_1, 2, keepdim=True)[0].repeat(1, 1, n),
                            feat_global.repeat(1, 1, n)], 1)
        q = self.mlp_conv(feat_1, name + ".mlp_2", 2)
        h = self.skip_transformer(name + ".skip_transformer", pcd_prev,
                                  q if k_prev is None else k_prev, q)
        feat_child = self.conv_t(self.mlp_conv(h, name + ".mlp_ps", 2), name + ".ps", up)
        h_up = F.interpolate(h, scale_factor=up, mode="nearest")
        k_curr = self.mlp_res(torch.cat([feat_child, h_up], 1), name + ".mlp_delta_feature")
        delta = torch.tanh(self.mlp_conv(torch.relu(k_curr), name + ".mlp_delta", 2))
        delta = delta / self.radius ** i
        return F.interpolate(pcd_prev, scale_factor=up, mode="nearest") + delta, k_curr

    def __call__(self, partial: torch.Tensor) -> dict:
        feat = self.extract(partial.permute(0, 2, 1).contiguous())
        seeds = self.seed_generator(feat).permute(0, 2, 1).contiguous()
        merged = torch.cat([seeds, partial], 1)
        p0 = gather_points(merged.permute(0, 2, 1), fps(merged, self.num_p0))
        out, pcd, k_prev = {"seeds": seeds, "p0": p0.permute(0, 2, 1)}, p0, None
        for i in range(len(self.ups)):
            pcd, k_prev = self.spd(i, pcd, feat, k_prev)
            out[f"p{i + 1}"] = pcd.permute(0, 2, 1)
        return out

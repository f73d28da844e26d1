"""Closed forms of the work SnowflakeNet does, from the published widths
alone (``models/model.py``, ``models/skip_transformer.py``, ``models/utils.py``
of github.com/AllenXiangX/SnowflakeNet).

Nothing here reads the program: a later change that fuses, splits or
reorders the program's layers leaves these counts as they are.

* :func:`forward_layers` lists every 1×1 convolution (and the two kinds of
  transposed convolution) of one forward, as :class:`flops.Layer` (name,
  rows a cloud, in, out): a product of the (rows, in) activations with the
  (in, out) weight, 2·rows·in·out FLOPs, which is what
  ``torch.utils.flop_counter.FlopCounterMode`` counts for the published
  convolutions. A layer whose input joins the global feature to every point
  counts it at every point, as published.
* :func:`knn_calls` lists the k-NN scans of one forward, (queries, targets)
  a cloud; :func:`fps_calls` the FPS runs, (points, picks).
* :func:`scan_flops` counts the dense scans every implementation must do:
  8 FLOPs a pair (3 sub, 3 mul, 2 add) of the k-NN and of FPS (each pick
  scans every point).
* :func:`knn_least_seconds`: the least time K10 could take for one forward
  of ``clouds`` clouds at the card's peaks: each call at the larger of its
  FLOPs at the float32 rate and its bytes (each query and target read once,
  12 bytes; k distances and k indices written, 8 bytes each) at the
  bandwidth.

``cfg`` is the configuration's file (``configs/snowflakenet-*.json``):
``innum``, ``dim_feat``, ``num_pc``, ``num_p0``, ``up_factors``,
``sa_points``, ``k``.
"""

from __future__ import annotations

from benchmark.flops import SCAN_FLOPS_A_PAIR, Layer, Matmul, _mm

CONFIG = "configs/snowflakenet-pcn16k-serve.json"  # the published widths, under benchmark/
DIM, POS_HIDDEN, ATTN_MULT = 64, 64, 4  # the transformers' published widths


def _stack(name: str, rows: int, d_in: int, widths) -> list[Layer]:
    out = []
    for i, w in enumerate(widths):
        out.append(Layer(f"{name}.{i}", rows, d_in, w, True, True))
        d_in = w
    return out


def _attention(name: str, n: int, k: int, key_in: int) -> list[Layer]:
    """The k-NN vector attention's products at n points: key, query and
    value, then the position and attention MLPs at every pair."""
    L = [Layer(f"{name}.conv_{x}", n, key_in, DIM, True, True) for x in ("key", "query", "value")]
    L += _stack(f"{name}.pos_mlp", n * k, 3, (POS_HIDDEN, DIM))
    L += _stack(f"{name}.attn_mlp", n * k, DIM, (DIM * ATTN_MULT, DIM))
    return L


def _mlp_res(name: str, rows: int, d_in: int, hidden: int, out: int) -> list[Layer]:
    return [Layer(f"{name}.conv_1", rows, d_in, hidden, True, True),
            Layer(f"{name}.conv_2", rows, hidden, out, True, True),
            Layer(f"{name}.conv_shortcut", rows, d_in, out, True, True)]


def stage_points(cfg: dict) -> list[int]:
    """Points of P0 and of each SPD stage's output."""
    pts = [cfg["num_p0"]]
    for up in (1, *cfg["up_factors"]):
        pts.append(pts[-1] * up)
    return pts


def forward_layers(cfg: dict) -> list[Layer]:
    """Every product of one SnowflakeNet forward, for one cloud, in order."""
    n, k, f = cfg["innum"], cfg["k"], cfg["dim_feat"]
    s1, s2 = cfg["sa_points"]
    L = _stack("sa_module_1", s1 * k, 3 + 3, (64, 128))
    L += [Layer("transformer_1.linear_start", s1, 128, DIM, True, True)]
    L += _attention("transformer_1", s1, k, DIM)
    L += [Layer("transformer_1.linear_end", s1, DIM, 128, True, True)]
    L += _stack("sa_module_2", s2 * k, 128 + 3, (128, 256))
    L += [Layer("transformer_2.linear_start", s2, 256, DIM, True, True)]
    L += _attention("transformer_2", s2, k, DIM)
    L += [Layer("transformer_2.linear_end", s2, DIM, 256, True, True)]
    L += _stack("sa_module_3", s2, 256 + 3, (512, f))
    pc = cfg["num_pc"]
    L += [Layer("seed.ps", 1, f, 128 * pc, True, True)]  # ConvTranspose1d(f, 128, pc)
    L += _mlp_res("seed.mlp_1", pc, f + 128, 128, 128)
    L += _mlp_res("seed.mlp_2", pc, 128, 64, 128)
    L += _mlp_res("seed.mlp_3", pc, f + 128, 128, 128)
    L += _stack("seed.mlp_4", pc, 128, (64, 3))
    for i, (pts, up) in enumerate(zip(stage_points(cfg), (1, *cfg["up_factors"]))):
        name = f"spd{i}"
        L += _stack(name + ".mlp_1", pts, 3, (64, 128))
        L += _stack(name + ".mlp_2", pts, 2 * 128 + f, (256, 128))
        L += _mlp_res(name + ".skip.mlp_v", pts, 256, 128, 128)
        L += _attention(name + ".skip", pts, k, 128)
        L += [Layer(name + ".skip.conv_end", pts, DIM, 128, True, True)]
        L += _stack(name + ".mlp_ps", pts, 128, (64, 32))
        L += [Layer(name + ".ps", pts, 32, 128 * up, True, True)]  # ConvTranspose1d(32, 128, up)
        L += _mlp_res(name + ".mlp_delta_feature", pts * up, 256, 128, 128)
        L += _stack(name + ".mlp_delta", pts * up, 128, (64, 3))
    return L


def forward_matmuls(cfg: dict, b: int) -> list[Matmul]:
    """The products of one forward of ``b`` clouds, in float32."""
    return [_mm(x.name, b * x.rows, x.d_in, x.d_out) for x in forward_layers(cfg)]


def knn_calls(cfg: dict) -> list[tuple[int, int]]:
    """(queries, targets) a cloud of every k-NN of one forward: the two set
    abstractions' centres among their points, and each of the five
    transformers' points among themselves."""
    s1, s2 = cfg["sa_points"]
    calls = [(s1, cfg["innum"]), (s1, s1), (s2, s1), (s2, s2)]
    return calls + [(p, p) for p in stage_points(cfg)[:-1]]


def fps_calls(cfg: dict) -> list[tuple[int, int]]:
    """(points, picks) a cloud of every FPS of one forward."""
    s1, s2 = cfg["sa_points"]
    return [(cfg["innum"], s1), (s1, s2), (cfg["num_pc"] + cfg["innum"], cfg["num_p0"])]


def knn_pairs(cfg: dict) -> int:
    return sum(q * t for q, t in knn_calls(cfg))


def scan_flops(cfg: dict) -> float:
    """Dense scans of one forward a cloud: the k-NN's pairs and FPS's (each
    pick scans every point) at 8 FLOPs a pair."""
    pairs = knn_pairs(cfg) + sum(n * picks for n, picks in fps_calls(cfg))
    return float(SCAN_FLOPS_A_PAIR * pairs)


def knn_least_seconds(cfg: dict, clouds: float, peaks: dict) -> float:
    """The least time for the k-NN of one forward of ``clouds`` clouds: each
    call's FLOPs at the float32 peak or its bytes at the bandwidth, the
    larger."""
    return clouds * sum(max(SCAN_FLOPS_A_PAIR * q * t / peaks["fp32_flops"],
                            (12 * (q + t) + 8 * cfg["k"] * q) / peaks["hbm_bytes_per_s"])
                        for q, t in knn_calls(cfg))

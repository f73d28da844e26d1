"""Closed forms of the work RFNet does, from the published widths alone.

Nothing here reads the program: a later change that fuses, renames or
reorders the program's layers leaves these counts as they are.

* :func:`forward_layers` lists every dense layer call of one forward, as
  (name, rows a cloud, in, out, whether its input needs a gradient, whether
  its output reaches the training loss). A dense layer is a product of the
  (rows, in) activations with the (in, out) weight: 2·rows·in·out FLOPs.
* :func:`forward_matmuls` and :func:`train_matmuls` turn them into products
  with (FLOPs, bytes): the forward's, and a train step's forward, backward
  (the weight's gradient of every layer whose output reaches the loss, the
  input's gradient where the input needs one) and the approx-EMD's batched
  products, as ``torch.utils.flop_counter.FlopCounterMode`` counts them.
  Bytes are each operand read once and the result written once, in float32.
* :func:`serve_scan_flops` and :func:`train_scan_flops` count the exact
  nearest-neighbour scans that every implementation must do densely (the
  merges, FPS, ``zero_groupnear``): 8 FLOPs a pair (3 sub, 3 mul, 2 add).
  The early-exit chamfer scans and the approx-EMD recurrences are left
  out: an implementation may rightly do less than their dense count.
"""

from __future__ import annotations

from typing import NamedTuple

SCAN_FLOPS_A_PAIR = 8
EMD_LEVELS = 10  # λ = −4^j for j = 7 … −1, then 0


class Layer(NamedTuple):
    name: str
    rows: int  # rows a cloud
    d_in: int
    d_out: int
    input_grad: bool  # the backward forms the input's gradient
    trained: bool  # the output reaches the training loss


class Matmul(NamedTuple):
    name: str
    flops: float
    bytes: float


def _mlp(name, rows, d_in, widths, input_grad=True, trained=True):
    out = []
    for i, w in enumerate(widths):
        out.append(Layer(f"{name}.l{i}", rows, d_in, w, input_grad or i > 0, trained))
        d_in = w
    return out


def forward_layers(cfg: dict) -> list[Layer]:
    """Every dense layer call of one RFNet forward, for one cloud, in the
    order the forward makes them. ``cfg`` holds ``innum``, ``n_seed``,
    ``up_ratio`` and ``state_len``; every other width is the published
    architecture's (``vv_recon.py``)."""
    n, s, u, st = cfg["innum"], cfg["n_seed"], cfg["up_ratio"], cfg["state_len"]
    code = 256
    p1, p2, p3 = 2 * s, 2 * s * u, 2 * s * u * u
    L: list[Layer] = []

    def cell(rows, step):
        L.extend(_mlp(f"cell{step}.state_mlp", rows, 3 + st, (256, 384)))
        L.append(Layer(f"cell{step}.state_end", rows, 384, st, True, True))
        L.extend(_mlp(f"cell{step}.code_mlp", 1, st, (256, 256)))

    def recover(k, rows):
        L.extend(_mlp(f"recover{k}.mlp", rows, code + 3, (256, 256)))
        L.append(Layer(f"recover{k}.out", 1, 256, 256, True, True))

    def refine(name, rows, trained_feat=True):
        L.extend(_mlp(f"{name}.self_mlp", rows, 3 + code, (128, 128)))
        L.extend(_mlp(f"{name}.mlp", rows, 3 + 128, (128, 64, 64)))
        L.append(Layer(f"{name}.out", rows, 64, 3, True, True))
        L.extend(_mlp(f"{name}.feat_mlp", rows, 3 + 128 + code, (128, 128),
                      trained=trained_feat))
        L.append(Layer(f"{name}.feat_out", rows, 128, 128, True, trained_feat))

    def decode(step, rows, trained_state=True):
        pre = f"decode{step}"
        L.extend(_mlp(f"{pre}.mask_mlp", rows, 3 + code, (128, 128)))
        L.append(Layer(f"{pre}.mask_out", rows, 128, code, True, True))
        L.append(Layer(f"{pre}.input_trans", rows, code, 256, True, True))
        L.append(Layer(f"{pre}.state_trans", rows, 128, 128, True, True))
        L.extend(_mlp(f"{pre}.mlp", rows, 256 + 128, (256, 256)))
        L.extend(_mlp(f"{pre}.points_mlp", rows, 256, (128, 64)))
        L.append(Layer(f"{pre}.points_out", rows, 64, 3 * u, True, True))
        L.extend(_mlp(f"{pre}.state_mlp", rows, 256 + code, (128, 128), trained=trained_state))
        for i in range(u):
            L.append(Layer(f"{pre}.expand{i}_pre", rows, 128, 128, True, trained_state))
            L.append(Layer(f"{pre}.expand{i}", rows, 128, 128, True, trained_state))

    # step 1
    L.extend(_mlp("init_mlp", n, 3, (64, 128, st), input_grad=False))
    cell(n, 0)
    recover(1, n)
    L.extend(_mlp("init_move.mlp", s, 3 + code, (256, 256, 256)))
    L.extend(_mlp("init_move.featmlp", s, 3 + code + 256, (256, 128)))
    L.append(Layer("init_move.featout", s, 128, 128, True, True))
    L.extend(_mlp("init_move.ptsmlp", s, 3 + code + 256, (256, 128, 64)))
    L.append(Layer("init_move.ptsout", s, 64, 3, True, True))
    L.extend(_mlp("part_mlp", n + s, 3, (64, 128, st)))
    L.extend(_mlp("feat_trans", 1, st + code, (256, 256)))
    L.append(Layer("init_cell.input_trans", 1, 256, 256, True, True))
    L.extend(_mlp("init_cell.mlp", 1, 256, (256, 256)))
    L.append(Layer("init_cell.points_out", 1, 256, 3 * s + 12, True, True))
    L.append(Layer("init_cell.state_out", 1, 256, 16 * s, True, True))
    L.extend(_mlp("init_cell.state_mlp", s, 16 + 256, (256, 256)))
    L.append(Layer("init_cell.state_outo", s, 256, 128, True, True))
    refine("refine1", p1)
    # step 2
    cell(n + p1, 1)
    recover(2, n + p1)
    decode(0, p1)
    refine("refine2", p2)
    # step 3: the last decode's state and the last refine's features reach
    # no output the loss reads
    cell(n + p2, 2)
    recover(3, n + p2)
    decode(1, p2, trained_state=False)
    refine("refine_final", p3, trained_feat=False)
    return L


def _mm(name: str, m: float, k: float, n: float, batch: float = 1.0) -> Matmul:
    """(batch × m × k) @ (batch × k × n) in float32."""
    return Matmul(name, 2.0 * batch * m * k * n, 4.0 * batch * (m * k + k * n + m * n))


def forward_matmuls(cfg: dict, b: int) -> list[Matmul]:
    """The products of one forward of ``b`` clouds: each layer on its (b·rows,
    in) activations, and the initial decode's (s, 3)·(3, 3) map a cloud."""
    out = [_mm(x.name, b * x.rows, x.d_in, x.d_out) for x in forward_layers(cfg)]
    out.append(_mm("init_cell.transmat", cfg["n_seed"], 3, 3, b))
    return out


def emd_matmuls(b: int, n: int, m: int, name: str) -> list[Matmul]:
    """The batched products of one differentiable approx-EMD of (b, n, 3)
    against (b, m, 3) (``vv_recon.py``'s approx_match + match_cost, in one
    pass): the squared distances' cross term once, then at each level the
    two mass sums (matrix times vector) and the two gradient moments."""
    out = [_mm(f"{name}.cross", n, 3, m, b)]
    for lv in range(EMD_LEVELS):
        out += [_mm(f"{name}.l{lv}.suml", n, m, 1, b), _mm(f"{name}.l{lv}.sumr", m, n, 1, b),
                _mm(f"{name}.l{lv}.p1", n, m, 3, b), _mm(f"{name}.l{lv}.p2", m, n, 3, b)]
    return out


def train_matmuls(cfg: dict, b: int) -> list[Matmul]:
    """The products of one train step of ``b`` clouds: the forward's, the
    backward's and the pyramid EMDs' (64 and 1 024 points)."""
    out = forward_matmuls(cfg, b)
    for x in forward_layers(cfg):
        if not x.trained:
            continue
        rows = b * x.rows
        out.append(_mm(x.name + ".dW", x.d_in, rows, x.d_out))
        if x.input_grad:
            out.append(_mm(x.name + ".dx", rows, x.d_out, x.d_in))
    s = cfg["n_seed"]
    out += [_mm("init_cell.transmat.dpts", s, 3, 3, b), _mm("init_cell.transmat.dmat", 3, s, 3, b)]
    n1, n2 = 2 * s, 2 * s * cfg["up_ratio"]
    return out + emd_matmuls(b, n1, n1, "emd1") + emd_matmuls(b, n2, n2, "emd2")


def total_flops(mms: list[Matmul]) -> float:
    return sum(x.flops for x in mms)


def roofline_seconds(mms: list[Matmul], peak_flops: float, peak_bytes: float) -> tuple:
    """(least seconds, seconds bound by FLOPs, seconds bound by bytes): each
    product at the larger of its FLOPs at the peak rate and its bytes at the
    peak bandwidth."""
    t_f = t_b = least = 0.0
    for x in mms:
        f, by = x.flops / peak_flops, x.bytes / peak_bytes
        least += max(f, by)
        if f >= by:
            t_f += f
        else:
            t_b += by
    return least, t_f, t_b


def serve_scan_flops(cfg: dict) -> float:
    """Dense scans of one forward a cloud: the merges of the 2s, 2su and
    2su² points into the partial, and FPS's 32 picks over it."""
    n, s, u = cfg["innum"], cfg["n_seed"], cfg["up_ratio"]
    pairs = (2 * s + 2 * s * u + 2 * s * u * u) * n + s * n
    return float(SCAN_FLOPS_A_PAIR * pairs)


def train_scan_flops(cfg: dict) -> float:
    """Dense scans of one train step a cloud: the forward's, the ground
    truth's FPS pyramids (2s and 2su picks over ptnum points) and the two
    ``zero_groupnear`` scans (2su points into 2s, ptnum into 2su)."""
    s, u, pt = cfg["n_seed"], cfg["up_ratio"], cfg["ptnum"]
    n1, n2 = 2 * s, 2 * s * u
    pairs = (n1 + n2) * pt + n2 * n1 + pt * n2
    return serve_scan_flops(cfg) + float(SCAN_FLOPS_A_PAIR * pairs)

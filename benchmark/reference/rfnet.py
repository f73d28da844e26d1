"""Plain PyTorch RFNet: the forward, its nearest-neighbour scans and FPS.

The benchmark's reference for what the program computes, written from the
published model (``vv_recon.py``'s RFNet and ``recon_test.py``'s serving
contract). It imports nothing of the program: the weights are read from
the ``.npz`` of flat flax parameters (``{"a/b/kernel": (in, out), "a/b/bias":
(out,) or (steps, out)}``) and kept in a dict under those names, and each
dense layer is ``x @ kernel + bias`` on them.

* Nearest neighbours are brute force over blocks of queries, each pair's
  squared distance summed from coordinate differences; ties go to the
  lowest index.
* FPS starts at index 0 and takes the farthest point from the picks so far
  (running minimum of squared distances), the lowest index on ties.
* ``precision`` "fp32" is float32 throughout, with TensorFloat-32 switched off
  for the run; "tf32" rounds both operands of every matrix product to TF32
  (10 mantissa bits, to nearest) in the forward and the backward, as a
  tensor-core TF32 product does, and accumulates in float32. That is the
  control: one step below the configuration's float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BLOCK_ELEMS = 1 << 26  # elements of one (b, queries, targets) block of a scan


@contextlib.contextmanager
def full_fp32():
    """TensorFloat-32 off for matrix products and convolutions in the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (the low 13 mantissa bits cleared),
    to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(rg, rb.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            if ra.dim() > rb.dim():  # (..., k) @ (k, n): the batch rows fold into k
                gb = ra.reshape(-1, ra.shape[-1]).t() @ rg.reshape(-1, rg.shape[-1])
            else:
                gb = torch.matmul(ra.transpose(-1, -2), rg)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    if precision == "fp32":
        return torch.matmul(a, b)
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    raise ValueError(f"precision {precision!r}: expected fp32 or tf32")


def load_npz(path: str, device) -> tuple[dict[str, torch.Tensor], int]:
    """(parameters by flax path, float32 on ``device``; the training step)."""
    with np.load(path) as z:
        params = {k: torch.from_numpy(np.asarray(z[k], dtype=np.float32)).to(device)
                  for k in z.files if not k.startswith("__")}
        step = int(z["__step__"]) if "__step__" in z.files else 0
    return params, step


def sizes(params: dict[str, torch.Tensor]) -> tuple[int, int]:
    """(n_seed, up_ratio) read off the generating layers' widths."""
    n_seed = (params["init_cell/points_out/kernel"].shape[1] - 12) // 3
    up_ratio = params["decode_cell/points_out/kernel"].shape[1] // 3
    return n_seed, up_ratio


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


@torch.no_grad()
def nearest(query: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distance (b, n), index (b, n) int64) of each query's nearest
    target, by brute force in blocks of queries."""
    b, n, _ = query.shape
    m = target.shape[1]
    step = max(1, BLOCK_ELEMS // (b * m))
    t = [target[:, None, :, c] for c in range(3)]
    dist, idx = [], []
    for lo in range(0, n, step):
        q = query[:, lo:lo + step]
        d = (q[:, :, None, 0] - t[0]) ** 2
        d += (q[:, :, None, 1] - t[1]) ** 2
        d += (q[:, :, None, 2] - t[2]) ** 2
        dmin, imin = d.min(dim=2)
        dist.append(dmin)
        idx.append(imin)
    return torch.cat(dist, 1), torch.cat(idx, 1)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


@torch.no_grad()
def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest point sampling: (b, npoint) int64 indices."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    mind = torch.full((b, n), 1e38, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(npoint - 1):
        d = ((xyz - xyz[rows, last][:, None, :]) ** 2).sum(-1)
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1)
        picks.append(last)
    return torch.stack(picks, dim=1)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


class Net:
    """The forward over a parameter dict; ``precision`` as the module says."""

    def __init__(self, params: dict[str, torch.Tensor], precision: str = "fp32"):
        self.p = params
        self.precision = precision
        self.n_seed, self.up_ratio = sizes(params)

    def dense(self, x, path, step=None):
        bias = self.p[path + "/bias"]
        if step is not None:
            bias = bias[step]
        return matmul(x, self.p[path + "/kernel"], self.precision) + bias

    def mlp(self, x, path, n_layers, step=None, last_relu=True):
        for i in range(n_layers):
            x = self.dense(x, f"{path}/l{i}", step)
            if i < n_layers - 1 or last_relu:
                x = torch.relu(x)
        return x

    @staticmethod
    def bcast(x, n):
        return x.expand(x.shape[0], n, x.shape[-1])

    def encode(self, pts, state, step):
        x = torch.cat([pts, self.bcast(state, pts.shape[1])], -1)
        x = self.mlp(x, "cell/state_mlp", 2, step)
        x = torch.relu(self.dense(x, "cell/state_end", step))
        new_state = x.amax(dim=1, keepdim=True)
        return self.mlp(new_state, "cell/code_mlp", 2, step), new_state

    def recover(self, k, code, pts):
        x = self.mlp(torch.cat([self.bcast(code, pts.shape[1]), pts], -1), f"recover{k}/mlp", 2)
        return self.dense(x.amax(dim=1, keepdim=True), f"recover{k}/out")

    def global_mlp(self, path, pts):
        return self.mlp(pts, path + "/mlp", 3).amax(dim=1, keepdim=True)

    def init_move(self, start, code):
        k = start.shape[1]
        t1 = torch.cat([start, self.bcast(code, k)], -1)
        maxt = self.mlp(t1, "init_move/mlp", 3).amax(dim=1, keepdim=True)
        t = torch.cat([t1, self.bcast(maxt, k)], -1)
        feats = torch.relu(self.dense(self.mlp(t, "init_move/featmlp", 2), "init_move/featout"))
        move = torch.tanh(self.dense(self.mlp(t, "init_move/ptsmlp", 3), "init_move/ptsout"))
        return start + move, feats

    def init_decode(self, code):
        b, s = code.shape[0], self.n_seed
        x = self.mlp(torch.relu(self.dense(code, "init_cell/input_trans")), "init_cell/mlp", 2)
        raw = self.dense(x, "init_cell/points_out")
        transmat = raw[..., -12:-3].reshape(b, 3, 3)
        movemat = raw[..., -3:].reshape(b, 1, 3)
        pts = torch.tanh(raw[..., :3 * s]).reshape(b, s, 3)
        pts = matmul(pts, transmat, self.precision) + movemat
        st = torch.relu(self.dense(x, "init_cell/state_out")).reshape(b, s, 16)
        st = self.mlp(torch.cat([st, self.bcast(x, s)], -1), "init_cell/state_mlp", 2)
        return pts, torch.relu(self.dense(st, "init_cell/state_outo"))

    def decode(self, code, center, state, step):
        b, n, _ = center.shape
        u, d = self.up_ratio, "decode_cell"
        code_n = self.bcast(code, n)
        mask = self.mlp(torch.cat([center, code_n], -1), d + "/mask_mlp", 2, step)
        mask = torch.relu(self.dense(mask, d + "/mask_out", step))
        info = torch.relu(self.dense(mask * code, d + "/input_trans", step))
        sinfo = torch.relu(self.dense(state, d + "/state_trans", step))
        x = self.mlp(torch.cat([info, sinfo], -1), d + "/mlp", 2, step)
        p = self.mlp(x, d + "/points_mlp", 2, step)
        moves = torch.tanh(self.dense(p, d + "/points_out", step)).reshape(b, n, u, 3)
        pts = (center[:, :, None, :] + moves).reshape(b, n * u, 3)
        cur = self.mlp(torch.cat([x, code_n], -1), d + "/state_mlp", 2, step)
        branches = []
        for i in range(u):
            cur = self.mlp(cur, f"{d}/expand{i}_pre", 1, step)
            cur = torch.nn.functional.leaky_relu(self.dense(cur, f"{d}/expand{i}", step), 0.01)
            branches.append(cur)
        smove = torch.stack(branches, dim=2)
        width = smove.shape[-1]
        return pts, (state[:, :, None, :] + smove).reshape(b, n * u, width), moves

    def refine(self, path, pts, feat, feat2):
        n = pts.shape[1]
        feat_n = self.bcast(feat, n)
        t = self.mlp(torch.cat([pts, feat_n], -1), path + "/self_mlp", 2)
        maxt = t.amax(dim=1, keepdim=True)
        t = self.mlp(torch.cat([pts, self.bcast(maxt, n)], -1), path + "/mlp", 3)
        move = torch.tanh(self.dense(t, path + "/out"))
        new_pts = pts + move
        s = self.mlp(torch.cat([new_pts, feat2, feat_n], -1), path + "/feat_mlp", 2)
        s = torch.tanh(self.dense(s, path + "/feat_out"))
        return new_pts, feat2 + s, move

    def merge(self, raw, new, factor):
        """Pull each point toward its nearest input point by a Gaussian of
        the distance; the neighbour carries no gradient."""
        _, idx = nearest(new.detach(), raw)
        delta = gather(raw, idx) - new
        d2 = (delta * delta).sum(-1, keepdim=True)
        return new + torch.exp(-d2 / (1e-8 + factor ** 2)) * delta

    def __call__(self, pc: torch.Tensor) -> dict[str, torch.Tensor]:
        p = self.p
        state = self.global_mlp("init_mlp", pc)
        code_raw, state = self.encode(pc, state, 0)
        code1 = self.recover(1, code_raw, pc)
        seed = gather(pc, fps(pc, self.n_seed))
        moved, dstate_m = self.init_move(seed, code1)
        partfeat = self.global_mlp("part_mlp", torch.cat([pc, moved], 1))
        gen, dstate_g = self.init_decode(self.mlp(torch.cat([partfeat, code1], -1), "feat_trans", 2))
        points1_pre = torch.cat([gen, moved], 1)
        dstate = torch.cat([dstate_g, dstate_m], 1)
        points1 = self.merge(pc, points1_pre, p["decline_factor0"])
        points1, dstate, _ = self.refine("refine_layer1", points1, code1, dstate)

        pin = torch.cat([pc, points1], 1)
        code_raw, state = self.encode(pin, state, 1)
        code2 = code1 + self.recover(2, code_raw, pin)
        points2_pre, dstate, moves1 = self.decode(code2, points1, dstate, 0)
        points2 = self.merge(pc, points2_pre, p["decline_factor1"])
        points2, dstate, _ = self.refine("refine_layer2", points2, code2, dstate)

        pin = torch.cat([pc, points2], 1)
        code_raw, state = self.encode(pin, state, 2)
        code3 = code2 + self.recover(3, code_raw, pin)
        out3, dstate, moves2 = self.decode(code3, points2, dstate, 1)
        out4 = self.merge(pc, out3, p["decline_factor"])
        out4, _, final_move = self.refine("refine_layer_final", out4, code3, dstate)
        return {"points1_pre": points1_pre, "points2_pre": points2_pre, "out3": out3,
                "out4": out4, "moves1": moves1, "moves2": moves2, "final_move": final_move,
                "decfactor_sq": torch.cat([p["decline_factor0"] ** 2, p["decline_factor1"] ** 2,
                                           p["decline_factor"] ** 2])}


def mean_nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per cloud, the mean distance of a point of ``a`` to its nearest in
    ``b`` (float64): the serving metric ``cd`` is the mean of both
    directions between output and ground truth, the fidelity this of the
    partial into the output."""
    return nearest(a, b)[0].double().sqrt().mean(1)

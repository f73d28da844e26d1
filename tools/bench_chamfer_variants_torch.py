"""The NN variant study on one CUDA card (the counterpart of
``tools/bench_chamfer_variants.py``): kernel K9 (``csrc/nn_variant.cu``), the
dense one-sided scan in four variants, beside K4.

    python3 tools/bench_chamfer_variants_torch.py [--iters 10]
    python3 tools/bench_chamfer_variants_torch.py --device cpu --tiny   # plain versions

  v0  K4's arithmetic: e = |t|² − 2·((tx·qx + ty·qy) + tz·qz), each step
      rounded; K4's kernel instance under K4's plan
  v1  fma-folded: e = fma(mx, qx, fma(my, qy, fma(mz, qz, |t|²))), m = −2t
  v2  equality argmin: a chunk's least e, then the lowest index that has it
      (e = fma(−2, cross, |t|²), v0's value bit for bit)
  v3  v1 + v2

v1-v3 run under K9's own plan (:func:`variant_plan`). The steps are the JAX
tool's: every variant against v0 on a small shape (distances within 1e-5;
v2's indices equal to v0's; v1's and v3's indices each realising its
distance, since an FMA may break a near tie the other way); v0-v3 at B=32,
N=16384 on ``RandomState(0)`` clouds (gt -> out3), on the card each held
there to its plain version bit for bit first (:func:`hold_variants`, which
``chip_smoke.py`` applies too: this shape's launch plan is not the small
one's); the fastest variant's four separate cd3/cd4 scans against the same
work in two batched calls (whose distances must equal the four scans').
Beside these: K4 (``ops.chamfer.nn_dense``) on the same clouds, the library
call ``torch.cdist(q, t).min(-1)`` in chunks of queries (no matrix over 8
GiB), the fastest variant's plain version, each variant's plan, live warps
an SM (at the registers ptxas gave its kernel) and operation bound on an
H100 (its own fp32 operations a pair), and the card's name and power
limit. Times are ``_common_torch.timeit``'s. The last line is one JSON
object with every number. With ``--device cpu`` the plain versions run and
no card number (bound, library call, live warps) is printed. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch import kernels  # noqa: E402
from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from rfnet_tpu_torch.ops.fps import _sm_count  # noqa: E402
from tools._common_torch import device_info, require, resolve_device, timeit  # noqa: E402

# (name, fma, eq_argmin), the JAX tool's four
VARIANTS = (("v0 baseline", False, False), ("v1 fma", True, False),
            ("v2 eq-argmin", False, True), ("v3 fma+eq", True, True))
B, N = 32, 16384
TINY_B, TINY_N = 2, 512
SMALL = (2, 700, 1100)  # the parity shape: clouds, queries, targets
PARITY_ATOL = 1e-5  # the JAX tool's distance tolerance
LIBRARY_BYTES = 1 << 33  # the largest (b, chunk, m) cdist matrix of the library call
# H100 SXM non-tensor fp32 peak (NVIDIA data sheet), which counts an FFMA
# as 2 operations, and each variant's fp32 operations a pair by (fma,
# eq_argmin): v0 9, K4's count (the Pallas kernels' cost estimate), v1 3
# FFMA and the compare, v2 3 FMUL, 2 FADD, 1 FFMA and the fminf, v3 3 FFMA
# and the fminf
PEAK_FP32 = 67e12
OPS_A_PAIR = {(False, False): 9, (True, False): 7, (False, True): 8, (True, True): 7}
# K9's plan (csrc/nn_variant.cu): CTAs of 8 warps an SM its launch bounds
# ask for (variant_blocks_per_sm), the most targets of a staged tile; an
# H100 SM's registers, allocated to a warp in units of 256, and its shared
# memory for CTAs, each of which reserves 1 KB of it
VARIANT_BLOCKS_PER_SM = {True: 2, False: 3}  # by eq_argmin
VARIANT_TILE = 2048
SM_REGISTERS = 65536
SM_SHARED = 233472


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def variant_chunk(plan, fma: bool) -> int:
    """U, the targets of a chunk K9 scans at a time under ``plan`` in the
    arithmetic ``fma`` (``nn_variant.cu:variant_chunk``): 64 / R, and 12 at
    R = 8 for the unfused chain."""
    return 12 if plan[0] == 8 and not fma else 64 // plan[0]


def variant_plan(b: int, n: int, m: int, sms: int,
                 per_thread: int | None = None) -> tuple[int, int, int, int, int]:
    """K9's launch of v1-v3 for ``b`` clouds of ``n`` queries and ``m``
    targets on a card with ``sms`` SMs: (R queries a thread, G query warps a
    CTA, W warps that split a CTA's targets, C CTAs of a cluster that split
    the cloud's targets, tiles a CTA stages its range in). Plain Python.

    R is 8 where the query warps at 8 a thread give every SM a CTA of 8, as
    K4's plan chooses. The split S = W·C doubles, up to 64, while the doubled
    warps still fit one wave of 2 CTAs of 8 warps an SM (the equality
    argmin's ``VARIANT_BLOCKS_PER_SM``) and a warp keeps at least
    ``chamfer._NN_SCAN_MIN_CHAIN`` targets; the warps of a CTA take a split
    up to 8, clusters of 8 CTAs a larger one. G
    is the largest power of two the CTA has room for (G·W ≤ 8) that the
    cloud's query warps fill and that leaves at least ``sms`` CTAs. The
    CTA's range of ``ceil(m / C)`` targets is staged in tiles of at most
    ``VARIANT_TILE``, so that two CTAs share an SM. At (32,16384)²: (8, 8,
    1, 1, 8), 256 CTAs on 132 SMs of 2, 97 % of one wave. ``per_thread``
    forces R (the card tests take both)."""
    aim = 8 * sms
    r = per_thread or (8 if b * _cdiv(n, 256) >= aim else 4)
    qw = _cdiv(n, 32 * r)
    s = 1
    while (s < 64 and 2 * b * qw * s <= VARIANT_BLOCKS_PER_SM[True] * aim
           and _cdiv(m, 2 * s) >= chamfer._NN_SCAN_MIN_CHAIN):
        s *= 2
    c = 1 if s <= 8 else 8
    w = s // c
    g = min(8 // w, 1 << (qw - 1).bit_length())
    while g > 1 and b * _cdiv(qw, g) * c < sms:
        g //= 2
    return r, g, w, c, _cdiv(_cdiv(m, c), VARIANT_TILE)


def plan_of(fma: bool, eq_argmin: bool, b: int, n: int, m: int, sms: int):
    """The plan a variant runs under: K4's for v0, K9's for the others."""
    if fma or eq_argmin:
        return variant_plan(b, n, m, sms)
    return chamfer._nn_scan_plan(b, n, m, sms)


def variant_shares(m: int, plan, step: int) -> list[list[tuple[int, int]]]:
    """The targets each warp scans, as segments [start, end) in its scan
    order, as the scan cuts them under ``plan``: CTA ``rank`` of C holds
    [rank·chunk, (rank+1)·chunk), staged in ``tiles`` tiles; warp ``w`` of W
    scans of every tile the w-th share of ``ceil(ceil(cnt / W) / step)·step``
    targets. ``step`` is K9's chunk U (:func:`variant_chunk`); 1 gives K4's
    cut (``nn_scan.cuh``), v0's. One list a warp, rank by rank."""
    _, _, w, c, tiles = plan
    chunk = _cdiv(m, c)
    tile = _cdiv(chunk, tiles)
    out = []
    for rank in range(c):
        lo = min(m, rank * chunk)
        length = min(m, lo + chunk) - lo
        for wi in range(w):
            segs = []
            for k in range(_cdiv(length, tile)):
                cnt = min(tile, length - k * tile)
                sub = _cdiv(_cdiv(cnt, w), step) * step
                s = min(cnt, wi * sub)
                if min(cnt, s + sub) > s:
                    segs.append((lo + k * tile + s, lo + k * tile + min(cnt, s + sub)))
            out.append(segs)
    return out


def live_warps(regs: int, smem: int, warps: int) -> int:
    """Warps an H100 SM holds of a kernel whose threads take ``regs``
    registers and whose CTAs of ``warps`` warps take ``smem`` bytes of
    shared memory: the CTAs that the registers, the shared memory (1 KB
    reserved a CTA) and the 64 warps of an SM each allow, times ``warps``."""
    per_warp = _cdiv(32 * regs, 256) * 256
    return min(SM_REGISTERS // (per_warp * warps), SM_SHARED // (smem + 1024),
               64 // warps) * warps


def variant_live_warps(m: int, plan, eq_argmin: bool) -> int:
    """Warps an SM holds of K9 (v1-v3) under ``plan`` at the most registers
    a thread its launch bounds allow (ptxas caps them at the multiple of 8
    under ``SM_REGISTERS`` / (``VARIANT_BLOCKS_PER_SM`` x 256)): the
    design's count, which the build's (:func:`built_live_warps`) meets."""
    regs = SM_REGISTERS // (VARIANT_BLOCKS_PER_SM[eq_argmin] * 256) // 8 * 8
    return live_warps(regs, chamfer._nn_scan_shared(m, plan), plan[1] * plan[2])


def ptxas_registers() -> dict:
    """{(kernel, template arguments): registers a thread} of the built
    library, from ptxas' report in ``kernels.BUILD_DIR/build.log`` (the
    arguments are the mangled name's ``Lb``/``Li`` values)."""
    regs, key = {}, None
    with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "Compiling entry" in line:
                name = re.search(r"([A-Za-z_]+kernel)I((?:L[bi]\d+E)+)E", line)
                key = name and (name.group(1),
                                tuple(int(v) for v in re.findall(r"L[bi](\d+)E", name.group(2))))
            elif key and "Used" in line and "registers" in line:
                regs[key] = int(re.search(r"Used (\d+) registers", line).group(1))
                key = None
    return regs


def built_live_warps(m: int, plan, fma: bool, eq_argmin: bool, regs: dict) -> int:
    """Warps an SM holds of the variant's kernel under ``plan`` (v0: K4's
    ``nn_scan_kernel<false, R>``, v1-v3 ``nn_variant_kernel<R, fma, eq>``)
    at the registers ptxas gave it (``regs``: :func:`ptxas_registers`)."""
    key = (("nn_variant_kernel", (plan[0], int(fma), int(eq_argmin))) if fma or eq_argmin
           else ("nn_scan_kernel", (0, plan[0])))
    require(key in regs, f"ptxas reported no registers for {key} (build.log)")
    return live_warps(regs[key], chamfer._nn_scan_shared(m, plan), plan[1] * plan[2])


def nn_variant(xyz1: torch.Tensor, xyz2: torch.Tensor, fma: bool = False,
               eq_argmin: bool = False):
    """K9's wrapper: (dist² (b,n), idx (b,n) int32) of ``xyz1`` into
    ``xyz2`` in the variant (``fma``, ``eq_argmin``), under its plan
    (:func:`plan_of`). CUDA tensors only: the plain version is
    :func:`nn_variant_plain`, which a caller on the CPU takes itself."""
    chamfer._check_pair(xyz1, xyz2)
    if not xyz1.is_cuda:
        raise ValueError("nn_variant launches K9 and takes CUDA tensors; its plain version "
                         "is nn_variant_plain")
    q = xyz1.detach().contiguous()
    t = xyz2.detach().contiguous()
    b, n, _ = q.shape
    m = t.shape[1]
    plan = plan_of(fma, eq_argmin, b, n, m, _sm_count(q.device))
    dist = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    kernels.launch("nn_variant", q.device, q, t, b, n, m, *plan, int(fma), int(eq_argmin),
                   dist, idx)
    return dist, idx


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c) of broadcastable float32 tensors, rounded once to
    nearest even, as the card's FFMA rounds it. The product is exact in
    float64; the float64 sum s and its TwoSum residual hold the exact sum,
    s + err. Rounding s to float32 is exact rounding except where s is a
    float32 midpoint (a tie) and err is not 0: there the exact sum lies on
    err's side of the tie, and is rounded to that neighbour. (Overflow is
    outside the domain: no coordinate near 1e19.)"""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    f = s.float()
    d = s - f.double()  # exact: s lies within half an ulp of f
    toward = torch.where(d > 0, torch.full_like(f, float("inf")), torch.full_like(f, -float("inf")))
    g = torch.nextafter(f, toward)  # f's neighbour on s's side
    tie = (d != 0) & ((f.double() + g.double()) * 0.5 == s)
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), g, f)


def _variant_e(q: torch.Tensor, t: torch.Tensor, fma: bool) -> torch.Tensor:
    """(b, k, m) e of the queries ``q`` against the targets ``t`` in the
    variant's operation order: K4's unfused chain (v0, and v2, whose single
    fma(−2, cross, |t|²) rounds the same exact value), or three fused
    multiply-adds on m = −2t (v1, v3), each rounded once (:func:`fma32`)."""
    s2 = chamfer._sq3(t)
    if not fma:
        return chamfer._pairwise_e(q, t, s2)
    mt = -2.0 * t
    e = s2[:, None, :]
    for a in (2, 1, 0):
        e = fma32(mt[:, None, :, a], q[:, :, None, a], e)
    return e


def nn_variant_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, fma: bool = False,
                     eq_argmin: bool = False):
    """Plain version of K9 in the kernel's operation order, in chunks of
    queries as ``ops.chamfer._one_sided``: the least e, the lowest index that
    has it, then ``max(e + |q|², 0)``. ``eq_argmin`` changes only the
    kernel's work: both of its argmins give the lowest index of the least e,
    as the first-index argmin of the other variants does."""
    del eq_argmin
    chamfer._check_pair(xyz1, xyz2)
    q = xyz1.detach().contiguous()
    t = xyz2.detach().contiguous()
    b, n, _ = q.shape
    m = t.shape[1]
    rows = torch.arange(m, dtype=torch.int32, device=q.device)
    s1 = chamfer._sq3(q)
    step = chamfer._chunk(b, m)
    dist, idx = [], []
    for lo in range(0, n, step):
        e = _variant_e(q[:, lo:lo + step], t, fma)
        e_min = e.amin(-1)
        idx.append(torch.where(e == e_min[..., None], rows, m).amin(-1))
        dist.append(torch.clamp(e_min + s1[:, lo:lo + step], min=0.0))
    return torch.cat(dist, 1), torch.cat(idx, 1)


def tie_clouds(seed: int, b: int, n: int, m: int, plans) -> tuple[torch.Tensor, torch.Tensor]:
    """(q (b,n,3), t (b,m,3)) float32 on a 1/64 grid (exact values of e, and
    many equal ones), with ties planted at the cuts of each (plan, step) of
    ``plans`` (:func:`variant_shares`): at every segment's start s the
    target before it is copied to s (a tie across a tile, a warp's share or
    a CTA's range), to s + 1 (inside a chunk) and to s + step (across two
    chunks); s + 2 to s + 5 (a tie inside a chunk whose winner is not the
    chunk's first). Query i sits on the i-th planted target, every second
    one a grid step off it; the rest are random grid points."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 64, size=(b, m, 3)).astype(np.float32) / 64
    picks = []
    for plan, step in plans:
        for segs in variant_shares(m, plan, step):
            for s, e in segs:
                if s > 0:
                    for k in (s, s + 1, s + step):
                        if k < e:
                            t[:, k] = t[:, s - 1]
                    picks.append(s - 1)
                if s + 5 < e:
                    t[:, s + 5] = t[:, s + 2]
                    picks.append(s + 2)
    q = rng.randint(0, 64, size=(b, n, 3)).astype(np.float32) / 64
    k = min(n, len(picks))
    q[:, :k] = t[:, picks[:k]]
    q[:, 1:k:2, 0] += 1 / 64
    return torch.from_numpy(q), torch.from_numpy(t)


def realised_err(q: torch.Tensor, t: torch.Tensor, dist: torch.Tensor,
                 idx: torch.Tensor) -> float:
    """Largest |‖q − t[idx]‖² − dist| (the pair's distance in float64): how
    far a returned index is from realising its returned distance."""
    picked = chamfer._gather_rows(t, idx).double()
    return float(((q.double() - picked).square().sum(-1) - dist.double()).abs().max())


def hold_to_plain(q: torch.Tensor, t: torch.Tensor, d: torch.Tensor, i: torch.Tensor,
                  fma: bool, plain=None) -> dict:
    """Holds K9's output (``d``, ``i``) for ``q`` into ``t`` to its plain
    version (``plain``, else computed) bit for bit, distances and indices,
    in either arithmetic. Returns the largest distance difference and the
    realising error (how far an index is from its distance)."""
    pd, pi = nn_variant_plain(q, t, fma=fma) if plain is None else plain
    what = f"{'fma' if fma else 'unfused'} variant at {tuple(q.shape)}x{tuple(t.shape)}"
    differ = (d != pd) | (i != pi)
    out = {"max_abs_err": float((d - pd).abs().max()), "realised_err": realised_err(q, t, d, i)}
    require(not bool(differ.any()), f"{what}: {int(differ.sum())} queries differ from the plain "
            f"version (err {out['max_abs_err']})")
    return out


def hold_variants(q: torch.Tensor, t: torch.Tensor, outs: dict,
                  fma_differs: bool = True) -> dict:
    """Holds K9's four outputs for ``q`` into ``t`` (``outs``: variant name
    -> (dist, idx)) to the plain versions by :func:`hold_to_plain`; also v2
    bit-equal to v0 and v3 to v1 (the equality argmin, and v2's fused
    doubling, change the work, not the result) and, with ``fma_differs``,
    v1's distances not all v0's (the fma switch took effect; on clouds
    whose every product and sum is exact, as on a coarse grid, the two
    arithmetics agree). Returns each variant's :func:`hold_to_plain`
    numbers."""
    plains = {f: nn_variant_plain(q, t, fma=f) for f in (False, True)}
    held = {name: hold_to_plain(q, t, *outs[name], fma, plains[fma])
            for name, fma, _ in VARIANTS}
    v0, v1, v2, v3 = (outs[name] for name, _, _ in VARIANTS)
    require(all(torch.equal(a, b) for a, b in zip(v2, v0)), "v2 differs from v0")
    require(all(torch.equal(a, b) for a, b in zip(v3, v1)), "v3 differs from v1")
    require(not fma_differs or not torch.equal(v1[0], v0[0]),
            "v1's distances are v0's: the fma form did not run")
    return held


def library_chunk(b: int, n: int, m: int) -> int:
    """Queries a call of the library yardstick takes: the largest power of
    two whose (b, chunk, m) float32 distance matrix stays within
    ``LIBRARY_BYTES``, at most ``n``."""
    chunk = 1
    while chunk < n and b * 2 * chunk * m * 4 <= LIBRARY_BYTES:
        chunk *= 2
    return chunk


def cdist_min(q: torch.Tensor, t: torch.Tensor, chunk: int) -> torch.Tensor:
    """The library call: ``torch.cdist(q, t).min(-1)`` over chunks of
    ``chunk`` queries; the distances (not squared)."""
    return torch.cat([torch.cdist(q[:, lo:lo + chunk], t).min(-1).values
                      for lo in range(0, q.shape[1], chunk)], 1)


def bound_ms(b: int, n: int, m: int, fma: bool, eq_argmin: bool) -> float:
    """The least time of one scan of the variant on an H100: its
    ``OPS_A_PAIR`` at the fp32 peak (its bytes, 12 a point read and 8 a
    query written, take far less at these shapes)."""
    return OPS_A_PAIR[fma, eq_argmin] * b * n * m / PEAK_FP32 * 1e3


def expected_launches(iters: int) -> int:
    """K9's launches in one run of :func:`main` on the card: the parity
    scans (v0 and four variants); for each variant the call held to the
    plain versions, the first timed call, 1 warm-up and ``iters`` timed
    calls; then the four-scans and batched forms (4 and 2 launches a call),
    each with one checked call, a first call, 2 warm-ups and ``iters``."""
    return 5 + 4 * (3 + iters) + 6 * (4 + iters)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a variant")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="small clouds (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    scan = nn_variant if cuda else nn_variant_plain
    info = device_info(dev)
    b, n = (TINY_B, TINY_N) if args.tiny else (B, N)
    print(f"device: {info['smi'] or info['name']}; {'K9' if cuda else 'plain versions'}",
          flush=True)

    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape, 3).astype(np.float32)).to(dev)

    gt, out3, out4 = rand(b, n), rand(b, n), rand(b, n)

    # correctness first, on a small shape
    sb, sn, sm = SMALL
    sm1, sm2 = rand(sb, sn), rand(sb, sm)
    d0, i0 = scan(sm1, sm2)
    parity = {}
    for name, fma, eq in VARIANTS:
        d, i = scan(sm1, sm2, fma=fma, eq_argmin=eq)
        err, real = float((d - d0).abs().max()), realised_err(sm1, sm2, d, i)
        require(err <= PARITY_ATOL, f"{name}: distances differ from v0's by {err}")
        require(real <= PARITY_ATOL, f"{name}: an index is {real} from realising its distance")
        require(fma or torch.equal(i, i0), f"{name}: indices differ from v0's")
        parity[name] = {"max_abs_err": err, "realised_err": real,
                        "index_agreement": float((i == i0).float().mean())}
    print(f"small-shape parity ok (all variants) at ({sb},{sn},3)x({sb},{sm},3): "
          + "; ".join(f"{k} err {v['max_abs_err']:.3g}, indices {v['index_agreement']:.5f}"
                      for k, v in parity.items()), flush=True)

    def timed(name, fn, *fn_args, iters=args.iters, warmups=2):
        return timeit(name, fn, *fn_args, iters=iters, warmups=warmups, device=dev, width=44)

    # each variant's first call is kept: on the card it is held to the plain
    # versions at this shape (whose launch plan differs from the small one's)
    outs = {name: scan(gt, out3, fma=fma, eq_argmin=eq) for name, fma, eq in VARIANTS}
    times = {name: timed(f"{name} {n}^2 b{b}",
                         lambda a, c, f=fma, e=eq: scan(a, c, fma=f, eq_argmin=e), gt, out3,
                         warmups=1)
             for name, fma, eq in VARIANTS}
    k4_ms = timed(f"K4 nn_dense {n}^2 b{b}", chamfer.nn_dense, gt, out3)
    result = {"tool": "bench_chamfer_variants", "device": info, "shape": [b, n, n],
              "parity": parity, "variants_ms": times, "k4_ms": k4_ms}
    best = min(times, key=times.get)
    fma, eq = next((f, e) for name, f, e in VARIANTS if name == best)
    print(f"best variant: {best}", flush=True)
    if cuda:
        result["timed_shape_parity"] = hold_variants(gt, out3, outs)
        print(f"timed-shape parity ok: every variant bit-equal to its plain version at "
              f"({b},{n},3)^2, v2 to v0, v3 to v1", flush=True)
        sms = _sm_count(dev)
        plans = {name: plan_of(f, e, b, n, n, sms) for name, f, e in VARIANTS}
        result["plans"] = {name: list(plan) for name, plan in plans.items()}
        regs = ptxas_registers()
        result["live_warps"] = {name: built_live_warps(n, plans[name], f, e, regs)
                                for name, f, e in VARIANTS}
        print("plans (R, G, W, C, tiles) and live warps an SM: " + "; ".join(
            f"{k} {plans[k]} {result['live_warps'][k]}" for k in plans), flush=True)
        chunk = library_chunk(b, n, n)
        result["library_chunk"] = chunk
        result["library_ms"] = timed(f"cdist.min ({chunk} queries a call)", cdist_min, gt, out3,
                                     chunk)
        result["plain_ms"] = timed(f"{best} plain version",
                                   lambda a, c: nn_variant_plain(a, c, fma=fma), gt, out3,
                                   iters=1, warmups=0)
        result["bounds_ms"] = {name: bound_ms(b, n, n, f, e) for name, f, e in VARIANTS}
        for name, f, e in VARIANTS:
            ms = result["bounds_ms"][name]
            print(f"{f'{name} bound ({OPS_A_PAIR[f, e]} ops a pair at 67 TFLOP/s)':44s}: "
                  f"{ms:8.3f} ms, {ms / times[name]:.1%} of it reached")

    def four_scans(g, o3, o4):
        return [scan(q, t, fma=fma, eq_argmin=eq)[0]
                for q, t in ((g, o3), (o3, g), (g, o4), (o4, g))]

    def batched_scans(g, o3, o4):
        a = scan(torch.cat([o3, o4], 1), g, fma=fma, eq_argmin=eq)[0]  # (b, 2n) vs gt
        c = scan(torch.cat([g, g], 0), torch.cat([o3, o4], 0), fma=fma, eq_argmin=eq)[0]
        return a, c

    sep, (a, c) = four_scans(gt, out3, out4), batched_scans(gt, out3, out4)
    require(torch.equal(a, torch.cat([sep[1], sep[3]], 1))
            and torch.equal(c, torch.cat([sep[0], sep[2]], 0)),
            "the batched calls' distances differ from the four scans'")
    result["best"] = best
    result["four_scans_ms"] = timed("four separate scans", four_scans, gt, out3, out4)
    result["batched_ms"] = timed("batched (2 calls)", batched_scans, gt, out3, out4)
    result["launches"] = kernels.launches["nn_variant"]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""The NN variant study on one CUDA card (the counterpart of
``tools/bench_chamfer_variants.py``): kernel K9 (``csrc/nn_variant.cu``), the
dense one-sided scan in four variants, beside K4.

    python3 tools/bench_chamfer_variants_torch.py [--iters 10]
    python3 tools/bench_chamfer_variants_torch.py --device cpu --tiny   # plain versions

  v0  K4's arithmetic: e = |t|² − 2·((tx·qx + ty·qy) + tz·qz), each step rounded
  v1  fma-folded: e = fma(mx, qx, fma(my, qy, fma(mz, qz, |t|²))), m = −2t
  v2  equality argmin: a tile's least e, then the lowest index that has it
  v3  v1 + v2

The steps are the JAX tool's: every variant against v0 on a small shape
(distances within 1e-5; v2's indices equal to v0's; v1's and v3's indices
each realising its distance, since an FMA may break a near tie the other
way); v0-v3 at B=32, N=16384 on ``RandomState(0)`` clouds (gt -> out3), on
the card each held there to its plain version first (:func:`hold_variants`,
which ``chip_smoke.py`` applies too: this shape's launch plan is not the
small one's); the fastest variant's four separate cd3/cd4 scans against the
same work in two batched calls (whose distances must equal the four
scans'). Beside these:
K4 (``ops.chamfer.nn_dense``) on the same clouds, the library call
``torch.cdist(q, t).min(-1)`` in chunks of queries (no matrix over 8 GiB),
v0's plain version, the operation bound on an H100 and the card's name and
power limit. Times are ``_common_torch.timeit``'s. The last line is one JSON
object with every number. With ``--device cpu`` the plain versions run and
no card number (bound, library call) is printed. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
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
# K9's fma variants against their plain version, which emulates the fused
# chain in float64 and so rounds twice where a sum falls on a float32
# midpoint: they may differ on at most FMA_DIFFER of the queries, each
# distance by at most two ulps of |e|; every index realises its distance
# within FMA_ATOL at unit-cube coordinates
FMA_DIFFER = 1e-4
FMA_ATOL = 2e-6
LIBRARY_BYTES = 1 << 33  # the largest (b, chunk, m) cdist matrix of the library call
# H100 SXM non-tensor fp32 peak (NVIDIA data sheet) and 9 operations a pair
PEAK_FP32 = 67e12
OPS_A_PAIR = 9


def nn_variant(xyz1: torch.Tensor, xyz2: torch.Tensor, fma: bool = False,
               eq_argmin: bool = False):
    """K9's wrapper: (dist² (b,n), idx (b,n) int32) of ``xyz1`` into
    ``xyz2`` in the variant (``fma``, ``eq_argmin``), under K4's launch plan
    (``ops.chamfer._nn_scan_plan``). CUDA tensors only: the plain version is
    :func:`nn_variant_plain`, which a caller on the CPU takes itself."""
    chamfer._check_pair(xyz1, xyz2)
    if not xyz1.is_cuda:
        raise ValueError("nn_variant launches K9 and takes CUDA tensors; its plain version "
                         "is nn_variant_plain")
    q = xyz1.detach().contiguous()
    t = xyz2.detach().contiguous()
    b, n, _ = q.shape
    m = t.shape[1]
    plan = chamfer._nn_scan_plan(b, n, m, _sm_count(q.device))
    dist = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    kernels.launch("nn_variant", q.device, q, t, b, n, m, *plan, int(fma), int(eq_argmin),
                   dist, idx)
    return dist, idx


def _variant_e(q: torch.Tensor, t: torch.Tensor, fma: bool) -> torch.Tensor:
    """(b, k, m) e of the queries ``q`` against the targets ``t`` in the
    variant's operation order. The fma chain is emulated in float64: the
    product of two floats is exact there, and the sum is rounded to float64
    and then to float32, which differs from the fused single rounding only
    where the float64 sum falls on a float32 midpoint (then by one ulp)."""
    s2 = chamfer._sq3(t)
    if not fma:
        return chamfer._pairwise_e(q, t, s2)
    mt, qd = (-2.0 * t).double(), q.double()
    e = s2.double()[:, None, :]
    for a in (2, 1, 0):
        e = (mt[:, None, :, a] * qd[:, :, None, a] + e).float().double()
    return e.float()


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


def realised_err(q: torch.Tensor, t: torch.Tensor, dist: torch.Tensor,
                 idx: torch.Tensor) -> float:
    """Largest |‖q − t[idx]‖² − dist| (the pair's distance in float64): how
    far a returned index is from realising its returned distance."""
    picked = chamfer._gather_rows(t, idx).double()
    return float(((q.double() - picked).square().sum(-1) - dist.double()).abs().max())


def hold_to_plain(q: torch.Tensor, t: torch.Tensor, d: torch.Tensor, i: torch.Tensor,
                  fma: bool, plain=None) -> dict:
    """Holds K9's output (``d``, ``i``) for ``q`` into ``t`` to its plain
    version (``plain``, else computed): without the fma bit for bit,
    distances and indices; with it bit for bit but on at most
    ``FMA_DIFFER`` of the queries, where a distance may differ by two ulps
    of |e| (e = dist − |q|², its magnitude taken as the larger of |q|² and
    |dist − |q|²|) and the index may differ; every index realising its
    distance within ``FMA_ATOL``. Returns the largest distance difference,
    the share of queries that differ and the realising error."""
    pd, pi = nn_variant_plain(q, t, fma=fma) if plain is None else plain
    what = f"{'fma' if fma else 'unfused'} variant at {tuple(q.shape)}x{tuple(t.shape)}"
    differ = (d != pd) | (i != pi)
    out = {"max_abs_err": float((d - pd).abs().max()), "differ": float(differ.float().mean()),
           "realised_err": realised_err(q, t, d, i)}
    if not fma:
        require(not bool(differ.any()), f"{what}: {int(differ.sum())} queries differ from the "
                f"plain version (err {out['max_abs_err']})")
        return out
    s1 = chamfer._sq3(q)
    mag = torch.maximum(s1, (pd - s1).abs())
    ulps = 2 * (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag)
    require(out["differ"] <= FMA_DIFFER, f"{what}: {int(differ.sum())} queries differ from the "
            f"plain version, more than a share of {FMA_DIFFER}")
    require(bool(((d - pd).abs() <= ulps).all()), f"{what}: a distance differs from the plain "
            f"version's by more than two ulps of e (err {out['max_abs_err']})")
    require(out["realised_err"] <= FMA_ATOL, f"{what}: an index is {out['realised_err']} from "
            f"realising its distance")
    return out


def hold_variants(q: torch.Tensor, t: torch.Tensor, outs: dict) -> dict:
    """Holds K9's four outputs for ``q`` into ``t`` (``outs``: variant name
    -> (dist, idx)) to the plain versions by :func:`hold_to_plain`; also
    v3 bit-equal to v1 (the equality argmin changes the work, not the
    result) and v1's distances not all v0's (the fma switch took effect).
    Returns each variant's :func:`hold_to_plain` numbers."""
    plains = {f: nn_variant_plain(q, t, fma=f) for f in (False, True)}
    held = {name: hold_to_plain(q, t, *outs[name], fma, plains[fma])
            for name, fma, _ in VARIANTS}
    v0, v1, _, v3 = (outs[name] for name, _, _ in VARIANTS)
    require(all(torch.equal(a, b) for a, b in zip(v3, v1)), "v3 differs from v1")
    require(not torch.equal(v1[0], v0[0]), "v1's distances are v0's: the fma form did not run")
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


def bound_ms(b: int, n: int, m: int) -> float:
    """The least time of one scan on an H100: its 9 operations a pair at the
    fp32 peak (its bytes, 12 a point read and 8 a query written, take far
    less at these shapes)."""
    return OPS_A_PAIR * b * n * m / PEAK_FP32 * 1e3


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
    if cuda:
        result["timed_shape_parity"] = held = hold_variants(gt, out3, outs)
        print(f"timed-shape parity ok against the plain versions at ({b},{n},3)^2: "
              + "; ".join(f"{k} err {v['max_abs_err']:.3g}, {v['differ']:.3g} of the queries "
                          f"differ" for k, v in held.items()), flush=True)
        chunk = library_chunk(b, n, n)
        result["library_chunk"] = chunk
        result["library_ms"] = timed(f"cdist.min ({chunk} queries a call)", cdist_min, gt, out3,
                                     chunk)
        result["plain_ms"] = timed("v0 plain version", nn_variant_plain, gt, out3, iters=1,
                                   warmups=0)
        result["bound_ms"] = bound_ms(b, n, n)
        print(f"{'bound (9 ops a pair at 67 TFLOP/s)':44s}: {result['bound_ms']:8.3f} ms")

    best = min(times, key=times.get)
    fma, eq = next((f, e) for name, f, e in VARIANTS if name == best)
    print(f"best variant: {best}", flush=True)

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

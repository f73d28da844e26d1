"""K9, the NN variant kernel of ``tools/bench_chamfer_variants.py``, on the
CPU: the port's plain version (``tools/bench_chamfer_variants_torch.py``)
against the JAX tool's Pallas kernel run in interpret mode, for all four
variants, on seeded numpy clouds; its one-rounding fma (``fma32``) against
an exact ``fractions.Fraction`` oracle, midpoints included; a torch model of
the kernel's walk (chunks of U targets, the fminf and re-find argmin, the W
and C splits and their merge) bit-equal to the plain version and to the JAX
kernel on clouds with planted ties; K9's launch plan; the wrapper's refusal
of CPU tensors; and the variant study's launch count. The kernel itself
runs on the card only (``tests/test_torch_gpu.py``)."""

import importlib.util
import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rfnet_tpu_torch.ops import chamfer
from tools import bench_chamfer_variants_torch as variants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# distances within 1e-6 absolute at unit-cube coordinates; every port index
# realises its distance within the same (the |t|² − 2q·t expansion rounds
# at a few ulps of values up to 3)
ATOL = 1e-6


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_chamfer_variants", os.path.join(REPO, "tools", "bench_chamfer_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tool = _load_jax_tool()  # main() does not run


def _cases():
    rng = np.random.RandomState(100)
    q, t = rng.rand(2, 700, 3).astype(np.float32), rng.rand(2, 1100, 3).astype(np.float32)
    # every target three times (two copies in reverse order): ties everywhere
    u = rng.rand(2, 64, 3).astype(np.float32)
    dup = np.concatenate([u, u[:, ::-1], u], axis=1)
    return {"random": (q, t), "duplicated": (rng.rand(2, 90, 3).astype(np.float32), dup)}


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fma,eq", [(False, False), (True, False), (False, True), (True, True)])
def test_plain_version_matches_jax_interpret(case, fma, eq):
    """Distances within 1e-6 of the JAX kernel's, and each port index
    realises its distance within 1e-6; without the fma the indices are the
    JAX kernel's too (the lowest index of the least e on both sides)."""
    q, t = CASES[case]
    with pltpu.force_tpu_interpret_mode():
        jd, ji = jax_tool.nn_variant(jnp.asarray(q), jnp.asarray(t), fma=fma, eq_argmin=eq)
    d, i = variants.nn_variant_plain(torch.from_numpy(q), torch.from_numpy(t), fma=fma,
                                     eq_argmin=eq)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    assert variants.realised_err(torch.from_numpy(q), torch.from_numpy(t), d, i) <= ATOL
    if not fma:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if case == "duplicated":
        assert int(i.max()) < 64  # the first copy wins every tie


def test_plain_v0_is_k4s_plain_scan_and_eq_changes_nothing():
    """v0's plain version is K4's (``ops.chamfer._one_sided``) bit for bit,
    and the equality argmin gives the same result in both arithmetics."""
    q, t = (torch.from_numpy(x) for x in CASES["random"])
    d0, i0 = variants.nn_variant_plain(q, t)
    kd, ki = chamfer._one_sided(q, t)
    assert torch.equal(d0, kd) and torch.equal(i0, ki)
    for fma in (False, True):
        a = variants.nn_variant_plain(q, t, fma=fma)
        b = variants.nn_variant_plain(q, t, fma=fma, eq_argmin=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_fma_chain_is_not_the_unfused_chain():
    """The fma variant's e (each multiply-add rounded once) differs from the
    same chain with its products rounded apart at some pairs, by a few
    ulps at most: the plain version keeps the variant's arithmetic."""
    q, t = (torch.from_numpy(x) for x in CASES["random"])
    fused = variants._variant_e(q, t, fma=True)
    mt, e = -2.0 * t, chamfer._sq3(t)[:, None, :]
    for a in (2, 1, 0):
        e = mt[:, None, :, a] * q[:, :, None, a] + e
    differs = float((fused != e).float().mean())
    assert 0.0 < differs < 1.0
    assert float((fused - e).abs().max()) <= ATOL


def test_wrapper_refuses_cpu_tensors():
    q, t = (torch.from_numpy(x) for x in CASES["random"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        variants.nn_variant(q, t)


def test_study_launch_count(monkeypatch, capsys):
    """The study's scans, counted where the card would launch K9, are
    ``expected_launches(iters)`` (``chip_smoke.py`` checks the card's count
    against it); the batched calls' distances equal the four scans'."""
    calls = []
    plain = variants.nn_variant_plain
    monkeypatch.setattr(variants, "nn_variant_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setattr(variants, "TINY_N", 64)
    out = variants.main(["--device", "cpu", "--tiny", "--iters", "2"])
    assert len(calls) == variants.expected_launches(2)
    assert out["best"] in out["variants_ms"] and not {"bound_ms", "bounds_ms"} & set(out)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"tool"')


def _held_case():
    """(q, t, {variant: plain (dist, idx)}) at 16 000 queries."""
    rng = np.random.RandomState(101)
    q, t = (torch.from_numpy(rng.rand(2, k, 3).astype(np.float32)) for k in (8000, 64))
    return q, t, {name: variants.nn_variant_plain(q, t, fma=fma, eq_argmin=eq)
                  for name, fma, eq in variants.VARIANTS}


HELD = _held_case()


def _e_ulps(q, d, k):
    """``k`` ulps of e = dist − |q|² at each query (its magnitude taken as
    the larger of |q|² and |e|)."""
    s1 = chamfer._sq3(q)
    mag = torch.maximum(s1, (d - s1).abs())
    return k * (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag)


def _moved(out, q, ulps, queries):
    """``out`` with the distances of ``queries`` (flat indices) moved up by
    ``ulps`` ulps of e."""
    d = out[0].clone()
    flat = d.view(-1)
    flat[queries] += _e_ulps(q, out[0], ulps).view(-1)[queries]
    return d, out[1]


DIFFER = "differ from the plain version"


@pytest.mark.parametrize("case,fails", [
    ("exact", None),
    ("fma, one query one ulp", DIFFER),
    ("fma, one query two ulps", DIFFER),
    ("fma, two queries", DIFFER),
    ("fma, one query three ulps", DIFFER),
    ("fma, one index off", DIFFER),
    ("unfused, one query one ulp", DIFFER),
    ("unfused, one index off", DIFFER),
    ("v1 is v0", "the fma form did not run"),
    ("v3 is not v1", "v3 differs from v1"),
    ("v2 is not v0", "v2 differs from v0"),
])
def test_hold_variants_rule(monkeypatch, case, fails):
    """The card's rule for K9 against its plain versions
    (``hold_variants``): every variant bit for bit, distances and indices,
    in both arithmetics (the fma plain version rounds once, as the card);
    v2 equal to v0 and v3 to v1, v1 not to v0. A distance one ulp off, or an
    index that realises the same distance through a duplicate target, fails."""
    q, t, plain = HELD
    v0, v1, v2, v3 = (name for name, _, _ in variants.VARIANTS)
    outs = dict(plain)
    if case.startswith("fma, one query"):
        ulps = {"one": 1, "two": 2, "three": 3}[case.split()[3]]
        outs[v1] = outs[v3] = _moved(plain[v1], q, ulps, [5])
    elif case == "fma, two queries":
        outs[v1] = outs[v3] = _moved(plain[v1], q, 1, [5, 9000])
    elif case == "fma, one index off":
        # the target's duplicate at another index: the same distance, but
        # not the lowest index that has it
        i = plain[v1][1].clone()
        j = int(i[0, 7])
        t = torch.cat([t, t[:, j:j + 1]], 1)
        i[0, 7] = t.shape[1] - 1
        outs[v1] = outs[v3] = (plain[v1][0], i)
    elif case == "unfused, one query one ulp":
        outs[v0] = outs[v2] = _moved(plain[v0], q, 1, [5])
    elif case == "unfused, one index off":
        i = plain[v0][1].clone()
        i[0, 7] = (i[0, 7] + 1) % t.shape[1]
        outs[v0] = (plain[v0][0], i)
    elif case == "v1 is v0":
        # a kernel whose fma switch did nothing, held to a plain version
        # that agrees with it: only the v1-against-v0 check can see it
        plain_v0 = variants.nn_variant_plain
        monkeypatch.setattr(variants, "nn_variant_plain",
                            lambda a, b, fma=False, eq_argmin=False: plain_v0(a, b))
        outs[v1] = outs[v3] = plain[v0]
    elif case in ("v3 is not v1", "v2 is not v0"):
        # an equality argmin that differs from its partner's result where
        # the plain version does not look (its check switched off)
        name = v3 if case == "v3 is not v1" else v2
        monkeypatch.setattr(variants, "hold_to_plain", lambda *a, **k: {})
        outs[name] = _moved(plain[name], q, 1, [5])
    if fails is None:
        held = variants.hold_variants(q, t, outs)
        assert all(v["max_abs_err"] == 0.0 for v in held.values())
    else:
        with pytest.raises(SystemExit, match=fails):
            variants.hold_variants(q, t, outs)


def _round_f32(x: Fraction) -> float:
    """The exact value ``x`` rounded to the nearest float32, ties to even
    (gradual underflow; no overflow)."""
    if x == 0:
        return 0.0
    sign, a = (-1, -x) if x < 0 else (1, x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    while Fraction(2) ** e > a:
        e -= 1
    while Fraction(2) ** (e + 1) <= a:
        e += 1
    scale = Fraction(2) ** (max(e, -126) - 23)
    k, rem = divmod(a / scale, 1)
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and k % 2):
        k += 1
    return sign * float(k * scale)


def _oracle(a, b, c):
    """float32 fma(a, b, c) of float32 numpy arrays by exact arithmetic."""
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a.ravel(), b.ravel(), c.ravel())],
                    dtype=np.float32).reshape(a.shape)


def _fma_cases(kind):
    """(a, b, c) float32. "random": signs and magnitudes spread over 2^±12.
    "midpoints": a·b + c within 2^-34 of a float32 midpoint beside c, in
    every scale, sign and last-bit parity used: a = 1 + i·2^-23 and b = (1 −
    (2i − 1)·2^-24)·2^-24 make a·b = 2^-24 (1 + ε) with |ε| < 2^-29 for i
    in [2016, 2080], so the float64 sum rounds onto the midpoint and the
    exact sum lies on one side of it."""
    if kind == "random":
        rng = np.random.RandomState(7)
        x = rng.uniform(0.5, 2, (3, 3000)) * 2.0 ** rng.randint(-12, 13, (3, 3000))
        x *= rng.choice([-1, 1], (3, 3000))
        return tuple(x.astype(np.float32))
    rows = []
    for i in range(2016, 2081):
        for j in (0, 1, 2, 3):
            for sign in (1, -1):
                for s in (-3, 0, 5):
                    rows.append((sign * (1 + i * 2.0 ** -23), (1 - (2 * i - 1) * 2.0 ** -24)
                                 * 2.0 ** (s - 24), (1 + j * 2.0 ** -23) * 2.0 ** s))
    return tuple(np.array(rows, dtype=np.float32).T)


@pytest.mark.parametrize("kind", ["random", "midpoints"])
def test_fma32_rounds_once(kind):
    """``fma32`` equals the exact fma rounded once, bit for bit; on the
    midpoint cases the float64 sum rounded again to float32 (the plain
    version's old emulation) is wrong on many of them."""
    a, b, c = _fma_cases(kind)
    want = _oracle(a, b, c)
    got = variants.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    wrong = float((twice != want).mean())
    assert (wrong > 0.2) if kind == "midpoints" else (wrong < 1e-2)


def test_fused_doubling_is_the_unfused_chain():
    """v2's ``fma(−2, cross, |t|²)`` equals v0's ``|t|² − 2·cross`` bit for
    bit (2·cross is exact, so both round one exact value once), on unit-cube
    clouds, on a 1/64 grid and at coordinates up to 1e18."""
    rng = np.random.RandomState(8)
    for scale in (1.0, 1e9, 1e18):
        q, t = (torch.from_numpy((rng.rand(2, k, 3) * 2 - 1).astype(np.float32) * scale)
                for k in (50, 300))
        for x in (q, t):
            x[0] = torch.round(x[0] / scale * 64) / 64
        s2 = chamfer._sq3(t)
        cross = _cross(q, t)
        fused = variants.fma32(torch.tensor(-2.0), cross, s2[:, None, :])
        assert torch.equal(fused, chamfer._pairwise_e(q, t, s2))


def _cross(q, t):
    return (q[:, :, None, 0] * t[:, None, :, 0] + q[:, :, None, 1] * t[:, None, :, 1]
            + q[:, :, None, 2] * t[:, None, :, 2])


def _kernel_e(q, t, fma):
    """(b, n, m) e as the kernel computes it: three fmas on m = −2t, or
    ``fma(−2, cross, |t|²)``."""
    if fma:
        return variants._variant_e(q, t, fma=True)
    return variants.fma32(torch.tensor(-2.0), _cross(q, t), chamfer._sq3(t)[:, None, :])


def _walk(q, t, fma, eq, plan):
    """(dist² (b,n), idx (b,n) int32) as ``csrc/nn_variant.cu`` computes them
    under ``plan``: each warp's segments (``variant_shares``) in chunks of U
    targets, each chunk's least e (fminf) taken with the lowest u that holds
    it where it is below the running best (eq), else every pair under strict
    <, the ragged end pair by pair; the partials merged by least e, then
    least index."""
    e_all = _kernel_e(q, t, fma)
    b, n, m = e_all.shape
    u_n = variants.variant_chunk(plan, fma)
    inf = float("inf")
    best = torch.full((b, n), inf)
    best_j = torch.zeros((b, n), dtype=torch.int32)

    def select(pb, pj, j):
        e = e_all[..., j]
        upd = e < pb
        return torch.where(upd, e, pb), torch.where(upd, j, pj)

    for segs in variants.variant_shares(m, plan, u_n):
        pb, pj = torch.full((b, n), inf), torch.zeros((b, n), dtype=torch.int32)
        for s, end in segs:
            j = s
            while end - j >= u_n:
                if eq:
                    chunk = e_all[..., j:j + u_n]
                    least = chunk.amin(-1)
                    k = (chunk == least[..., None]).int().argmax(-1)
                    upd = least < pb
                    pb = torch.where(upd, least, pb)
                    pj = torch.where(upd, (j + k).int(), pj)
                else:
                    for jj in range(j, j + u_n):
                        pb, pj = select(pb, pj, jj)
                j += u_n
            for jj in range(j, end):
                pb, pj = select(pb, pj, jj)
        take = (pb < best) | ((pb == best) & (pj < best_j))
        best, best_j = torch.where(take, pb, best), torch.where(take, pj, best_j)
    return torch.clamp(best + chamfer._sq3(q), min=0.0), best_j


SMS = 132  # an H100 SXM
# (b, n, m) of K9's launches: the study's timed and batched shapes, the
# parity shape, and the card tests' and chip_smoke.py's
SHAPES = [(32, 16384, 16384), (32, 32768, 16384), (64, 16384, 16384), (2, 700, 1100),
          (4, 3000, 16384), (2, 3000, 16384), (2, 1, 1), (2, 70, 150)]
# plans forced on small clouds: R 4 and 8, W and C splits, tiles whose size
# is no multiple of U, more splits than chunks
FORCED = [((2, 40, 1100), (8, 1, 1, 1, 3)), ((2, 40, 1100), (4, 1, 4, 8, 1)),
          ((1, 70, 700), (8, 2, 2, 2, 3)), ((2, 33, 300), (4, 1, 8, 8, 1)),
          ((1, 5, 1000), (8, 1, 8, 1, 2))]
NATURAL = [((min(b, 2), min(n, 48), m), variants.variant_plan(b, n, m, SMS))
           for b, n, m in SHAPES if m <= 1100]


def _ties(shape, plan, seed=0):
    b, n, m = shape
    return variants.tie_clouds(seed + sum(shape), b, n, m,
                               [(plan, variants.variant_chunk(plan, True)),
                                (plan, variants.variant_chunk(plan, False)), (plan, 1)])


@pytest.mark.parametrize("shape,plan", FORCED + NATURAL)
def test_walk_equals_plain_on_ties(shape, plan):
    """The kernel's walk, in the three variants K9's kernel runs, equals the
    plain version bit for bit on clouds with ties planted inside chunks,
    across chunks, tiles, warps' shares and CTAs' ranges; every planted
    query's index is the lowest that holds its distance."""
    q, t = _ties(shape, plan)
    for fma, eq in ((True, False), (False, True), (True, True)):
        d, i = _walk(q, t, fma, eq, plan)
        pd, pi = variants.nn_variant_plain(q, t, fma=fma, eq_argmin=eq)
        assert torch.equal(d, pd) and torch.equal(i, pi), (fma, eq)
    picked = chamfer._gather_rows(t, i)
    dup = (t[:, None, :, :] == picked[:, :, None, :]).all(-1)  # (b, n, m): copies of the pick
    lowest = torch.where(dup, torch.arange(t.shape[1]), t.shape[1]).amin(-1)
    assert torch.equal(i.long(), lowest)
    assert t.shape[1] == 1 or int((dup.sum(-1) > 1).sum()) > 0  # some picks have a copy


@pytest.mark.parametrize("fma", [False, True])
def test_walk_matches_jax_interpret_on_ties(fma):
    """The walk on planted ties against the JAX tool's kernel in interpret
    mode (its equality argmin): distances within 1e-6, each index realising
    its distance within 1e-6, and the lowest index among exact copies (the
    grid's values are exact, so the JAX kernel's e ties exactly too)."""
    shape, plan = (2, 64, 1100), (4, 1, 4, 8, 1)
    q, t = _ties(shape, plan, seed=1)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = jax_tool.nn_variant(jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), fma=fma,
                                     eq_argmin=True)
    d, i = _walk(q, t, fma, True, plan)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=ATOL)
    assert variants.realised_err(q, t, d, i) <= ATOL
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def _ctas(b, n, plan):
    r, g, _, c, _ = plan
    return b * -(-n // (32 * r * g)) * c


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_variant_plan(b, n, m):
    """K9's plan at every shape it launches at: a plan the kernel takes,
    within the shared memory a CTA may have, 16 live warps an SM or more
    (24 for v1), every target in exactly one warp's share, at least one CTA
    an SM, and shares of at least 32 targets where split."""
    plan = variants.variant_plan(b, n, m, SMS)
    r, g, w, c, tiles = plan
    assert r in (4, 8) and tiles >= 1 and g * w <= 8
    for x in (g, w, c):
        assert x & (x - 1) == 0 and 1 <= x <= 8
    assert chamfer._nn_scan_shared(m, plan) <= 232448
    assert variants.variant_live_warps(m, plan, True) >= 16
    assert variants.variant_live_warps(m, plan, False) >= 24
    assert _ctas(b, n, plan) >= min(SMS, b * -(-n // (32 * r)) * c)
    for fma in (False, True):
        step = variants.variant_chunk(plan, fma)
        js = sorted(j for segs in variants.variant_shares(m, plan, step)
                    for s, e in segs for j in range(s, e))
        assert js == list(range(m))
    if w * c > 1:
        assert -(-m // (w * c)) >= chamfer._NN_SCAN_MIN_CHAIN


def test_variant_plan_at_the_study_shape():
    """(32,16384)²: 8 queries a thread, CTAs of 8 query warps, no split, 8
    tiles of 2048 targets (64 KB a CTA); 16 live warps an SM (24 for v1);
    256 CTAs fill 132 SMs of 2 to 97.0 % of one wave; v0 keeps K4's plan."""
    plan = variants.variant_plan(32, 16384, 16384, SMS)
    assert plan == (8, 8, 1, 1, 8)
    assert chamfer._nn_scan_shared(16384, plan) == 65536
    assert variants.variant_live_warps(16384, plan, True) == 16
    assert variants.variant_live_warps(16384, plan, False) == 24
    ctas = _ctas(32, 16384, plan)
    assert ctas == 256 and 0.969 <= ctas / (2 * SMS) <= 1
    assert variants.plan_of(False, False, 32, 16384, 16384, SMS) == chamfer._nn_scan_plan(
        32, 16384, 16384, SMS)


def test_variant_bounds():
    """Each variant's operation bound at (32,16384)² counts its own fp32
    operations a pair, an FFMA as 2 as the 67 TFLOP/s peak does: v0 9 (K4's
    count), v1 and v3 7, v2 8."""
    pairs = 32 * 16384 * 16384
    want = {"v0 baseline": 9, "v1 fma": 7, "v2 eq-argmin": 8, "v3 fma+eq": 7}
    for name, fma, eq in variants.VARIANTS:
        got = variants.bound_ms(32, 16384, 16384, fma, eq)
        assert got == pytest.approx(want[name] * pairs / 67e12 * 1e3, rel=1e-12)
    assert variants.bound_ms(32, 16384, 16384, True, False) == pytest.approx(0.8975, abs=1e-4)
    assert variants.bound_ms(32, 16384, 16384, False, True) == pytest.approx(1.0257, abs=1e-4)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{}' for 'sm_90a'
ptxas info    : Function properties for {}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {} registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_built_live_warps_from_ptxas_report(tmp_path, monkeypatch):
    """The live warps an SM at the study's plans, from the registers in a
    ptxas report: K4's instance (v0) one CTA of 8 warps (its 175 KB of
    tiles), v1 at 80 registers three CTAs, v2 and v3 at 96-128 two; the
    design's count (at the launch bounds' cap) is met; a kernel the report
    lacks stops the tool."""
    from rfnet_tpu_torch import kernels

    names = {"_ZN5rfnet14nn_scan_kernelILb0ELi8EEEvPKfS2_iiiiiiPfPiS3_": 72,
             "_ZN5rfnet17nn_variant_kernelILi8ELb1ELb0EEEvPKfS2_iiiiiiiPfPi": 80,
             "_ZN5rfnet17nn_variant_kernelILi8ELb0ELb1EEEvPKfS2_iiiiiiiPfPi": 128,
             "_ZN5rfnet17nn_variant_kernelILi8ELb1ELb1EEEvPKfS2_iiiiiiiPfPi": 96,
             "_ZN5rfnet10fps_kernelILi4EEEvPKfiiPi": 40}
    (tmp_path / "build.log").write_text(
        "".join(PTXAS_LOG.format(k, k, v) for k, v in names.items()))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    regs = variants.ptxas_registers()
    assert regs[("nn_variant_kernel", (8, 1, 0))] == 80
    assert regs[("nn_scan_kernel", (0, 8))] == 72 and regs[("fps_kernel", (4,))] == 40
    want = {"v0 baseline": 8, "v1 fma": 24, "v2 eq-argmin": 16, "v3 fma+eq": 16}
    for name, fma, eq in variants.VARIANTS:
        plan = variants.plan_of(fma, eq, 32, 16384, 16384, SMS)
        got = variants.built_live_warps(16384, plan, fma, eq, regs)
        assert got == want[name]
        assert not (fma or eq) or got >= variants.variant_live_warps(16384, plan, eq)
    del regs[("nn_variant_kernel", (8, 1, 0))]
    with pytest.raises(SystemExit, match="no registers"):
        variants.built_live_warps(16384, variants.variant_plan(32, 16384, 16384, SMS), True,
                                  False, regs)

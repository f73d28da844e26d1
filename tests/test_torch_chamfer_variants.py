"""K9, the NN variant kernel of ``tools/bench_chamfer_variants.py``: the
port's plain version (``tools/bench_chamfer_variants_torch.py``) against the
JAX tool's Pallas kernel run in interpret mode, for all four variants, on
seeded numpy clouds; the wrapper's refusal of CPU tensors; and the
variant study's launch count. The kernel itself runs on the card only
(``tests/test_torch_gpu.py``)."""

import importlib.util
import os

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
    assert out["best"] in out["variants_ms"] and "bound_ms" not in out
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"tool"')


def _held_case():
    """(q, t, {variant: plain (dist, idx)}) at 16 000 queries, where one
    differing query is a share of 6.25e-5 and two are 1.25e-4."""
    rng = np.random.RandomState(101)
    q, t = (torch.from_numpy(rng.rand(2, k, 3).astype(np.float32)) for k in (8000, 64))
    return q, t, {name: variants.nn_variant_plain(q, t, fma=fma, eq_argmin=eq)
                  for name, fma, eq in variants.VARIANTS}


HELD = _held_case()


def _e_ulps(q, d, k):
    """``k`` ulps of e at each query, as ``hold_to_plain`` measures them."""
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


@pytest.mark.parametrize("case,fails", [
    ("exact", None),
    ("fma, one query one ulp", None),
    ("fma, one query two ulps", None),
    ("fma, two queries", "more than a share"),
    ("fma, one query three ulps", "two ulps of e"),
    ("fma, one index off", None),
    ("unfused, one query one ulp", "differ from the plain version"),
    ("unfused, one index off", "differ from the plain version"),
    ("v1 is v0", "the fma form did not run"),
    ("v3 is not v1", "v3 differs from v1"),
])
def test_hold_variants_rule(monkeypatch, case, fails):
    """The card's rule for K9 against its plain versions
    (``hold_variants``): the unfused variants bit for bit; the fma ones bit
    for bit but on a share of at most 1e-4 of the queries, each distance
    within two ulps of e; v3 equal to v1, v1 not to v0."""
    q, t, plain = HELD
    v0, v1, v2, v3 = (name for name, _, _ in variants.VARIANTS)
    outs = dict(plain)
    if case.startswith("fma, one query"):
        ulps = {"one": 1, "two": 2, "three": 3}[case.split()[3]]
        outs[v1] = outs[v3] = _moved(plain[v1], q, ulps, [5])
    elif case == "fma, two queries":
        outs[v1] = outs[v3] = _moved(plain[v1], q, 1, [5, 9000])
    elif case == "fma, one index off":
        # an index may differ on the allowed share where it realises the
        # distance: the target's duplicate at another index
        i = plain[v1][1].clone()
        j = int(i[0, 7])
        t = torch.cat([t, t[:, j:j + 1]], 1)
        i[0, 7] = t.shape[1] - 1
        outs = {k: (d, ix) for k, (d, ix) in plain.items()}
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
    elif case == "v3 is not v1":
        outs[v3] = _moved(plain[v3], q, 1, [5])
    if fails is None:
        held = variants.hold_variants(q, t, outs)
        assert max(v["differ"] for v in held.values()) <= variants.FMA_DIFFER
    else:
        with pytest.raises(SystemExit, match=fails):
            variants.hold_variants(q, t, outs)

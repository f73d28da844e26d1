"""The port's approximate EMD (``rfnet_tpu_torch/ops/emd.py``) against the JAX
package's ``rfnet_tpu/ops/emd.py`` on the same numpy inputs.

The port's CPU path is the plain recurrence (the card runs K6 for the
plan-free cost); the JAX functions run their XLA recurrence on the CPU.
Values are held to rtol 2e-5 and gradients to 2e-5 relative L2: the same
level recurrence in float32, with sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfnet_tpu.ops import emd as jemd
from rfnet_tpu_torch.ops import emd

RTOL = 2e-5


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_levels_and_capacities_match_jax():
    np.testing.assert_array_equal(np.float32(emd._levels()), np.asarray(jemd._levels()))
    for n, m in [(64, 64), (100, 32), (32, 100), (1024, 1000), (3, 7)]:
        assert emd._capacities(n, m) == jemd._capacities(n, m)
    # integer division, as the reference's CUDA ints
    assert emd._capacities(100, 32) == (1.0, 3.0)
    assert emd._capacities(32, 100) == (3.0, 1.0)


@pytest.mark.parametrize("b,n,m", [(2, 64, 64), (2, 100, 70), (1, 60, 130)])
def test_approx_match_cost_diff_value_and_grad_match_jax(rng, b, n, m):
    """The fused train-path cost (one pass of the recurrence with the
    gradient accumulated), at n = m, n > m and n < m."""
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    w = rng.rand(b).astype(np.float32)  # a cotangent that differs per cloud
    jf = lambda a, c: jnp.sum(jemd.approx_match_cost_diff(a, c) * w)  # noqa: E731
    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    t1, t2 = _t(x1, True), _t(x2, True)
    v = torch.sum(emd.approx_match_cost_diff(t1, t2) * _t(w))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=RTOL)
    assert _rel(t1.grad, jg[0]) < RTOL
    assert _rel(t2.grad, jg[1]) < RTOL


@pytest.mark.parametrize("b,n,m", [(2, 64, 64), (2, 100, 70)])
def test_approx_match_and_match_cost_match_jax(rng, b, n, m):
    """The plan (b, m, n) and the cost op with its hand-written gradient (the
    plan gets none); the composed pair equals the fused cost."""
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    plan = emd.approx_match(_t(x1), _t(x2))
    jplan = np.asarray(jemd.approx_match(jnp.asarray(x1), jnp.asarray(x2)))
    assert plan.shape == (b, m, n)
    np.testing.assert_allclose(plan.numpy(), jplan, rtol=1e-4, atol=2e-5)
    jv, jg = jax.value_and_grad(lambda a, c: jnp.sum(jemd.match_cost(a, c, jnp.asarray(jplan))),
                                argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    t1, t2, tp = _t(x1, True), _t(x2, True), _t(jplan, True)
    v = torch.sum(emd.match_cost(t1, t2, tp))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=RTOL)
    assert _rel(t1.grad, jg[0]) < RTOL and _rel(t2.grad, jg[1]) < RTOL
    assert tp.grad is None
    np.testing.assert_allclose(emd.approx_match_cost_diff(_t(x1), _t(x2)).numpy(),
                               emd.match_cost(_t(x1), _t(x2), plan).numpy(), rtol=RTOL)


@pytest.mark.parametrize("b,n,m", [(2, 700, 700), (1, 600, 530), (1, 530, 600)])
def test_approx_match_cost_matches_jax(rng, b, n, m, monkeypatch):
    """The eval's plan-free cost with n not a multiple of the 512-row chunk
    (the JAX CPU path pads it with zero-mass rows). The port's plain version
    is run on its whole-matrix path and on its ragged-chunk path."""
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    want = np.asarray(jemd.approx_match_cost(jnp.asarray(x1), jnp.asarray(x2)))
    whole = emd.approx_match_cost(_t(x1), _t(x2)).numpy()
    monkeypatch.setattr(emd, "_FULL_PATH_MAX_ELEMS", 1)
    chunked = emd.approx_match_cost(_t(x1), _t(x2)).numpy()
    assert whole.shape == (b,)
    np.testing.assert_allclose(whole, want, rtol=RTOL)
    np.testing.assert_allclose(chunked, want, rtol=RTOL)


def test_chunked_plan_equals_whole_plan_and_conserves_mass(rng, monkeypatch):
    """Ragged chunks carry no padded rows: the streamed plan equals the
    whole-matrix plan (to rtol 1e-4: sums over chunks round in another
    order), and every column holds the JAX plan's mass."""
    x1 = rng.rand(1, 100, 3).astype(np.float32)
    x2 = rng.rand(1, 32, 3).astype(np.float32)
    whole = emd.approx_match(_t(x1), _t(x2))
    monkeypatch.setattr(emd, "_FULL_PATH_MAX_ELEMS", 1)
    monkeypatch.setattr(emd, "_CHUNK", 32)
    chunked = emd.approx_match(_t(x1), _t(x2))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-4, atol=1e-7)
    jplan = np.asarray(jemd.approx_match(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(chunked.sum(2).numpy(), jplan.sum(2), rtol=1e-4, atol=1e-5)


def test_emd_rejects_bad_input(rng):
    x = _t(rng.rand(2, 10, 3).astype(np.float32))
    with pytest.raises(ValueError):
        emd.approx_match_cost(x, x[:1])
    with pytest.raises(ValueError):
        emd.approx_match_cost_diff(x[..., :2], x[..., :2])

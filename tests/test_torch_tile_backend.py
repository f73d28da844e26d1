"""The losses and eval metrics under the Morton "tile" backend (K8 in place of
K3), against the JAX package with its own backend switched the same way.

Inputs come from numpy with a seed and go to both packages; the JAX Pallas
kernels run in interpret mode, the port runs its kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rfnet_tpu.ops import chamfer as jchamfer
from rfnet_tpu_torch.ops import chamfer

VAL_RTOL = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _blobs(rng, b, n):
    """Clustered clouds: no near-zero NN distances, few near ties."""
    centers = rng.randn(6, 3).astype(np.float32)
    return np.stack([
        (centers[rng.randint(0, 6, n)] + 0.1 * rng.randn(n, 3)).astype(np.float32)
        for _ in range(b)
    ])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _means_weighted(means):
    return sum((k + 1.0) * m for k, m in enumerate(means))


@pytest.fixture
def tile_backend(monkeypatch):
    """Both packages' sorted-space backend set to "tile" (Morton sort + the
    best-first box-tile scan), restored afterwards."""
    monkeypatch.setattr(chamfer, "_NN_SORTED_BACKEND", "tile")
    monkeypatch.setattr(jchamfer, "_NN_SORTED_BACKEND", "tile")


def test_tile_backend_pair_value_and_grad_match_jax(rng, tile_backend, monkeypatch):
    """``chamfer_means_pair`` under the tile backend against the JAX fused
    pair with its backend set to "tile" (Pallas K8 and K5 in interpret mode),
    and against the port's own "dyn" backend: the per-cloud means sum the
    same per-point distances in another order, so values agree to rtol 1e-5
    and gradients to 1e-4 relative L2, not bit for bit."""
    from rfnet_tpu_torch.ops import chamfer_tile

    calls = []
    real = chamfer_tile.nn_tile
    monkeypatch.setattr(chamfer_tile, "nn_tile", lambda *a: calls.append(a[0].shape) or real(*a))
    gt, oa, ob = _blobs(rng, 2, 256), _blobs(rng, 2, 256), _blobs(rng, 2, 256)

    def tile(g, x, y):
        return _means_weighted(jchamfer._chamfer_means_pair_dyn(g, x, y))

    with pltpu.force_tpu_interpret_mode():
        jv, jg = jax.value_and_grad(tile, argnums=(0, 1, 2))(*map(jnp.asarray, (gt, oa, ob)))
    tg, ta, tb = _t(gt, True), _t(oa, True), _t(ob, True)
    v = _means_weighted(chamfer.chamfer_means_pair(tg, ta, tb))
    v.backward()
    assert [tuple(c) for c in calls] == [(4, 256, 3), (4, 256, 3)]  # K8's wrapper, both ways
    np.testing.assert_allclose(v.item(), float(jv), rtol=VAL_RTOL)
    for ours, ref in zip((tg, ta, tb), jg):
        assert _rel(ours.grad, ref) < 1e-4
    monkeypatch.setattr(chamfer, "_NN_SORTED_BACKEND", "dyn")
    dg, da, db = _t(gt, True), _t(oa, True), _t(ob, True)
    dv = _means_weighted(chamfer.chamfer_means_pair(dg, da, db))
    dv.backward()
    assert len(calls) == 2  # the dyn backend does not reach K8
    np.testing.assert_allclose(v.item(), dv.item(), rtol=VAL_RTOL)
    for ours, ref in zip((tg, ta, tb), (dg, da, db)):
        assert _rel(ours.grad, ref.grad) < 1e-4


def test_tile_backend_eval_metrics_match_jax(rng, tile_backend):
    """The eval's per-cloud CD means and the one-sided fidelity mean read the
    backend at call time too (JAX: its sorted path, interpret mode)."""
    a, b = _blobs(rng, 2, 200), _blobs(rng, 2, 260)
    m1, m2 = chamfer.chamfer_sample_means(_t(a), _t(b))
    f = chamfer.nn_sample_mean_one(_t(a), _t(b))
    with pltpu.force_tpu_interpret_mode():
        j1, j2 = jchamfer.chamfer_sample_means(jnp.asarray(a), jnp.asarray(b), True)
        jf = jchamfer.nn_sample_mean_one(jnp.asarray(a), jnp.asarray(b), True)
    for ours, ref in ((m1, j1), (m2, j2), (f, jf)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=VAL_RTOL)


def test_sorted_backend_defaults_to_dyn():
    assert chamfer._NN_SORTED_BACKEND == "dyn" == jchamfer._NN_SORTED_BACKEND
    assert chamfer._sorted_nn_fns() == (chamfer.sort_by_z_with_order, chamfer.nn_dyn)

"""The port's losses, schedules and gradient-carrying chamfer ops against the
JAX package's, on the same numpy inputs.

The JAX functions run on the CPU: on their dense path, and where a Pallas
kernel is the reference (K3's sorted path, K4, K5) in interpret mode. The
port runs its kernels' plain versions (CPU tensors).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rfnet_tpu import losses as jlosses
from rfnet_tpu.ops import chamfer as jchamfer
from rfnet_tpu.ops.pallas.chamfer import nn_distance_pallas
from rfnet_tpu.ops.pallas.nn_grad import nn_grad_scatter as j_nn_grad_scatter
from rfnet_tpu_torch import losses
from rfnet_tpu_torch.ops import chamfer
from rfnet_tpu_torch.ops.nn_grad import nn_grad_scatter


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


# Values: rtol 1e-5 (the JAX dense path expands |q|²+|t|²−2q·t through a
# matmul, the port's scans round in another order). Gradients: relative L2
# 2e-6 per cloud (each point's gradient is a unit vector over N, so the
# same argmins give the same gradient up to that rounding).
VAL_RTOL = 1e-5
GRAD_REL = 2e-6


@pytest.mark.parametrize("fn", ["chamfer_big", "fidelity_loss"])
def test_nn_distance_losses_value_and_grad_match_jax(rng, fn):
    a, b = _blobs(rng, 2, 200), _blobs(rng, 2, 260)
    jf = getattr(jlosses, fn)

    def jloss(x, y):
        v = jf(x, y)
        return v[0] if isinstance(v, tuple) else v

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a, True), _t(b, True)
    v = getattr(losses, fn)(ta, tb)
    if isinstance(v, tuple):
        v, idx1 = v
        np.testing.assert_array_equal(idx1.numpy(), np.asarray(jf(a, b)[1]))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=VAL_RTOL)
    assert _rel(ta.grad, jg[0]) < GRAD_REL
    assert _rel(tb.grad, jg[1]) < GRAD_REL


def _means_weighted(means):
    return sum((k + 1.0) * m for k, m in enumerate(means))


def test_chamfer_means_value_and_grad_match_jax_dense_and_sorted(rng):
    """The port's sorted K3 + K5 formulation against the JAX dense path
    and against JAX's own sorted path ``_chamfer_means_dyn`` (Pallas K3 and
    K5 in interpret mode): values rtol 1e-5, gradients rel-L2 2e-6."""
    a, b = _blobs(rng, 2, 200), _blobs(rng, 2, 260)
    ja, jb = jnp.asarray(a), jnp.asarray(b)

    def dense(x, y):
        return _means_weighted(jchamfer.chamfer_means(x, y))

    def dyn(x, y):
        return _means_weighted(jchamfer._chamfer_means_dyn(x, y))

    refs = [jax.value_and_grad(dense, argnums=(0, 1))(ja, jb)]
    with pltpu.force_tpu_interpret_mode():
        refs.append(jax.value_and_grad(dyn, argnums=(0, 1))(ja, jb))
    ta, tb = _t(a, True), _t(b, True)
    v = _means_weighted(chamfer.chamfer_means(ta, tb))
    v.backward()
    for jv, jg in refs:
        np.testing.assert_allclose(v.item(), float(jv), rtol=VAL_RTOL)
        assert _rel(ta.grad, jg[0]) < GRAD_REL
        assert _rel(tb.grad, jg[1]) < GRAD_REL


def test_chamfer_means_pair_value_and_grad_match_jax_dense_and_sorted(rng):
    gt, oa, ob = _blobs(rng, 2, 256), _blobs(rng, 2, 256), _blobs(rng, 2, 256)
    args = tuple(map(jnp.asarray, (gt, oa, ob)))

    def dense(g, x, y):
        return _means_weighted(jchamfer.chamfer_means_pair(g, x, y))

    def dyn(g, x, y):
        return _means_weighted(jchamfer._chamfer_means_pair_dyn(g, x, y))

    refs = [jax.value_and_grad(dense, argnums=(0, 1, 2))(*args)]
    with pltpu.force_tpu_interpret_mode():
        refs.append(jax.value_and_grad(dyn, argnums=(0, 1, 2))(*args))
    tg, ta, tb = _t(gt, True), _t(oa, True), _t(ob, True)
    v = _means_weighted(chamfer.chamfer_means_pair(tg, ta, tb))
    v.backward()
    for jv, jg in refs:
        np.testing.assert_allclose(v.item(), float(jv), rtol=VAL_RTOL)
        for ours, ref in zip((tg, ta, tb), jg):
            assert _rel(ours.grad, ref) < GRAD_REL


def test_chamfer_means_pair_equals_two_chamfer_means_calls(rng):
    """The stacked pair computes chamfer_means(gt, out_a) ++ chamfer_means(gt,
    out_b): the same means, and the same gradients (gt's two halves summed)."""
    gt, oa, ob = _blobs(rng, 2, 128), _blobs(rng, 2, 128), _blobs(rng, 2, 128)
    pair = [_t(x, True) for x in (gt, oa, ob)]
    two = [_t(x, True) for x in (gt, oa, ob)]
    got = chamfer.chamfer_means_pair(*pair)
    want = (*chamfer.chamfer_means(two[0], two[1]), *chamfer.chamfer_means(two[0], two[2]))
    np.testing.assert_allclose([x.item() for x in got], [x.item() for x in want], rtol=1e-6)
    _means_weighted(got).backward()
    _means_weighted(want).backward()
    for p, q in zip(pair, two):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=1e-6, atol=1e-9)


def test_ground_truth_gets_no_gradient_and_no_scatter(rng, monkeypatch):
    """The dead direction: a cloud that needs no gradient costs no K5 call,
    so the pair loss scatters once and re_chamfer once."""
    calls = []
    real = chamfer.nn_grad_scatter
    monkeypatch.setattr(chamfer, "nn_grad_scatter",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    gt, oa, ob = _blobs(rng, 2, 256), _blobs(rng, 2, 256), _blobs(rng, 2, 256)
    tg, ta, tb = _t(gt), _t(oa, True), _t(ob, True)
    m = chamfer.chamfer_means_pair(tg, ta, tb)
    (_means_weighted(m) + losses.re_chamfer(tg, ta)).backward()
    assert sorted(map(tuple, calls)) == [(4, 256, 3), (16, 32, 3)]
    assert tg.grad is None and ta.grad is not None and tb.grad is not None


def test_re_chamfer_matches_jax(rng):
    """re_chamfer folded into the batch: value and gradient against the JAX
    function (sorted path on the CPU via force_dyn, interpret mode)."""
    gt, pred = _blobs(rng, 2, 256), _blobs(rng, 2, 256)
    f = lambda g, p: jlosses.re_chamfer(g, p, part=8)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        jv, jg = jax.value_and_grad(f, argnums=1)(jnp.asarray(gt), jnp.asarray(pred))
    tp = _t(pred, True)
    v = losses.re_chamfer(_t(gt), tp, part=8)
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=VAL_RTOL)
    assert _rel(tp.grad, jg) < GRAD_REL


def test_safe_sqrt_caps_the_derivative():
    x = torch.tensor([0.0, 1e-20, 4.0], requires_grad=True)
    y = losses._safe_sqrt(x)
    y.sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jlosses._safe_sqrt(v)))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(y.detach().numpy(), np.sqrt(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)
    assert float(x.grad[0]) == pytest.approx(1 / (2 * 1e-7))


def test_safe_sqrt_is_correctly_rounded():
    """``chamfer_big`` and ``fidelity_loss`` take the correctly rounded
    float32 root (numpy's, the IEEE one) and its capped derivative, bit for
    bit, where PyTorch's own CPU root is one ulp off on some inputs: card
    and CPU then return one value."""
    r = np.random.RandomState(0)
    x = np.concatenate([r.rand(1 << 17), 10.0 ** r.uniform(-12, 2, 1 << 17)]).astype(np.float32)
    tx = _t(x, True)
    y = losses._safe_sqrt(tx)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.sqrt(x))
    want = np.float32(1.0) / (np.float32(2.0) * np.maximum(np.sqrt(x), np.float32(1e-7)))
    np.testing.assert_array_equal(tx.grad.numpy(), want)
    a, b = _t(r.rand(2, 300, 3).astype(np.float32)), _t(r.rand(2, 300, 3).astype(np.float32))
    d1, _, d2, _ = chamfer.nn_distance(a, b)
    cd, _ = losses.chamfer_big(a, b)
    want = (np.sqrt(d1.numpy()).mean(dtype=np.float64) + np.sqrt(d2.numpy()).mean(dtype=np.float64)) / 2
    np.testing.assert_allclose(cd.item(), want, rtol=1e-6)
    assert losses.fidelity_loss(a, b).item() == torch.from_numpy(np.sqrt(d1.numpy())).mean().item()


def test_zero_groupnear_and_groupin_near_match_jax(rng):
    cens, raw = _blobs(rng, 2, 16), _blobs(rng, 2, 64)
    for scale in (0.01, 10.0):  # inside and outside the hinge
        mat = (scale * rng.randn(2, 16, 4, 3)).astype(np.float32)
        tm = _t(mat, True)
        v = losses.zero_groupnear(_t(cens), _t(raw), tm)
        jv, jg = jax.value_and_grad(jlosses.zero_groupnear, argnums=2)(
            jnp.asarray(cens), jnp.asarray(raw), jnp.asarray(mat))
        np.testing.assert_allclose(v.item(), float(jv), rtol=VAL_RTOL, atol=1e-12)
        v.backward()
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(float(losses.groupin_near(tm.detach())),
                                   float(jlosses.groupin_near(jnp.asarray(mat))), rtol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 0.1, 1e-4])
def test_schedules_match_jax(scale):
    steps = {0, 1, 2, 3, 10}
    for b in (50_000, 100_000, 150_000, 200_000):
        steps |= {int(b * scale) - 1, int(b * scale), int(b * scale) + 1}
    for step in sorted(s for s in steps if s >= 0):
        assert losses.learning_rate(step, scale) == pytest.approx(
            float(jlosses.learning_rate(step, scale)), rel=1e-7), step
        assert losses.decfactor_weight(step, scale) == pytest.approx(
            float(jlosses.decfactor_weight(step, scale)), rel=1e-7), step
    # strict >: the earlier value holds through the boundary itself
    assert losses.piecewise_constant(5, [5], [1.0, 2.0]) == 1.0
    assert losses.piecewise_constant(6, [5], [1.0, 2.0]) == 2.0


class _Outs(NamedTuple):
    points1_pre: object
    points2_pre: object
    out3: object
    out4: object
    final_move: object
    moves1: object
    moves2: object
    decfactor_sq: object


@pytest.mark.parametrize("step", [0, 160_000])
def test_total_loss_breakdown_and_grads_match_jax(rng, step):
    """total_loss on the same model outputs: every LossBreakdown term and the
    gradient of the total with respect to every output (the weights of
    losses.py:205-221, the α₁ schedule at both of its values)."""
    b, n1, n2, n = 2, 8, 32, 128
    gt = _blobs(rng, b, n)
    arrays = _Outs(
        points1_pre=_blobs(rng, b, n1), points2_pre=_blobs(rng, b, n2),
        out3=_blobs(rng, b, n), out4=_blobs(rng, b, n),
        final_move=(0.1 * rng.randn(b, n, 3)).astype(np.float32),
        moves1=(0.05 * rng.randn(b, n1, 4, 3)).astype(np.float32),
        moves2=(0.5 * rng.randn(b, n2, 4, 3)).astype(np.float32),
        decfactor_sq=rng.rand(3).astype(np.float32),
    )
    gt1, gt2 = gt[:, :n1], gt[:, :n2]

    def jtotal(outs):
        lb = jlosses.total_loss(outs, jnp.asarray(gt), jnp.asarray(gt1), jnp.asarray(gt2), step)
        return lb.total, lb

    (_, jlb), jg = jax.value_and_grad(jtotal, has_aux=True)(
        _Outs(*map(jnp.asarray, arrays)))
    touts = _Outs(*(_t(a, True) for a in arrays))
    lb = losses.total_loss(touts, _t(gt), _t(gt1), _t(gt2), step)
    lb.total.backward()
    assert lb._fields == jlb._fields
    for name in lb._fields:
        np.testing.assert_allclose(float(getattr(lb, name)), float(getattr(jlb, name)),
                                   rtol=2e-5, atol=1e-9, err_msg=name)
    assert float(lb.loss_d2) > 0.0  # the hinge is live for moves2
    for name, ours, ref in zip(_Outs._fields, touts, jg):
        assert _rel(ours.grad, ref) < 2e-5, name


@pytest.mark.parametrize("n", [64, 600])
def test_earth_mover_losses_match_jax(rng, n):
    """earth_mover (the fused differentiable cost) and earth_mover_eval (the
    plan-free cost, on the CPU its plain recurrence) per point, meaned over
    the batch, against the JAX functions; the train path's gradient too.
    rtol 2e-5: one recurrence in float32, sums in another order."""
    a, b = rng.rand(2, n, 3).astype(np.float32), rng.rand(2, n, 3).astype(np.float32)
    ta = _t(a, True)
    v = losses.earth_mover(ta, _t(b))
    v.backward()
    jv, jg = jax.value_and_grad(jlosses.earth_mover)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(v.item(), float(jv), rtol=2e-5)
    assert _rel(ta.grad, jg) < 2e-5
    np.testing.assert_allclose(float(losses.earth_mover_eval(_t(a), _t(b))),
                               float(jlosses.earth_mover_eval(jnp.asarray(a), jnp.asarray(b))),
                               rtol=2e-5)


def test_earth_mover_requires_equal_sizes(rng):
    a, b = _t(_blobs(rng, 1, 16)), _t(_blobs(rng, 1, 24))
    for fn in (losses.earth_mover, losses.earth_mover_eval):
        with pytest.raises(ValueError):
            fn(a, b)


@pytest.mark.parametrize("n,m", [(70, 150), (300, 64)])
def test_nn_dense_plain_matches_jax_kernel(rng, n, m):
    """K4's plain version against ``nn_distance_pallas`` (interpret mode):
    distances rtol 1e-5 / atol 1e-6, each index a nearest target."""
    q, t = _blobs(rng, 2, n), _blobs(rng, 2, m)
    d, i = chamfer.nn_dense(_t(q), _t(t))
    with pltpu.force_tpu_interpret_mode():
        kd, _ = nn_distance_pallas(jnp.asarray(q), jnp.asarray(t))
    np.testing.assert_allclose(d.numpy(), np.asarray(kd), rtol=1e-5, atol=1e-6)
    bd = np.sum((q.astype(np.float64)[:, :, None] - t[:, None]) ** 2, -1)
    picked = np.take_along_axis(bd, i.numpy()[..., None].astype(np.int64), 2)[..., 0]
    np.testing.assert_allclose(picked, bd.min(-1), rtol=1e-5, atol=1e-6)
    assert i.dtype == torch.int32


@pytest.mark.parametrize("case", ["banded", "all_to_one", "uniform"])
def test_nn_grad_plain_matches_jax_kernel(rng, case):
    """K5's plain version against ``nn_grad_scatter`` (interpret mode) and a
    float64 scatter, for the index layouts of tests/test_chamfer.py."""
    b, n, m = 2, 100, 140
    x1 = rng.rand(b, n, 3).astype(np.float32)
    g = rng.randn(b, n).astype(np.float32)
    idx = {
        "banded": np.clip((np.arange(n) * m // n)[None, :] + rng.randint(-9, 9, (b, n)), 0, m - 1),
        "all_to_one": np.full((b, n), m - 1),
        "uniform": rng.randint(0, m, (b, n)),
    }[case].astype(np.int32)
    sp, sw = nn_grad_scatter(_t(x1), _t(g), _t(idx), m)
    with pltpu.force_tpu_interpret_mode():
        jsp, jsw = j_nn_grad_scatter(jnp.asarray(x1), jnp.asarray(g), jnp.asarray(idx), m)
    osp, osw = np.zeros((b, m, 3)), np.zeros((b, m))
    for bi in range(b):
        np.add.at(osp[bi], idx[bi], g[bi, :, None].astype(np.float64) * x1[bi])
        np.add.at(osw[bi], idx[bi], g[bi].astype(np.float64))
    for ours, kern, exact in ((sp, jsp, osp), (sw, jsw, osw)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(kern), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), exact, rtol=1e-5, atol=1e-5)

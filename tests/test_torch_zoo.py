"""The rest of the port's public op API against the JAX package's: grouping,
interpolation, the auction assignment with ``emd_func``, random sampling, and
the exported names.

Inputs come from numpy with a seed and go to both packages. None of these
ops has a kernel in either package: plain PyTorch against plain JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rfnet_tpu.ops as jops
import rfnet_tpu_torch.ops as ops
from rfnet_tpu import losses as jlosses
from rfnet_tpu_torch import losses


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def test_ops_export_the_same_names():
    assert ops.__all__ == jops.__all__ and len(ops.__all__) == 20
    for name in ops.__all__:
        assert callable(getattr(ops, name))


# --------------------------------------------------------------------------- grouping


@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.05, 4), (2.0, 5)])
def test_query_ball_point_equals_jax(rng, radius, nsample):
    """First-nsample-in-index-order hits, the first hit repeated, index 0
    and count 0 for an empty ball (radius 0.05 leaves some), the count capped
    (radius 2.0 takes every point)."""
    x1, x2 = rng.rand(2, 60, 3).astype(np.float32), rng.rand(2, 17, 3).astype(np.float32)
    idx, cnt = ops.query_ball_point(radius, nsample, _t(x1), _t(x2))
    jidx, jcnt = jops.query_ball_point(radius, nsample, jnp.asarray(x1), jnp.asarray(x2))
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    if radius == 0.05:
        empty = cnt.numpy() == 0
        assert empty.any() and (idx.numpy()[empty] == 0).all()
    if radius == 2.0:
        assert (cnt.numpy() == nsample).all()
        assert (idx.numpy() == np.arange(nsample)).all()


def test_query_ball_point_clamps_zero_distance():
    """A query on a cloud point is at distance max(0, 1e-20), inside any
    positive radius."""
    x = np.random.RandomState(1).rand(1, 9, 3).astype(np.float32)
    idx, cnt = ops.query_ball_point(1e-6, 3, _t(x), _t(x))
    np.testing.assert_array_equal(cnt.numpy(), np.ones((1, 9), np.int32))
    np.testing.assert_array_equal(idx.numpy()[0, :, 0], np.arange(9))


def test_group_point_value_and_scatter_add_gradient(rng):
    pts = rng.rand(2, 30, 5).astype(np.float32)
    idx = rng.randint(0, 30, (2, 7, 4)).astype(np.int32)
    w = rng.rand(2, 7, 4, 5).astype(np.float32)
    tp = _t(pts, True)
    out = ops.group_point(tp, _t(idx))
    (out * _t(w)).sum().backward()
    jval = jops.group_point(jnp.asarray(pts), jnp.asarray(idx))
    jgrad = jax.grad(lambda p: jnp.sum(jops.group_point(p, jnp.asarray(idx)) * w))(
        jnp.asarray(pts))
    assert out.shape == (2, 7, 4, 5)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jval))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)


def _with_duplicates(rng, b, n):
    """A cloud in which every point appears twice: exact distance ties."""
    half = rng.rand(b, n // 2, 3).astype(np.float32)
    return np.concatenate([half, half], axis=1)


def test_knn_point_equals_jax_with_ties(rng):
    """Negated squared distances, nearest first; among the duplicated points'
    exact ties the lower index comes first, as ``lax.top_k`` orders them."""
    x1, x2 = _with_duplicates(rng, 2, 40), rng.rand(2, 11, 3).astype(np.float32)
    val, idx = ops.knn_point(6, _t(x1), _t(x2))
    jval, jidx = jops.knn_point(6, jnp.asarray(x1), jnp.asarray(x2))
    assert idx.dtype == torch.int32 and (val.numpy() <= 0).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-6, atol=1e-7)
    # each pair of copies is adjacent, the lower index first
    np.testing.assert_array_equal(idx.numpy()[..., 1::2], idx.numpy()[..., 0::2] + 20)


# --------------------------------------------------------------------------- interpolate


def test_three_nn_equals_jax_with_ties(rng):
    x1, x2 = rng.rand(2, 25, 3).astype(np.float32), _with_duplicates(rng, 2, 30)
    t1 = _t(x1, True)
    dist, idx = ops.three_nn(t1, _t(x2))
    jdist, jidx = jops.three_nn(jnp.asarray(x1), jnp.asarray(x2))
    assert idx.dtype == torch.int32 and not dist.requires_grad  # no gradient
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6, atol=1e-7)
    assert (np.diff(dist.numpy(), axis=-1) >= 0).all()  # ascending
    # the nearest point's copy ties it exactly and follows it: lower index first
    np.testing.assert_array_equal(idx.numpy()[..., 1], idx.numpy()[..., 0] + 15)


def test_three_interpolate_value_and_gradients(rng):
    """The gradient goes to ``points`` only: the weight's is exactly zero,
    as the reference registers it, and matches the JAX custom VJP."""
    pts = rng.rand(2, 12, 4).astype(np.float32)
    idx = rng.randint(0, 12, (2, 20, 3)).astype(np.int32)
    idx[:, 0] = 5  # one source point three times in one row
    w = rng.rand(2, 20, 3).astype(np.float32)
    g = rng.randn(2, 20, 4).astype(np.float32)
    tp, tw = _t(pts, True), _t(w, True)
    out = ops.three_interpolate(tp, _t(idx), tw)
    (out * _t(g)).sum().backward()

    def f(p, wt):
        return jnp.sum(jops.three_interpolate(p, jnp.asarray(idx), wt) * g)

    jout = jops.three_interpolate(jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(w))
    jgp, jgw = jax.grad(f, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-5, atol=1e-6)
    assert (tw.grad.numpy() == 0).all() and (np.asarray(jgw) == 0).all()


# --------------------------------------------------------------------------- auction


def _is_permutation(m):
    return all(sorted(row.tolist()) == list(range(m.shape[1])) for row in m)


def _assignment_cost(x1, x2, matchl):
    matched = np.take_along_axis(x2, matchl[..., None].astype(np.int64), axis=1)
    return np.sqrt(((x1.astype(np.float64) - matched) ** 2).sum(-1)).sum(-1)


def test_auction_match_equals_jax(rng):
    """Two seeded clouds of 64 points, batched: the port runs the same Jacobi
    rounds on the same float32 costs, so the assignment is JAX's own. The
    two clouds end after different numbers of rounds, so the finished one's
    state must stay frozen while the other goes on."""
    x1, x2 = rng.rand(2, 64, 3).astype(np.float32), rng.rand(2, 64, 3).astype(np.float32)
    x1[1], x2[1] = x1[1] * 3.0, x2[1][::-1] * 3.0
    matchl, matchr = ops.auction_match(_t(x1), _t(x2))
    jl, jr = jops.auction_match(jnp.asarray(x1), jnp.asarray(x2))
    assert matchl.dtype == torch.int32 and matchr.dtype == torch.int32
    assert _is_permutation(matchl.numpy()) and _is_permutation(matchr.numpy())
    np.testing.assert_array_equal(
        np.take_along_axis(matchr.numpy(), matchl.numpy().astype(np.int64), 1),
        np.broadcast_to(np.arange(64), (2, 64)))
    np.testing.assert_array_equal(matchl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(matchr.numpy(), np.asarray(jr))
    # and a batch of one gives each cloud's rows: no state leaks across clouds
    for k in range(2):
        one, _ = ops.auction_match(_t(x1[k : k + 1]), _t(x2[k : k + 1]))
        np.testing.assert_array_equal(one.numpy()[0], matchl.numpy()[k])
    # ε-optimal: within n·ε of the optimum, so no worse than the identity
    cost = _assignment_cost(x1, x2, matchl.numpy())
    assert (cost <= _assignment_cost(x1, x2, np.broadcast_to(np.arange(64), (2, 64)))).all()


def test_auction_match_round_cutoff_still_gives_permutations(rng):
    """Cut off after 3 rounds, the straggler fill pairs the unassigned bidders
    with the unclaimed objects in index order, as the JAX function does."""
    x1, x2 = rng.rand(2, 48, 3).astype(np.float32), rng.rand(2, 48, 3).astype(np.float32)
    matchl, matchr = ops.auction_match(_t(x1), _t(x2), max_rounds=3)
    jl, jr = jops.auction_match(jnp.asarray(x1), jnp.asarray(x2), max_rounds=3)
    assert _is_permutation(matchl.numpy()) and _is_permutation(matchr.numpy())
    np.testing.assert_array_equal(matchl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(matchr.numpy(), np.asarray(jr))


def test_auction_match_shape_errors():
    a = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="equal-size"):
        ops.auction_match(a, torch.zeros(1, 9, 3))
    with pytest.raises(ValueError, match="4096"):
        ops.auction_match(torch.zeros(1, 4097, 3), torch.zeros(1, 4097, 3))


def test_emd_func_matches_jax(rng):
    pred, gt = rng.rand(2, 64, 3).astype(np.float32), rng.rand(2, 64, 3).astype(np.float32)
    got = losses.emd_func(_t(pred), _t(gt))
    want = jlosses.emd_func(jnp.asarray(pred), jnp.asarray(gt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# --------------------------------------------------------------------------- sampling


def test_random_sampling_contract(rng):
    """``sampling('r')`` cannot reproduce ``jax.random.permutation``'s values;
    it holds the contract: one vector of ``npoint`` distinct in-range indices
    shared by every cloud, reproducible from the generator's seed, the points
    gathered at it; and a generator is required, as the JAX key is."""
    xyz = rng.rand(3, 50, 3).astype(np.float32)
    idx, pts = ops.sampling(12, _t(xyz), "r", generator=torch.Generator().manual_seed(5))
    assert idx.shape == (3, 12) and idx.dtype == torch.int32 and pts.shape == (3, 12, 3)
    row = idx.numpy()[0]
    assert len(set(row.tolist())) == 12 and row.min() >= 0 and row.max() < 50
    assert (idx.numpy() == row).all()
    np.testing.assert_array_equal(pts.numpy(), xyz[:, row])
    again, _ = ops.sampling(12, _t(xyz), "r", generator=torch.Generator().manual_seed(5))
    other, _ = ops.sampling(12, _t(xyz), "r", generator=torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(idx.numpy(), again.numpy())
    assert (idx.numpy() != other.numpy()).any()
    jidx, _ = jops.sampling(12, jnp.asarray(xyz), "r", key=jax.random.PRNGKey(5))
    assert np.asarray(jidx).shape == (3, 12) and (np.asarray(jidx) == np.asarray(jidx)[0]).all()
    with pytest.raises(ValueError, match="Generator"):
        ops.sampling(12, _t(xyz), "r")
    with pytest.raises(ValueError, match="unknown"):
        ops.sampling(12, _t(xyz), "x", generator=torch.Generator())

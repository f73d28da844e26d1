"""K2/K4's launch plan and target split, in plain Python and torch on the CPU.

K2 and K4 (``csrc/nn_scan.cuh``) cannot run without a card. Their launch plan
(:func:`chamfer._nn_scan_plan`) is plain Python and is checked here at every
shape the serving path, the train step and its eval launch, and at the
edges. :func:`_split_merge` models the kernel's split and merge in torch ops:
the C CTAs' ranges, their tiles and the W warps' shares of each tile, each
share scanned for its first least ``e`` (its partial), the partials merged by
least ``e`` then least index. It must equal the plain scan
(:func:`chamfer._one_sided`) bit for bit under every plan, with duplicate
targets on both sides of every split boundary; and the plain scan and the
model must match the JAX package's Pallas kernels, run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rfnet_tpu.ops.pallas.chamfer import nn_coords_pallas, nn_distance_pallas
from rfnet_tpu_torch.ops import chamfer

SMS = 132  # an H100 SXM
INF = float("inf")

# (b, n, m) of every K2 and K4 launch on the main paths: the merge layer's
# three scans at the serving batch 4 and the train batch 32 (serve, step and
# eval), and zero_groupnear's two scans of the train step
MAIN = [(b, n, 3000) for b in (4, 32) for n in (64, 1024, 16384)] + [
    (32, 16384, 1024), (32, 1024, 64)]
# n = 1; n not a multiple of 32 R; m = 1; m beyond what one CTA holds in
# shared memory; b = 1 with n = 64; b = 64
EDGES = [(1, 1, 3000), (2, 333, 3000), (3, 100, 1), (64, 16384, 40000), (1, 300, 20000),
         (1, 64, 3000), (64, 64, 3000)]


def _cdiv(a, b):
    return -(-a // b)


def _splits(m, plan):
    """The target indices each warp scans, in its scan order, as
    csrc/nn_scan.cuh cuts them: CTA ``rank`` of C holds the contiguous
    range [rank·chunk, (rank+1)·chunk) of the cloud, staged in ``tiles``
    tiles; warp ``w`` of W scans the w-th contiguous 1/W of every tile."""
    _, _, w, c, tiles = plan
    chunk = _cdiv(m, c)
    tile = _cdiv(chunk, tiles)
    out = []
    for rank in range(c):
        lo = min(m, rank * chunk)
        length = min(m, lo + chunk) - lo
        for wi in range(w):
            js = []
            for k in range(_cdiv(length, tile)):
                cnt = min(tile, length - k * tile)
                sub = _cdiv(cnt, w)
                s = min(cnt, wi * sub)
                js.extend(range(lo + k * tile + s, lo + k * tile + min(cnt, s + sub)))
            out.append(js)
    return out


def _split_merge(q, t, plan):
    """(dist² (b,n), idx (b,n) int32) of q into t as K2/K4 compute them
    under ``plan``: each warp's partial is the first least e over its share
    (+inf and index 0 where it has none, or where its least is +inf, as the
    kernel's strict < never moves from its start), and the partials merge by
    least e, then least index."""
    b, n, _ = q.shape
    s2 = chamfer._sq3(t)
    best = torch.full((b, n), INF)
    best_j = torch.zeros((b, n), dtype=torch.int32)
    for js in _splits(t.shape[1], plan):
        if not js:
            continue
        js = torch.tensor(js)
        pe, a = chamfer._pairwise_e(q, t[:, js], s2[:, js]).min(dim=-1)
        pj = torch.where(pe < INF, js[a], 0).to(torch.int32)
        take = (pe < best) | ((pe == best) & (pj < best_j))
        best = torch.where(take, pe, best)
        best_j = torch.where(take, pj, best_j)
    return torch.clamp(best + chamfer._sq3(q), min=0.0), best_j


def _ctas(b, n, plan):
    r, g, _, c, _ = plan
    return b * _cdiv(n, 32 * r * g) * c


@pytest.mark.parametrize("sms", [SMS, 78, 8])
@pytest.mark.parametrize("b,n,m", MAIN + EDGES)
def test_nn_scan_plan(b, n, m, sms):
    plan = chamfer._nn_scan_plan(b, n, m, sms)
    r, g, w, c, tiles = plan
    assert r in (4, 8) and tiles >= 1
    for x in (g, w, c):
        assert x & (x - 1) == 0 and 1 <= x <= 8
    assert g * w <= 8 and _ctas(b, n, plan) % c == 0
    # every target lies in exactly one warp's share
    js = sorted(j for share in _splits(m, plan) for j in share)
    assert js == list(range(m))
    assert chamfer._nn_scan_shared(m, plan) <= 232448
    # whole ranges stay resident; only a range that overfills a CTA is tiled
    assert (tiles > 1) == (_cdiv(m, c) * 16 + 8 * 32 * r * g * w * (w * c > 1) > 232448)
    qw = _cdiv(n, 32 * r)
    if b * _cdiv(n, 256) >= 8 * sms:
        # the queries alone fill the card: eight a thread, no chain is cut
        assert plan == (8, 8, 1, 1, tiles) or (r, w, c) == (8, 1, 1)
    elif n <= 1024 and m >= 16 * chamfer._NN_SCAN_MIN_CHAIN:
        # few queries against enough targets to split sixteen ways: as many
        # CTAs as SMs, where clusters of eight allow that
        assert _ctas(b, n, plan) >= min(sms, b * qw * 8)
    # the warps of a CTA split first; clusters only beyond eight
    assert c == 1 or (c == 8 and w * c > 8)
    if w * c > 1:
        assert _cdiv(m, w * c) >= chamfer._NN_SCAN_MIN_CHAIN


def test_nn_scan_plans_on_the_main_paths():
    """The plans an H100 gets on the main paths (the numbers PERF.md cites)."""
    got = {shape: chamfer._nn_scan_plan(*shape, SMS) for shape in MAIN}
    assert got == {
        (4, 64, 3000): (4, 1, 8, 8, 1), (4, 1024, 3000): (4, 1, 8, 8, 1),
        (4, 16384, 3000): (4, 2, 4, 1, 1), (32, 64, 3000): (4, 1, 8, 8, 1),
        (32, 1024, 3000): (4, 1, 8, 1, 1), (32, 16384, 3000): (8, 8, 1, 1, 1),
        (32, 16384, 1024): (8, 8, 1, 1, 1), (32, 1024, 64): (4, 1, 2, 1, 1),
    }


def _planted(seed, b, n, m, plan):
    """(q, t): random clouds whose targets on either side of every boundary
    between two warps' shares are copies of each other, and of the first
    target where a share ends, with a query on each copy: every such query
    ties between a lower and a higher index in different shares."""
    rng = np.random.RandomState(seed)
    t = rng.rand(b, m, 3).astype(np.float32)
    ends = sorted({s[-1] for s in _splits(m, plan) if s})
    pairs = [(e, e + 1) for e in ends if e + 1 < m] + [(0, e) for e in ends if e > 0]
    for lo, hi in pairs:
        t[:, hi] = t[:, lo]
    picks = [lo for lo, _ in pairs][: max(0, n - 1)]
    q = rng.rand(b, n, 3).astype(np.float32)
    q[:, 1 : 1 + len(picks)] = t[:, picks]
    return torch.from_numpy(q), torch.from_numpy(t)


# plans forced on small clouds: each R, W > 1, C > 1, both, the tiled range
# (m = 20 000 in three tiles, and two CTAs of two tiles with a short last
# one), more splits than targets
FORCED = [((2, 70, 3000), (4, 1, 1, 1, 1)), ((2, 70, 3000), (8, 2, 1, 1, 1)),
          ((1, 40, 3000), (4, 1, 8, 1, 1)), ((1, 40, 3000), (8, 1, 1, 8, 1)),
          ((2, 33, 3000), (4, 1, 8, 8, 1)), ((1, 20, 20000), (8, 1, 1, 1, 3)),
          ((1, 20, 2999), (4, 1, 2, 2, 2)), ((2, 5, 3), (4, 1, 8, 8, 1)),
          ((1, 1, 1), (8, 1, 1, 1, 1))]
# the plan of every main-path and edge shape, on at most 64 of its queries
NATURAL = [((min(b, 2), min(n, 64), m), chamfer._nn_scan_plan(b, n, m, SMS))
           for b, n, m in MAIN + EDGES if m <= 20000]


@pytest.mark.parametrize("shape,plan", FORCED + NATURAL)
def test_split_merge_equals_plain_scan(shape, plan):
    b, n, m = shape
    q, t = _planted(sum(shape), b, n, m, plan)
    d, i = _split_merge(q, t, plan)
    pd, pi = chamfer._one_sided(q, t)
    torch.testing.assert_close(d, pd, rtol=0, atol=0)
    torch.testing.assert_close(i, pi, rtol=0, atol=0)
    # each planted query sits on a lower copy and its higher one: the lower wins
    for k, j in enumerate(chamfer._gather_rows(t, pi)[0, 1:]):
        if torch.equal(j, q[0, 1 + k]):
            hits = (t[0] == q[0, 1 + k]).all(-1).nonzero()
            assert int(pi[0, 1 + k]) == int(hits.min())


@pytest.mark.parametrize("plan", [(4, 1, 8, 8, 1), (8, 1, 2, 2, 3), (4, 1, 1, 1, 1)])
def test_split_merge_all_equal_and_all_inf(plan):
    """One repeated point: index 0 everywhere. Targets so far out that every
    |t|² and so every e is +inf: index 0 and +inf, as the plain scan gives."""
    q = torch.from_numpy(np.random.RandomState(3).rand(2, 50, 3).astype(np.float32))
    for t in (torch.full((2, 3000, 3), 0.375), torch.full((2, 3000, 3), 1e20)):
        d, i = _split_merge(q, t, plan)
        pd, pi = chamfer._one_sided(q, t)
        torch.testing.assert_close(d, pd, rtol=0, atol=0)
        torch.testing.assert_close(i, pi, rtol=0, atol=0)
        assert int(i.abs().max()) == 0
    assert bool(torch.isinf(pd).all())


@pytest.mark.parametrize("b,n,m", [(1, 1, 3000), (2, 70, 1500)])
def test_split_merge_matches_jax(b, n, m):
    """n = 1, and n not a multiple of 32 R, with duplicates across the split
    boundaries of the shape's plan: the plain scan, the model and the
    port's CPU wrappers against ``nn_coords_pallas`` and
    ``nn_distance_pallas`` in interpret mode. Tolerance rtol 1e-5 / atol
    1e-6: the Pallas kernels round the expansion in another order (as in
    tests/test_torch_ops.py)."""
    plan = chamfer._nn_scan_plan(b, n, m, SMS)
    q, t = _planted(b + n, b, n, m, plan)
    with pltpu.force_tpu_interpret_mode():
        jd, jnn = nn_coords_pallas(jnp.asarray(q.numpy()), jnp.asarray(t.numpy()))
        kd, _ = nn_distance_pallas(jnp.asarray(q.numpy()), jnp.asarray(t.numpy()))
    md, mi = _split_merge(q, t, plan)
    cd, ci, cc = chamfer.nn_coords(q, t)
    dd, di = chamfer.nn_dense(q, t)
    for ours in (md, cd, dd):
        for theirs in (jd, kd):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mi, ci, rtol=0, atol=0)
    torch.testing.assert_close(di, ci, rtol=0, atol=0)
    torch.testing.assert_close(cc, chamfer._gather_rows(t, mi), rtol=0, atol=0)
    # each picked neighbour is a nearest one to the JAX kernel's distance
    picked = ((q.double() - cc.double()) ** 2).sum(-1).numpy()
    np.testing.assert_allclose(picked, np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(((q.double() - torch.from_numpy(np.array(jnn)).double()) ** 2)
                               .sum(-1).numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)

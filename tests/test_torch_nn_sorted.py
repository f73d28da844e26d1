"""The port's Morton sort and its two tile-pruned sorted-space scans (K7
``nn_pruned``, K8 ``nn_tile``) against the JAX package's.

Inputs come from numpy with a seed and go to both packages. The JAX Pallas
kernels run in interpret mode on the CPU; the port runs the kernels' plain
version (CPU tensors), the full scan. The kernels' pruning cannot run without
a card, so a numpy walk applies each kernel's skip rule in float32, with the
port's own tile boxes, and asserts that nothing it skips could have mattered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rfnet_tpu.ops import chamfer as jchamfer
from rfnet_tpu.ops.pallas import chamfer_tile as jtile
from rfnet_tpu.ops.pallas.chamfer_pruned import nn_pruned_pallas
from rfnet_tpu_torch.ops import chamfer, chamfer_pruned, chamfer_tile

INT_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _brute(q, t):
    """float64 squared distances (b, n, m)."""
    q, t = np.asarray(q, np.float64), np.asarray(t, np.float64)
    return np.sum((q[:, :, None] - t[:, None]) ** 2, -1)


def _cases():
    """The clouds of tests/test_chamfer.py's pruned- and tile-kernel tests."""
    rng = np.random.RandomState(100)
    centers = rng.randn(6, 3).astype(np.float32)
    cases = {}
    for n, m in [(300, 520)]:  # structured blobs, ragged sizes
        q = (centers[rng.randint(0, 6, n)] + 0.1 * rng.randn(n, 3)).astype(np.float32)[None]
        t = (centers[rng.randint(0, 6, m)] + 0.1 * rng.randn(m, 3)).astype(np.float32)[None]
        cases[f"blobs_{n}_{m}"] = (q, t)
    # a compact blob inside a spread target: the regime a z-slab prunes little in
    cases["blob_in_cloud"] = ((0.05 * rng.randn(90, 3)).astype(np.float32)[None],
                              (rng.rand(300, 3) * 2.0 - 1.0).astype(np.float32)[None])
    t = rng.rand(1, 64, 3).astype(np.float32)  # each target three times: exact ties
    cases["dup_targets"] = (rng.rand(1, 40, 3).astype(np.float32),
                            np.concatenate([t, t[:, ::-1], t], axis=1))
    # all points identical: the Morton normalisation divides by max(0, 1e-12)
    cases["all_equal"] = (np.full((1, 50, 3), 0.25, np.float32),
                          np.full((1, 70, 3), 0.75, np.float32))
    qf, tf = rng.rand(1, 100, 3).astype(np.float32), rng.rand(1, 130, 3).astype(np.float32)
    qf[..., 2] = 0.5
    tf[..., 2] = 0.5
    cases["equal_z_plane"] = (qf, tf)
    cases["ragged_batch"] = (rng.rand(3, 37, 3).astype(np.float32),
                             rng.randn(3, 411, 3).astype(np.float32))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_morton_code_and_sort_equal_jax(name):
    """Codes, sorted clouds and orders are the JAX function's exactly: the
    division and the power-of-two scale round the same way, both sorts are
    stable."""
    for x in CASES[name]:
        code = chamfer_tile.morton_code(_t(x))
        assert code.dtype == torch.int32
        np.testing.assert_array_equal(code.numpy(), np.asarray(jtile.morton_code(jnp.asarray(x))))
        xs, order = chamfer_tile.sort_by_morton_with_order(_t(x))
        jxs, jorder = jtile.sort_by_morton_with_order(jnp.asarray(x))
        assert order.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


def _check_sorted_scan(d, i, jd, qs, ts):
    """``d`` against float64 brute force (sums of squares, one float32
    rounding per op: 1e-6 relative) and against the JAX kernel's distances,
    whose |t|²−2q·t expansion carries an absolute error of a few float32 ulps
    of |q|²+|t|² (rtol 1e-5, atol 2e-7·max(|q|²+|t|²): 1.2e-6 in the unit
    cube); ``i`` equal to the float64 argmin wherever the nearest target is
    not tied within that rounding."""
    norm = float((np.asarray(qs, np.float64) ** 2).sum(-1).max()
                 + (np.asarray(ts, np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=2e-7 * norm)
    bd = _brute(qs, ts)
    np.testing.assert_allclose(d, bd.min(-1), rtol=1e-6, atol=1e-12)
    two = np.sort(bd, axis=-1)[..., :2]
    untied = two[..., 1] - two[..., 0] > 1e-5 * two[..., 1]
    assert untied.any() or bd.shape[-1] == 1 or np.all(two[..., 0] == two[..., 1])
    np.testing.assert_array_equal(i[untied], bd.argmin(-1)[untied])


@pytest.mark.parametrize("name", sorted(CASES))
def test_nn_pruned_matches_jax_kernel(name):
    q, t = CASES[name]
    qs, _ = chamfer.sort_by_z_with_order(_t(q))
    ts, _ = chamfer.sort_by_z_with_order(_t(t))
    d, i = chamfer_pruned.nn_pruned(qs, ts)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    with pltpu.force_tpu_interpret_mode():
        jd, _ = nn_pruned_pallas(jnp.asarray(qs.numpy()), jnp.asarray(ts.numpy()))
        ud_j, _ = jchamfer.nearest_neighbor_pruned(jnp.asarray(q), jnp.asarray(t))
    _check_sorted_scan(d.numpy(), i.numpy(), jd, qs.numpy(), ts.numpy())
    # on the same z-sorted inputs K7's result is K3's, bit for bit
    dd, di = chamfer.nn_dyn(qs, ts)
    np.testing.assert_array_equal(d.numpy(), dd.numpy())
    np.testing.assert_array_equal(i.numpy(), di.numpy())
    ud, ui = chamfer_pruned.nearest_neighbor_pruned(_t(q), _t(t))
    _check_sorted_scan(ud.numpy(), ui.numpy(), ud_j, q, t)


@pytest.mark.parametrize("name", sorted(CASES))
def test_nn_tile_matches_jax_kernel(name):
    q, t = CASES[name]
    qs, _ = chamfer_tile.sort_by_morton_with_order(_t(q))
    ts, _ = chamfer_tile.sort_by_morton_with_order(_t(t))
    d, i = chamfer_tile.nn_tile(qs, ts)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    with pltpu.force_tpu_interpret_mode():
        jd, ji = jtile.nn_tile_pallas(jnp.asarray(qs.numpy()), jnp.asarray(ts.numpy()))
        ud_j, _ = jchamfer.nearest_neighbor_tile(jnp.asarray(q), jnp.asarray(t))
    _check_sorted_scan(d.numpy(), i.numpy(), jd, qs.numpy(), ts.numpy())
    if name in ("dup_targets", "all_equal"):
        # exact ties: the lowest index in sorted space, as the JAX kernel's
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(i.numpy(), _brute(qs.numpy(), ts.numpy()).argmin(-1))
    ud, ui = chamfer.nearest_neighbor_tile(_t(q), _t(t))
    _check_sorted_scan(ud.numpy(), ui.numpy(), ud_j, q, t)
    # the three op-level scans return one distance, bit for bit
    np.testing.assert_array_equal(ud.numpy(), chamfer.nearest_neighbor_dyn(_t(q), _t(t))[0].numpy())
    np.testing.assert_array_equal(
        ud.numpy(), chamfer_pruned.nearest_neighbor_pruned(_t(q), _t(t))[0].numpy())


def test_tile_boxes_cover_ragged_tiles():
    ts = _t(CASES["ragged_batch"][1])  # 411 points: 7 tiles of 64, the last of 27
    boxes = chamfer._tile_boxes(ts, 64).numpy()
    assert boxes.shape == (3, 7, 6) and np.isfinite(boxes).all()
    for k in range(7):
        pts = ts.numpy()[:, 64 * k : 64 * (k + 1)]
        np.testing.assert_array_equal(boxes[:, k, :3], pts.min(1))
        np.testing.assert_array_equal(boxes[:, k, 3:], pts.max(1))


def test_sorted_scans_reject_bad_input():
    q = _t(np.random.RandomState(0).rand(1, 10, 3).astype(np.float32))
    for fn in (chamfer_pruned.nn_pruned, chamfer_tile.nn_tile):
        with pytest.raises(ValueError):
            fn(q.double(), q.double())
        with pytest.raises(ValueError):
            fn(q, torch.cat([q, q]))
        with pytest.raises(ValueError):
            fn(q, q[:, :0])


# ---------------------------------------------------------------------------
# The kernels' skip rules, walked in numpy float32
# ---------------------------------------------------------------------------


def _sq3(g):
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


def _d32(q, t):
    """(nq, nt) float32 distances, rounded after every op as the kernels do."""
    return _sq3(q[:, None, :] - t[None, :, :])


def _point_box(q, box):
    return _sq3(np.maximum(np.maximum(box[:3] - q, q - box[3:]), np.float32(0)))


def _scan(full, rows, base, cnt, want, best, best_j):
    for r in np.nonzero(want)[0]:
        for k in range(cnt):
            d, j = full[rows[r], base + k], base + k
            if d < best[r] or (d == best[r] and j < best_j[r]):
                best[r], best_j[r] = d, j


def _assert_skippable(full, rows, base, cnt, best, what):
    """No skipped pair is nearer than, or ties, a running best (a tie could
    hold a lower index)."""
    assert (full[rows][:, base : base + cnt] > best[:, None]).all(), what


def _walk_pruned(qs, ts, boxes, tile_n, tile_m):
    """csrc/nn_pruned.cu for one cloud; returns (dist, idx, tiles skipped)."""
    n, m = len(qs), len(ts)
    nt, mt = -(-n // tile_n), -(-m // tile_m)
    full = _d32(qs, ts)
    dist, idx, skipped = np.empty(n, np.float32), np.empty(n, np.int32), 0
    for ni in range(nt):
        rows = np.arange(ni * tile_n, min((ni + 1) * tile_n, n))
        best = np.full(len(rows), np.inf, np.float32)
        best_j = np.full(len(rows), INT_MAX, np.int64)
        for step in range(mt):
            phys = (ni * mt // nt + step) % mt
            base, cnt = phys * tile_m, min(tile_m, m - phys * tile_m)
            want = ~(_point_box(qs[rows], boxes[phys]) > best)
            _assert_skippable(full, rows[~want], base, cnt, best[~want], f"K7 tile {phys}")
            skipped += not want.any()
            _scan(full, rows, base, cnt, want, best, best_j)
        dist[rows], idx[rows] = best, best_j
    return dist, idx, skipped


def _walk_tile(qs, ts, boxes, tile_n, tile_m):
    """csrc/nn_tile.cu for one cloud; returns (dist, idx, tiles skipped)."""
    n, m = len(qs), len(ts)
    nt, mt = -(-n // tile_n), -(-m // tile_m)
    full = _d32(qs, ts)
    dist, idx, skipped = np.empty(n, np.float32), np.empty(n, np.int32), 0
    for ni in range(nt):
        rows = np.arange(ni * tile_n, min((ni + 1) * tile_n, n))
        qlo, qhi = qs[rows].min(0), qs[rows].max(0)
        gap = np.maximum(np.maximum(boxes[:, :3] - qhi, qlo - boxes[:, 3:]), np.float32(0))
        bounds = _sq3(gap)
        assert bounds.dtype == np.float32
        best = np.full(len(rows), np.inf, np.float32)
        best_j = np.full(len(rows), INT_MAX, np.int64)
        for _ in range(mt):
            arg = int(np.argmin(bounds))  # the first of equal bounds
            if not (~(bounds[arg] > best)).any():
                break
            bounds[arg] = np.inf
            base, cnt = arg * tile_m, min(tile_m, m - arg * tile_m)
            want = ~(_point_box(qs[rows], boxes[arg]) > best)
            _assert_skippable(full, rows[~want], base, cnt, best[~want], f"K8 tile {arg}")
            _scan(full, rows, base, cnt, want, best, best_j)
        for k in np.nonzero(np.isfinite(bounds))[0]:  # never visited
            base, cnt = k * tile_m, min(tile_m, m - k * tile_m)
            _assert_skippable(full, rows, base, cnt, best, f"K8 unvisited tile {k}")
            skipped += 1
        dist[rows], idx[rows] = best, best_j
    return dist, idx, skipped


@pytest.mark.parametrize("kernel", ["nn_pruned", "nn_tile"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_skip_rule_walk_is_exact(name, kernel):
    """Each kernel's control flow in float32 (tiles of 32 queries × 16
    targets, so the small clouds have many tiles): no skipped tile held a
    nearer or an equal-and-lower-index target, the result equals the full
    scan bit for bit, and structured clouds do skip."""
    q, t = CASES[name]
    sort_fn = (chamfer.sort_by_z_with_order if kernel == "nn_pruned"
               else chamfer_tile.sort_by_morton_with_order)
    walk = _walk_pruned if kernel == "nn_pruned" else _walk_tile
    qs, ts = sort_fn(_t(q))[0], sort_fn(_t(t))[0]
    boxes = chamfer._tile_boxes(ts, 16).numpy()
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    skipped = 0
    for b in range(q.shape[0]):
        d, i, s = walk(qs[b].numpy(), ts[b].numpy(), boxes[b], 32, 16)
        np.testing.assert_array_equal(d, pd[b].numpy())
        np.testing.assert_array_equal(i, pi[b].numpy())
        skipped += s
    if name.startswith("blobs") or name == "ragged_batch":
        assert skipped > 0
    if name == "blob_in_cloud" and kernel == "nn_tile":
        assert skipped > 0

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
from tiled_ties import planted_ties

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


def _box_box(qbox, boxes):
    """Squared gaps from the query box ``qbox`` (6,) to ``boxes`` (k, 6)."""
    return _sq3(np.maximum(np.maximum(boxes[:, :3] - qbox[3:], qbox[:3] - boxes[:, 3:]),
                           np.float32(0)))


def _box(x):
    return np.concatenate([x.min(0), x.max(0)])


def _assert_skippable(full, rows, base, cnt, best, what):
    """No skipped pair is nearer than, or ties, a running best (a tie could
    hold a lower index)."""
    assert (full[rows][:, base : base + cnt] > best[:, None]).all(), what


def _bitonic(keys):
    """csrc/nn_tiles.cuh's in-place bitonic sort of 64-bit keys, padded to a
    power of two with ~0, one (span, j) round at a time."""
    size = 1 << max(0, int(len(keys) - 1).bit_length())
    k = np.full(size, np.iinfo(np.uint64).max, np.uint64)
    k[: len(keys)] = keys
    lane = np.arange(size)
    span = 2
    while span <= size:
        j = span >> 1
        while j > 0:
            lo = lane[(lane ^ j) > lane]
            hi = lo ^ j
            a, c = k[lo], k[hi]
            swap = (a > c) == ((lo & span) == 0)
            k[lo[swap]], k[hi[swap]] = c[swap], a[swap]
            j >>= 1
        span <<= 1
    return k[: len(keys)]


def _keys(bounds):
    """(bound bits << 32) | tile: a bound is >= +0, so its bits order as it."""
    return (bounds.astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        np.arange(len(bounds), dtype=np.uint64)


def _walk(qs, ts, plan, best_first):
    """csrc/nn_tiles.cuh's walk for one cloud in float32: K8's sorted order
    (``best_first``) or K7's diagonal one, each warp's look-ahead by its
    query box and its largest best, the block staging the least step its
    warps want (decided before the current tile is scanned, as the kernel
    overlaps the copy), the warp's tile and chunk votes on point-to-box
    bounds, and chunk winners by strict < merged once a chunk by the tie
    rule. Asserts that nothing skipped could have mattered. Returns (dist,
    idx, chunks skipped, the tiles each block staged, in order)."""
    name = "nn_tile" if best_first else "nn_pruned"
    warps, tile_m = chamfer._nn_tiles_fit(name, len(qs), len(ts), plan)
    r = chamfer._NN_TILES_R
    n, m = len(qs), len(ts)
    full = _d32(qs, ts)
    cbox = chamfer._tile_boxes(_t(ts[None]), 32)[0].numpy()
    tbox = chamfer._tile_boxes(_t(ts[None]), tile_m)[0].numpy()
    mt = len(tbox)
    best = np.full(n, np.inf, np.float32)
    best_j = np.full(n, INT_MAX, np.int64)
    skipped, staged_log = 0, []
    for q0 in range(0, n, 32 * warps * r):
        wrows = [np.arange(q0 + w * 32 * r, min(q0 + (w + 1) * 32 * r, n)) for w in range(warps)]
        wrows = [w for w in wrows if len(w)]
        rows = np.concatenate(wrows)
        wboxes = [_box(qs[w]) for w in wrows]
        bounds = _box_box(_box(qs[rows]), tbox)
        if best_first:
            order = (_bitonic(_keys(bounds)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
        else:  # from the first tile whose top z reaches the middle query's z
            zmid = qs[(q0 + rows[-1]) // 2, 2]
            anchor = min(int(np.searchsorted(tbox[:, 5], zmid, side="left")), mt - 1)
            order = (anchor + np.arange(mt)) % mt

        def warp_next(w, wbox, start):
            wmax = best[w].max()
            for s0 in range(start, mt, 32):
                k = order[s0 : s0 + 32]
                past = bounds[k] > wmax if best_first else np.zeros(len(k), bool)
                want = ~past & ~(_box_box(wbox, tbox[k]) > wmax)
                if want.any():
                    return s0 + int(np.argmax(want))
                if past.any():
                    return mt
            return mt

        cur, staged = 0, []
        while True:
            nxt = min(warp_next(w, wb, cur + 1) for w, wb in zip(wrows, wboxes))
            k = order[cur]
            staged.append(int(k))
            base, cnt = k * tile_m, min(tile_m, m - k * tile_m)
            for w in wrows:
                if not (~(_point_box(qs[w], tbox[k]) > best[w])).any():
                    _assert_skippable(full, w, base, cnt, best[w], f"tile {k}")
                    skipped += -(-cnt // 32)
                    continue
                for j0 in range(base, base + cnt, 32):
                    cc = min(32, m - j0)
                    if not (~(_point_box(qs[w], cbox[j0 // 32]) > best[w])).any():
                        _assert_skippable(full, w, j0, cc, best[w], f"chunk at {j0}")
                        skipped += 1
                        continue
                    seg = full[w, j0 : j0 + cc]
                    ck = seg.argmin(1)  # the first least: strict < in ascending index
                    cb, j = seg[np.arange(len(w)), ck], j0 + ck
                    take = (cb < best[w]) | ((cb == best[w]) & (j < best_j[w]))
                    best[w[take]], best_j[w[take]] = cb[take], j[take]
            if nxt >= mt:
                break
            cur = nxt
        for k in sorted(set(range(mt)) - set(staged)):  # never staged
            base, cnt = k * tile_m, min(tile_m, m - k * tile_m)
            _assert_skippable(full, rows, base, cnt, best[rows], f"unstaged tile {k}")
            skipped += -(-cnt // 32)
        staged_log.append(staged)
    return best, best_j.astype(np.int32), skipped, staged_log


@pytest.mark.parametrize("plan", [(1, 32), (2, 64)])
@pytest.mark.parametrize("kernel", ["nn_pruned", "nn_tile"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_skip_rule_walk_is_exact(name, kernel, plan):
    """Each kernel's control flow in float32 (plans of 64 queries a block
    and one chunk a tile, or 128 in two warps and two chunks a tile, so the
    small clouds have many tiles): no skipped tile or chunk held a nearer or
    an equal-and-lower-index target, the result equals the full scan bit
    for bit, and structured clouds do skip."""
    q, t = CASES[name]
    sort_fn = (chamfer.sort_by_z_with_order if kernel == "nn_pruned"
               else chamfer_tile.sort_by_morton_with_order)
    qs, ts = sort_fn(_t(q))[0], sort_fn(_t(t))[0]
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    skipped = 0
    for b in range(q.shape[0]):
        d, i, s, _ = _walk(qs[b].numpy(), ts[b].numpy(), plan, kernel == "nn_tile")
        np.testing.assert_array_equal(d, pd[b].numpy())
        np.testing.assert_array_equal(i, pi[b].numpy())
        skipped += s
    if name.startswith("blobs") or name == "ragged_batch":
        assert skipped > 0
    if name == "blob_in_cloud" and kernel == "nn_tile":
        assert skipped > 0


@pytest.mark.parametrize("plan", [(1, 32), (1, 64), (2, 128)])
@pytest.mark.parametrize("kernel", ["nn_pruned", "nn_tile"])
def test_walk_planted_ties_lower_index_visited_later(kernel, plan):
    """The planted ties of the gpu test (``tiled_ties.planted_ties``):
    in both walks the tile holding the lower of two equally near targets is
    staged after the one holding the higher, and only the equality test
    keeps it; duplicates across a chunk boundary resolve to the lower copy."""
    q, t, want = planted_ties(plan[1])
    d, i, _, staged = _walk(q[0], t[0], plan, kernel == "nn_tile")
    pd, pi = chamfer._nn_sorted_plain(_t(q), _t(t))
    np.testing.assert_array_equal(i, want)
    np.testing.assert_array_equal(i, pi[0].numpy())
    np.testing.assert_array_equal(d, pd[0].numpy())
    assert staged[0].index(1) < staged[0].index(0)  # tile 1 (index tile_m + 7) first


@pytest.mark.parametrize("mt", [1, 2, 5, 16, 100, 1300])
def test_bitonic_order_equals_repeated_argmin(mt):
    """K8's one sort of (bound, tile) keys visits the tiles in the order of
    the earlier repeated argmin (least bound, lowest index on equal bounds, the
    taken one set to +inf), with many equal bounds and +0."""
    rng = np.random.RandomState(mt)
    bounds = (rng.randint(0, 7, mt) * np.float32(0.125)).astype(np.float32)
    spread = rng.rand(mt) < 0.3
    bounds[spread] = rng.rand(int(spread.sum())).astype(np.float32)
    left, argmins = bounds.copy(), []
    for _ in range(mt):
        a = int(np.argmin(left))  # the first of equal bounds
        argmins.append(a)
        left[a] = np.inf
    order = (_bitonic(_keys(bounds)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
    np.testing.assert_array_equal(order, argmins)
    np.testing.assert_array_equal(order, np.lexsort((np.arange(mt), bounds)))


@pytest.mark.parametrize("m", [1, 3000, 16384, 2097152, 2097153, 1 << 22, 1 << 25])
def test_nn_tiles_fit_widens_k8_tile_until_its_keys_fit(m):
    """The plan the kernels get at m targets: K8's tile is the narrowest
    doubling of its wrapper's whose two buffers and padded sort keys fit a
    block's shared memory (the kernel's own check in nn_tiles_launch); K7's
    tile is only cut to m."""
    for name, mod in (("nn_tile", chamfer_tile), ("nn_pruned", chamfer_pruned)):
        warps, tile_m = chamfer._nn_tiles_fit(name, 100, m, mod._PLAN)
        assert warps == min(mod._PLAN[0], 2) and tile_m % 32 == 0  # 100 queries, 64 a warp
        assert chamfer._nn_tiles_shared(name, m, tile_m) <= chamfer._NN_TILES_MAX_SHARED
        cut = min(mod._PLAN[1], -(-m // 32) * 32)
        if name == "nn_pruned" or m <= 2097152:
            assert tile_m == cut
        else:
            assert tile_m > cut and chamfer._nn_tiles_shared(name, m, tile_m // 2) > \
                chamfer._NN_TILES_MAX_SHARED


def test_nn_tiles_fit_refuses_k8_beyond_its_keys_and_mirrors_the_kernel():
    """Beyond 2^25 targets no tile K8 can take holds its keys, and the
    wrapper refuses before any launch; the Python mirrors of the kernel's
    constants (queries a thread, chunk, shared memory) equal the source's."""
    import os
    import re

    with pytest.raises(ValueError, match="more than its tiles can hold"):
        chamfer._nn_tiles_fit("nn_tile", 100, (1 << 25) + 1, chamfer_tile._PLAN)
    src = open(os.path.join(os.path.dirname(chamfer.__file__), os.pardir, "csrc",
                            "nn_tiles.cuh")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kR"] == chamfer._NN_TILES_R and const["kChunk"] == chamfer._NN_TILES_CHUNK
    static = re.search(r"kTilesStaticShared = kTilesMaxWarps \* \(1 \+ 6\) \* 4;", src)
    assert static and re.search(r"__shared__ int next_step\[kTilesMaxWarps\];", src)
    assert re.search(r"__shared__ float warp_box\[kTilesMaxWarps\]\[6\];", src)
    assert chamfer._NN_TILES_MAX_SHARED == \
        const["kTilesMaxShared"] - const["kTilesMaxWarps"] * 7 * 4

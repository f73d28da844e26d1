"""K3's slab walk and K1's launch plan, in plain PyTorch on the CPU.

K3 (``csrc/nn_dyn.cu``) cannot run without a card, so :func:`_walk` applies
its visit rule in float32 torch ops, one cloud at a time: blocks of
consecutive sorted queries, a start at the slab that holds the block's
middle query's z, the next slab taken before the current one is scanned,
each side stopped when no query of the block wants its frontier slab, and
inside a slab each warp's 32-target chunks skipped by their box. The walk
must equal the full plain scan bit for bit, and what it loads and scans must
cover each query's exact z-slab. K1's plan (cluster size, register or
streaming form) is plain Python; the 70 000-point FPS that K1 once refused
is held to the JAX package's. Imports JAX only in that test, so the card's
tests (``tests/test_torch_gpu.py``) take :func:`_walk` and the walk's cases
from here on a machine without it.
"""

import numpy as np
import pytest
import torch

from rfnet_tpu_torch.ops import chamfer, fps

INT_MAX = np.iinfo(np.int32).max
INF = float("inf")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _sq3(g):
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]


def _walk(qs, ts, slab, tile, warp_q, chunk):
    """csrc/nn_dyn.cu for one z-sorted cloud pair (n, 3) -> (m, 3), with
    ``tile`` queries a block, ``warp_q`` queries a warp and ``chunk`` targets
    a box test. Returns (dist, idx, loaded, scanned): ``loaded`` (n, m) marks
    the targets of the slabs a query's block loaded, ``scanned`` the pairs
    its warp scanned. Asserts on the way that every skip was exact."""
    n, m = len(qs), len(ts)
    full = _sq3(qs[:, None, :] - ts[None, :, :])  # (n, m), rounded per op as in K3
    tz = ts[:, 2].contiguous()
    ns = -(-m // slab)
    dist = torch.empty(n)
    idx = torch.empty(n, dtype=torch.int64)
    loaded = torch.zeros((n, m), dtype=torch.bool)
    scanned = torch.zeros((n, m), dtype=torch.bool)
    for r0 in range(0, n, tile):
        rows = torch.arange(r0, min(r0 + tile, n))
        qz = qs[rows, 2]
        zmid = qs[(r0 + int(rows[-1])) // 2, 2]
        best = torch.full((len(rows),), INF)
        best_j = torch.full((len(rows),), INT_MAX, dtype=torch.int64)
        cur = min(int(torch.searchsorted(tz, zmid.reshape(1))) // slab, ns - 1)
        up, dn = cur + 1, cur - 1
        while True:
            # the next slab, from the bests before this one is scanned
            zu = tz[up * slab] if up < ns else torch.tensor(0.0)
            zd = tz[(dn + 1) * slab - 1] if dn >= 0 else torch.tensor(0.0)
            gu = torch.clamp(zu - qz, min=0.0)
            gd = torch.clamp(qz - zd, min=0.0)
            want_up = up < ns and bool((~(gu * gu > best)).any())
            want_dn = dn >= 0 and bool((~(gd * gd > best)).any())
            if not want_up and up < ns:  # nothing beyond the up frontier matters
                assert (full[rows, up * slab:] > best[:, None]).all()
            if not want_dn and dn >= 0:
                assert (full[rows, : (dn + 1) * slab] > best[:, None]).all()
            nxt = None
            if want_up or want_dn:
                take_up = want_up and (not want_dn or bool((zu - zmid) <= (zmid - zd)))
                nxt = up if take_up else dn
                up, dn = (up + 1, dn) if take_up else (up, dn - 1)
            # scan slab `cur`, 32 targets (here `chunk`) at a time by each warp
            base, cnt = cur * slab, min(slab, m - cur * slab)
            loaded[rows, base : base + cnt] = True
            sb = torch.full((len(rows),), INF)
            sk = torch.zeros(len(rows), dtype=torch.int64)
            for c in range(base, base + cnt, chunk):
                pts = ts[c : min(c + chunk, base + cnt)]
                lo = torch.stack([pts[:, 0].min(), pts[:, 1].min(), pts[0, 2]])
                hi = torch.stack([pts[:, 0].max(), pts[:, 1].max(), pts[-1, 2]])
                for w0 in range(0, len(rows), warp_q):
                    w = slice(w0, w0 + warp_q)
                    q = qs[rows[w]]
                    bound = _sq3(torch.clamp(torch.maximum(lo - q, q - hi), min=0.0))
                    near = torch.minimum(best[w], sb[w])
                    d = full[rows[w], c : c + len(pts)]
                    if not bool((~(bound > near)).any()):
                        assert (d > near[:, None]).all()  # the skip was exact
                        continue
                    scanned[rows[w], c : c + len(pts)] = True
                    cmin = d.min(dim=1).values
                    carg = torch.argmin(d, dim=1)  # the first of equal distances
                    take = cmin < sb[w]
                    sb[w] = torch.where(take, cmin, sb[w])
                    sk[w] = torch.where(take, c + carg, sk[w])
            upd = (sb < best) | ((sb == best) & (sk < best_j))
            best = torch.where(upd, sb, best)
            best_j = torch.where(upd, sk, best_j)
            if nxt is None:
                break
            cur = nxt
        dist[rows], idx[rows] = best, best_j
    return dist, idx.to(torch.int32), loaded, scanned


def _z_sorted(a):
    a = np.asarray(a, np.float32)
    return a[np.argsort(a[:, 2], kind="stable")]


def _frontier_tie(slab):
    """Three slabs of targets, all far in x but the last of the lowest slab
    and the first of the highest, which lie at exactly one distance from
    every query. The walk starts in the highest slab and loads the middle
    one before it has a best; only the down side's equality test then
    reaches the lowest slab, whose target holds the lower index."""
    z = np.concatenate([np.linspace(0.0, 0.25, slab), np.linspace(0.3, 0.45, slab),
                        np.linspace(0.75, 1.0, slab)])
    t = np.stack([np.full(3 * slab, 5.0), np.zeros(3 * slab), z], -1).astype(np.float32)
    t[[slab - 1, 2 * slab], 0] = 0.0
    return np.tile(np.float32([0.0, 0.0, 0.5]), (10, 1)), t


def _cases():
    """(queries, targets), each z-sorted: tie-heavy and adversarial clouds."""
    rng = np.random.RandomState(60)
    centers = rng.randn(6, 3).astype(np.float32)
    blobs = [_z_sorted(centers[rng.randint(0, 6, k)] + 0.1 * rng.randn(k, 3)) for k in (300, 520)]
    blob = _z_sorted(0.05 * rng.randn(200, 3))
    spread = _z_sorted(rng.rand(700, 3) * 2.0 - 1.0)
    t = rng.rand(64, 3).astype(np.float32)
    dup = _z_sorted(np.concatenate([t, t[::-1], t]))  # each target three times
    line = np.zeros((900, 3), np.float32)
    line[:, 2] = np.sort(rng.rand(900))
    q_line = _z_sorted(np.stack([np.full(70, 0.2), 0.01 * rng.randn(70),
                                 0.45 + 0.1 * rng.rand(70)], -1))
    bound = _z_sorted(rng.rand(330, 3))
    for k in (31, 63, 95, 127, 159):  # duplicates on either side of slab boundaries
        bound[k + 1] = bound[k]
    q_bound = _z_sorted(np.concatenate([bound[::3], bound[5::7] + 1e-3]))
    flat_q, flat_t = rng.rand(100, 3).astype(np.float32), rng.rand(130, 3).astype(np.float32)
    flat_q[:, 2] = flat_t[:, 2] = 0.5
    return {
        "tie at the down frontier": _frontier_tie(32),
        "blobs": tuple(blobs),
        "blob->spread": (blob, spread),
        "spread->blob": (spread, blob),
        "dup targets": (_z_sorted(rng.rand(40, 3)), dup),
        "line, many slabs": (q_line, line),
        "duplicates across slab boundaries": (q_bound, bound),
        "all z equal": (flat_q, flat_t),
        "all points equal": (np.full((50, 3), 0.25, np.float32),
                             np.full((70, 3), 0.75, np.float32)),
        "m < slab, n < warp": (_z_sorted(rng.rand(5, 3)), _z_sorted(rng.rand(20, 3))),
        "one target": (_z_sorted(rng.rand(9, 3)), rng.rand(1, 3).astype(np.float32)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_equals_plain_scan_and_covers_the_z_slab(name):
    """Small slabs, blocks and warps (32 targets, 64 queries, 16 a warp, 8
    targets a box), so the small clouds have many of each: the walk equals
    the full plain scan bit for bit, it loads every target of each query's
    exact z-slab and scans every pair that is no farther than the result."""
    q, t = (_t(a) for a in CASES[name])
    d, i, loaded, scanned = _walk(q, t, slab=32, tile=64, warp_q=16, chunk=8)
    pd, pi = chamfer._nn_sorted_plain(q[None], t[None])
    torch.testing.assert_close(d, pd[0], rtol=0, atol=0)
    torch.testing.assert_close(i, pi[0], rtol=0, atol=0)
    dz = q[:, None, 2] - t[None, :, 2]
    assert not (((dz * dz) <= d[:, None]) & ~loaded).any()  # the exact z-slab was loaded
    full = _sq3(q[:, None, :] - t[None, :, :])
    assert not ((full <= d[:, None]) & ~scanned).any()
    if name == "line, many slabs":  # the walk crossed slabs on both sides and stopped early
        first = loaded.int().argmax(1)
        last = t.shape[0] - 1 - loaded.flip(1).int().argmax(1)
        own = torch.searchsorted(t[:, 2].contiguous(), q[:, 2].contiguous())
        assert int(((own - first) // 32).min()) >= 3 and int(((last - own) // 32).min()) >= 3
        assert int(first.min()) > 0 and int(last.max()) < t.shape[0] - 1
    if name in ("blobs", "blob->spread", "line, many slabs"):
        assert float(scanned.float().mean()) < 0.9  # and it skipped work


@pytest.mark.parametrize("name", ["blobs", "spread->blob", "duplicates across slab boundaries"])
def test_walk_at_the_kernels_sizes(name):
    """The kernel's own sizes: 128-target slabs, 256 queries a block, 64 a
    warp, 32 targets a box test (clouds tiled four times to span several
    slabs and blocks)."""
    q, t = (_t(np.concatenate([a + k * np.float32(0.01) for k in range(4)]))
            for a in CASES[name])
    q, t = chamfer.sort_by_z_with_order(q[None])[0][0], chamfer.sort_by_z_with_order(t[None])[0][0]
    d, i, _, _ = _walk(q, t, slab=chamfer._NN_DYN_SLAB, tile=256, warp_q=64, chunk=32)
    pd, pi = chamfer._nn_sorted_plain(q[None], t[None])
    torch.testing.assert_close(d, pd[0], rtol=0, atol=0)
    torch.testing.assert_close(i, pi[0], rtol=0, atol=0)


@pytest.mark.parametrize("b,n,want", [
    (4, 3000, (4, 4)), (32, 3000, (2, 8)), (32, 16384, (2, 32)), (20, 3000, (2, 8)),
    (40, 3000, (1, 16)), (100, 700, (1, 4)), (2, 37, (1, 1)), (1, 5000, (4, 8)),
    (1, 40000, (8, 32)), (1, 65536, (8, 32)), (1, 65537, (8, 0)), (1, 70000, (8, 0)),
    (200, 70000, (8, 0)),
])
def test_fps_plan(b, n, want):
    assert fps._fps_plan(b, n, 132) == want


@pytest.mark.parametrize("sms", [1, 8, 78, 132])
def test_fps_plan_holds_every_cloud(sms):
    """Every plan holds its cloud: a power-of-two cluster of at most 4 CTAs,
    8 only where 4 cannot hold the cloud, the fewest points a thread that
    hold it, the streaming form only beyond 8 x 256 x 32 points; the
    clusters take at most half the SMs unless the cloud needs more CTAs than
    that, or one CTA a cloud already overfills them."""
    for b in (1, 2, 3, 4, 16, 32, 64, 300):
        for n in (1, 5, 255, 256, 257, 3000, 16384, 40000, 65536, 65537, 200000):
            cluster, per = fps._fps_plan(b, n, sms)
            assert cluster in (1, 2, 4) or (cluster == 8 and n > 4 * fps._FPS_THREADS * 32)
            if per:
                room = cluster * fps._FPS_THREADS
                assert room * per >= n and (per == 1 or room * (per // 2) < n)
            else:
                assert cluster == 8 and n > 8 * fps._FPS_THREADS * 32
            if b * cluster > sms // 2 and cluster > 1:
                assert n > cluster // 2 * fps._FPS_THREADS * 32


def test_fps_70000_points_equals_jax():
    """The cloud size K1 once refused: the plain version equals the JAX
    package's ``farthest_point_sample`` index for index."""
    import jax.numpy as jnp

    from rfnet_tpu.ops import fps as jfps

    xyz = np.random.RandomState(70).rand(1, 70000, 3).astype(np.float32)
    ours = fps.farthest_point_sample(16, _t(xyz)).numpy()
    want = np.asarray(jfps.farthest_point_sample(16, jnp.asarray(xyz)))
    np.testing.assert_array_equal(ours, want)

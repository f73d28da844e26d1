"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips (from the ``cuda`` fixture) where there is no
CUDA device. Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from rfnet_tpu_torch import kernels
from rfnet_tpu_torch.ops import chamfer, fps
from tiled_ties import planted_ties

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _clouds(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(*s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("b,n,npoint", [(2, 200, 24), (3, 3000, 32), (1, 16384, 256), (2, 37, 37)])
def test_fps_kernel_equals_plain(cuda, b, n, npoint):
    (x,) = _clouds(0, (b, n, 3))
    before = kernels.launches["fps"]
    got = fps.farthest_point_sample(npoint, x.to(cuda)).cpu()
    assert kernels.launches["fps"] == before + 1
    torch.testing.assert_close(got, fps._fps_plain(x, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [(64, 3000), (1024, 3000), (70, 150), (1, 1), (16384, 3000),
                                 (300, 20000), (1, 3000), (3000, 7)])
def test_nn_coords_kernel_equals_plain(cuda, n, m):
    q, t = _clouds(1, (2, n, 3), (2, m, 3))
    kd, ki, kc = chamfer.nn_coords(q.to(cuda), t.to(cuda))
    pd, pi, pc = chamfer.nn_coords(q, t)  # CPU: the plain version
    # one op chain on both sides, each op rounded: bit-equal
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    torch.testing.assert_close(kc.cpu(), pc, rtol=0, atol=0)


def test_nn_coords_kernel_duplicate_targets_first_index(cuda):
    q, t = _clouds(2, (1, 50, 3), (1, 90, 3))
    t = torch.cat([t, t], 1)
    _, ki, _ = chamfer.nn_coords(q.to(cuda), t.to(cuda))
    assert int(ki.max()) < 90  # the lower copy wins every tie


def _sorted_cases():
    rng = np.random.RandomState(3)
    centers = rng.randn(6, 3).astype(np.float32)
    blobs = [
        (centers[rng.randint(0, 6, n)] + 0.1 * rng.randn(n, 3)).astype(np.float32)[None]
        for n in (300, 520)
    ]
    t = rng.rand(1, 64, 3).astype(np.float32)
    dup = np.concatenate([t, t[:, ::-1], t], axis=1)
    flat_q, flat_t = rng.rand(1, 100, 3).astype(np.float32), rng.rand(1, 130, 3).astype(np.float32)
    flat_q[..., 2] = 0.5
    flat_t[..., 2] = 0.5
    big = rng.rand(2, 16384, 3).astype(np.float32), rng.rand(2, 3000, 3).astype(np.float32)
    return [
        blobs,
        [rng.rand(1, 40, 3).astype(np.float32), dup],  # exact ties
        [flat_q, flat_t],  # all z equal: no pruning possible
        list(big),
    ]


@pytest.mark.parametrize("case", range(4))
def test_nn_dyn_kernel_equals_plain(cuda, case):
    q, t = (torch.from_numpy(a) for a in _sorted_cases()[case])
    qs, _ = chamfer.sort_by_z_with_order(q)
    ts, _ = chamfer.sort_by_z_with_order(t)
    before = kernels.launches["nn_dyn"]
    kd, ki = chamfer.nn_dyn(qs.to(cuda), ts.to(cuda))
    assert kernels.launches["nn_dyn"] == before + 1
    pd, pi = chamfer.nn_dyn(qs, ts)  # CPU: the full plain scan
    # same sum-of-squares chain, lowest index on ties: bit-equal
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)


def _tiled_cases():
    """The sorted-scan cases plus a blob inside a spread cloud (where a
    z-slab prunes little), all points equal, and ragged many-tile sizes."""
    rng = np.random.RandomState(12)
    blob = (0.05 * rng.randn(2, 900, 3)).astype(np.float32)
    spread = (rng.rand(2, 3000, 3) * 2.0 - 1.0).astype(np.float32)
    same = [np.full((1, 50, 3), 0.25, np.float32), np.full((1, 700, 3), 0.75, np.float32)]
    ragged = [rng.rand(3, 3000, 3).astype(np.float32), rng.rand(3, 16384, 3).astype(np.float32)]
    return _sorted_cases() + [[blob, spread], [spread, blob], same, ragged,
                              [rng.rand(1, 1, 3).astype(np.float32)] * 2]


# K7 / K8 plans (warps a block, targets a tile): one warp and four, one
# chunk a tile and many (None: the wrapper's own)
_TILE_PLANS = [None, (1, 32), (4, 128)]


@pytest.mark.parametrize("plan", _TILE_PLANS)
@pytest.mark.parametrize("case", range(9))
def test_nn_pruned_kernel_equals_plain_and_k3(cuda, case, plan):
    from rfnet_tpu_torch.ops import chamfer_pruned

    q, t = (torch.from_numpy(a) for a in _tiled_cases()[case])
    qs, _ = chamfer.sort_by_z_with_order(q)
    ts, _ = chamfer.sort_by_z_with_order(t)
    before = kernels.launches["nn_pruned"]
    kd, ki, _ = chamfer._nn_tiled("nn_pruned", qs.to(cuda), ts.to(cuda),
                                  plan or chamfer_pruned._PLAN)
    assert kernels.launches["nn_pruned"] == before + 1
    pd, pi = chamfer_pruned.nn_pruned(qs, ts)  # CPU: the full plain scan
    # same sum-of-squares chain, bounds that never exceed it, lowest index on
    # ties whatever the visit order: bit-equal to the plain scan and to K3
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    dd, di = chamfer.nn_dyn(qs.to(cuda), ts.to(cuda))
    torch.testing.assert_close(kd, dd, rtol=0, atol=0)
    torch.testing.assert_close(ki, di, rtol=0, atol=0)


# (warps, tile_m): the earlier (queries a block, targets a tile) of (128, 128),
# (256, 512), (32, 7) and (64, 4096), cut to what the kernel takes (64
# queries a warp, tiles of whole 32-target chunks), and one or two more warps
@pytest.mark.parametrize("tiles", [(1, 128), (2, 128), (2, 512), (4, 512),
                                   (1, 32), (2, 32), (1, 4096), (8, 64)])
@pytest.mark.parametrize("case", range(9))
def test_nn_tile_kernel_equals_plain(cuda, case, tiles):
    from rfnet_tpu_torch.ops import chamfer_tile

    q, t = (torch.from_numpy(a) for a in _tiled_cases()[case])
    qs, _ = chamfer_tile.sort_by_morton_with_order(q)
    ts, _ = chamfer_tile.sort_by_morton_with_order(t)
    before = kernels.launches["nn_tile"]
    kd, ki, _ = chamfer._nn_tiled("nn_tile", qs.to(cuda), ts.to(cuda), tiles)
    assert kernels.launches["nn_tile"] == before + 1
    pd, pi = chamfer_tile.nn_tile(qs, ts)  # CPU: the full plain scan
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    # exact for any order: unsorted clouds prune less and give the same answer
    ud, ui, _ = chamfer._nn_tiled("nn_tile", q.to(cuda), t.to(cuda), tiles)
    fd, fi = chamfer._nn_sorted_plain(q, t)
    torch.testing.assert_close(ud.cpu(), fd, rtol=0, atol=0)
    torch.testing.assert_close(ui.cpu(), fi, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["nn_pruned", "nn_tile"])
@pytest.mark.parametrize("plan", [(1, 32), (1, 64), (2, 128)])
def test_nn_tiled_kernels_planted_ties(cuda, kernel, plan):
    """Ties across a tile boundary that the walk meets lower index last, and
    across a chunk boundary: the lowest index wins (planted_ties)."""
    q, t, want = (torch.from_numpy(np.asarray(a)) for a in planted_ties(plan[1]))
    kd, ki, _ = chamfer._nn_tiled(kernel, q.to(cuda), t.to(cuda), plan)
    pd, pi = chamfer._nn_sorted_plain(q, t)
    assert torch.equal(pi[0].long(), want)
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["nn_pruned", "nn_tile"])
@pytest.mark.parametrize("plan", [None, (8, 64), (2, 256)])
def test_nn_tiled_kernels_unaligned_and_ragged(cuda, kernel, plan):
    """Clouds whose base is not 16-byte aligned (4 bytes past a boundary, and
    one point, 12 bytes, past one), n = 333 not a multiple of 64, and
    m = 3001 not a multiple of the tile or of a chunk: bit-equal to the plain
    scan; and the kernel's chunk and tile boxes equal the plain _tile_boxes."""
    from rfnet_tpu_torch.ops import chamfer_pruned, chamfer_tile

    plan = plan or {"nn_pruned": chamfer_pruned._PLAN, "nn_tile": chamfer_tile._PLAN}[kernel]
    sort_fn = chamfer.sort_by_z_with_order if kernel == "nn_pruned" else \
        chamfer_tile.sort_by_morton_with_order
    q, t = _clouds(81, (3, 333, 3), (3, 3001, 3))
    qs, ts = sort_fn(q)[0], sort_fn(t)[0]
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    for skip in (1, 3):  # floats before the cloud
        qa = torch.empty(skip + qs.numel(), device=cuda)[skip:].view(qs.shape).copy_(qs)
        ta = torch.empty(skip + ts.numel(), device=cuda)[skip:].view(ts.shape).copy_(ts)
        assert qa.data_ptr() % 16 == ta.data_ptr() % 16 == 4 * skip
        kd, ki, _ = chamfer._nn_tiled(kernel, qa, ta, plan)
        torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
        torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    # the box pre-pass alone: the scratch holds chunk boxes, then tile boxes
    b, m = ta.shape[0], ta.shape[1]
    warps, tile_m = chamfer._nn_tiles_fit(kernel, qa.shape[1], m, plan)
    mc, mt = -(-m // 32), -(-m // tile_m)
    boxes = torch.empty(b * (mc + mt) * 6, device=cuda)
    out = [torch.empty((b, qa.shape[1]), dtype=dt, device=cuda) for dt in (torch.float32,
                                                                            torch.int32)]
    visited = torch.empty((b, -(-qa.shape[1] // (64 * warps))), dtype=torch.int32, device=cuda)
    kernels.launch(kernel, cuda, qa, ta, boxes, b, qa.shape[1], m, warps, tile_m, *out, visited)
    torch.cuda.synchronize()
    assert torch.equal(boxes[:b * mc * 6].view(b, mc, 6).cpu(), chamfer._tile_boxes(ta.cpu(), 32))
    assert torch.equal(boxes[b * mc * 6:].view(b, mt, 6).cpu(),
                       chamfer._tile_boxes(ta.cpu(), tile_m))


@pytest.mark.parametrize("kernel", ["nn_pruned", "nn_tile"])
def test_nn_tiled_kernels_large(cuda, kernel):
    """b = 64 clouds of 16 384 (the losses' pair) under the wrapper's plan,
    and K8 with more than 1 024 tiles (40 000 targets, 32 a tile: 1 250
    keys, a sort of 2 048)."""
    from rfnet_tpu_torch.ops import chamfer_pruned, chamfer_tile

    sort_fn, plan = {"nn_pruned": (chamfer.sort_by_z_with_order, chamfer_pruned._PLAN),
                     "nn_tile": (chamfer_tile.sort_by_morton_with_order, chamfer_tile._PLAN)}[kernel]
    rng = np.random.RandomState(82)
    t = rng.rand(64, 16384, 3).astype(np.float32)
    t[..., 2] = 0.3 * np.sin(3 * t[..., 0]) * np.cos(2 * t[..., 1])
    q = (t + 0.005 * rng.randn(*t.shape)).astype(np.float32)
    qs, ts = (sort_fn(torch.from_numpy(x).to(cuda))[0] for x in (q, t))
    kd, ki, _ = chamfer._nn_tiled(kernel, qs, ts, plan)
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    if kernel == "nn_tile":
        q, t = _clouds(83, (2, 700, 3), (2, 40000, 3))
        qs, ts = (sort_fn(x.to(cuda))[0] for x in (q, t))
        for tiles in ((1, 32), (8, 32)):
            kd, ki, _ = chamfer._nn_tiled(kernel, qs, ts, tiles)
            pd, pi = chamfer._nn_sorted_plain(qs, ts)
            assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("m", [2097153, 1 << 25])
def test_nn_tile_widens_its_tile_to_fit_its_sort_keys(cuda, m):
    """K8 beyond 2 097 152 targets a cloud: the sort keys of 128-target
    tiles (16 385, padded to 32 768) do not fit shared memory, so the kernel
    refuses that plan, and the wrapper widens the tile (to 256; at 2^25, the
    most it takes, to 2 048) and is bit-equal to the plain scan."""
    from rfnet_tpu_torch.ops import chamfer_tile

    assert chamfer._nn_tiles_fit("nn_tile", 100, 2097152, chamfer_tile._PLAN) == (1, 128)
    warps, tile_m = chamfer._nn_tiles_fit("nn_tile", 100, m, chamfer_tile._PLAN)
    assert (warps, tile_m) == ((1, 256) if m == 2097153 else (1, 2048))
    q, t = _clouds(84, (1, 100, 3), (1, m, 3))
    qs, ts = (chamfer_tile.sort_by_morton_with_order(x.to(cuda))[0] for x in (q, t))
    kd, ki = chamfer_tile.nn_tile(qs, ts)
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    tile_m //= 2  # the next narrower tile's keys do not fit
    mc, mt = -(-m // 32), -(-m // tile_m)
    boxes = torch.empty((mc + mt) * 6, device=cuda)
    out = [torch.empty((1, 100), dtype=dt, device=cuda) for dt in (torch.float32, torch.int32)]
    visited = torch.empty((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="rfnet_nn_tile"):
        kernels.launch("nn_tile", cuda, qs, ts, boxes, 1, 100, m, 1, tile_m, *out, visited)


def test_tiled_kernels_prune(cuda):
    """On a completion-like pair both kernels load a small share of the
    target tiles, and the op-level wrappers equal ``nearest_neighbor_dyn``."""
    from rfnet_tpu_torch.ops import chamfer_pruned, chamfer_tile

    rng = np.random.RandomState(13)
    t = rng.rand(2, 16384, 3).astype(np.float32)
    t[..., 2] = 0.3 * np.sin(3 * t[..., 0]) * np.cos(2 * t[..., 1])  # a surface
    q = (t + 0.005 * rng.randn(*t.shape)).astype(np.float32)
    q, t = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    dd, di = chamfer.nearest_neighbor_dyn(q, t)
    # (warps, tile_m): 256 queries a block, 256 targets a tile; 128 and 128
    for sort_fn, name, plan in ((chamfer.sort_by_z_with_order, "nn_pruned", (4, 256)),
                                (chamfer_tile.sort_by_morton_with_order, "nn_tile", (2, 128))):
        qs, _ = sort_fn(q)
        ts, _ = sort_fn(t)
        _, _, visited = chamfer._nn_tiled(name, qs, ts, plan)
        share = float(visited.float().mean()) / (16384 // plan[1])
        assert 0 < share < 0.25, (name, share)
    for fn in (chamfer_pruned.nearest_neighbor_pruned, chamfer.nearest_neighbor_tile):
        d, i = fn(q, t)
        torch.testing.assert_close(d, dd, rtol=0, atol=0)
        picked = (q - chamfer._gather_rows(t, i)).square().sum(-1)
        torch.testing.assert_close(picked, dd, rtol=1e-5, atol=1e-9)


def test_kernel_rejects_bad_input(cuda):
    q, t = _clouds(4, (1, 10, 3), (1, 10, 3))
    with pytest.raises(ValueError):
        chamfer.nn_coords(q.to(cuda).double(), t.to(cuda).double())
    with pytest.raises(ValueError):
        chamfer.nn_dyn(q.to(cuda), t)  # devices differ


@pytest.mark.parametrize("b,n,m", [(2, 1024, 64), (1, 16384, 1024), (2, 70, 150), (1, 1, 1),
                                   (64, 70, 3000), (1, 64, 3000), (3, 1, 5), (32, 1024, 64)])
def test_nn_dense_kernel_equals_plain(cuda, b, n, m):
    q, t = _clouds(5, (b, n, 3), (b, m, 3))
    before = kernels.launches["nn_dense"]
    kd, ki = chamfer.nn_dense(q.to(cuda), t.to(cuda))
    assert kernels.launches["nn_dense"] == before + 1
    pd, pi = chamfer.nn_dense(q, t)  # CPU: the plain version
    # K2's scan without the coordinates: bit-equal, indices included
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)


def test_nn_dense_kernel_duplicate_targets_first_index(cuda):
    q, t = _clouds(6, (1, 50, 3), (1, 90, 3))
    _, ki = chamfer.nearest_neighbor(q.to(cuda), torch.cat([t, t], 1).to(cuda))
    assert int(ki.max()) < 90


# ---------------------------------------------------------------------------
# K2 and K4 under every branch of their launch plan
# ---------------------------------------------------------------------------

# (b, n, m, plan (R, G, W, C, tiles)): each R, W > 1, C > 1, W and C > 1
# together, the tiled range (m = 20 000, where one CTA's range overfills
# shared memory) with a short last tile, and the wrapper's own plans at
# n = 1, n not a multiple of 32 R, b = 1 with n = 64, and b = 64
_SCAN_PLANS = [
    (2, 300, 3000, (4, 2, 1, 1, 1)), (2, 300, 3000, (8, 1, 1, 1, 1)),
    (2, 300, 3000, (8, 1, 8, 1, 1)), (1, 70, 150, (4, 2, 4, 1, 1)),
    (2, 300, 3000, (4, 1, 1, 8, 1)), (3, 100, 1000, (8, 1, 2, 4, 1)),
    (2, 40, 3000, (4, 1, 8, 8, 1)), (1, 300, 20000, (8, 1, 1, 1, 3)),
    (1, 300, 20000, (4, 1, 2, 2, 2)), (1, 100, 20000, (4, 2, 4, 1, 4)),
    (1, 1, 3000, None), (2, 333, 3000, None), (1, 64, 3000, None), (64, 64, 3000, None),
    (4, 1024, 3000, None), (1, 300, 20000, None),
]


def _scan_both(cuda, q, t, plan):
    """K2 and K4 on the card under ``plan`` (the wrapper's own where None),
    each launched once, and the CPU plain version: [(dist, idx, coords or
    None) of K2, of K4], and the plain (dist, idx)."""
    got = []
    for name in ("nn_coords", "nn_dense"):
        before = kernels.launches[name]
        qc, tc = q.to(cuda), t.to(cuda)
        if plan is None:
            res = chamfer.nn_coords(qc, tc) if name == "nn_coords" else chamfer.nn_dense(qc, tc)
        else:
            res = chamfer._nn_scan_launch(name, qc, tc, plan)
        assert kernels.launches[name] == before + 1
        got.append(tuple(x.cpu() for x in res) + (None,) * (3 - len(res)))
    return got, chamfer._one_sided(q, t)


@pytest.mark.parametrize("b,n,m,plan", _SCAN_PLANS)
def test_nn_scan_kernel_plans_equal_plain(cuda, b, n, m, plan):
    q, t = _clouds(60 + n + b, (b, n, 3), (b, m, 3))
    got, (pd, pi) = _scan_both(cuda, q, t, plan)
    for kd, ki, kc in got:
        torch.testing.assert_close(kd, pd, rtol=0, atol=0)
        torch.testing.assert_close(ki, pi, rtol=0, atol=0)
        if kc is not None:
            torch.testing.assert_close(kc, chamfer._gather_rows(t, pi), rtol=0, atol=0)


@pytest.mark.parametrize("plan", [(4, 1, 4, 8, 1), (8, 1, 8, 1, 1), (4, 1, 2, 2, 3), None])
def test_nn_scan_kernel_lower_copy_wins_across_splits(cuda, plan):
    """Targets copied across the boundaries of warps' and CTAs' shares
    (and, at m = 3000 under (4, 1, 4, 8, 1), from the first CTA to the last
    of the cluster), queries on the copies: every tie goes to the lower
    copy, whichever split finishes first. A cloud of one repeated point
    returns index 0 everywhere."""
    (t,) = _clouds(70, (2, 3000, 3))
    pairs = [(93, 94), (374, 375), (5, 2999), (749, 750), (1000, 1874), (0, 1500), (2624, 2625)]
    for lo, hi in pairs:
        t[:, hi] = t[:, lo]
    q = t[:, [lo for lo, _ in pairs] + [hi for _, hi in pairs]].clone()
    got, (pd, pi) = _scan_both(cuda, q, t, plan)
    lows = torch.tensor([lo for lo, _ in pairs] * 2, dtype=torch.int32)
    assert torch.equal(pi, lows.expand(2, -1))
    for kd, ki, _ in got:
        torch.testing.assert_close(kd, pd, rtol=0, atol=0)
        torch.testing.assert_close(ki, pi, rtol=0, atol=0)
    same = torch.full((1, 3000, 3), 0.375)
    got, (pd, pi) = _scan_both(cuda, q[:1], same, plan)
    assert int(pi.abs().max()) == 0
    for kd, ki, kc in got:
        torch.testing.assert_close(kd, pd, rtol=0, atol=0)
        torch.testing.assert_close(ki, pi, rtol=0, atol=0)


def test_nn_scan_kernel_unaligned_clouds(cuda):
    """Clouds whose base is not 16-byte aligned (4 bytes past a boundary,
    and a slice of the batch that starts 12 bytes past one): bit-equal,
    under split plans too."""
    q, t = _clouds(71, (3, 500, 3), (3, 3002, 3))
    qa = torch.empty(1 + q.numel(), device=cuda)[1:].view(q.shape).copy_(q)
    ta = torch.empty(1 + t.numel(), device=cuda)[1:].view(t.shape).copy_(t)
    for qs, ts in ((qa, ta), (qa[1:], ta[1:])):
        assert qs.is_contiguous() and ts.is_contiguous() and ts.data_ptr() % 16 in (4, 12)
        pd, pi = chamfer._one_sided(qs.cpu(), ts.cpu())
        for plan in (None, (4, 1, 4, 8, 1), (8, 1, 2, 2, 2)):
            for name in ("nn_coords", "nn_dense"):
                if plan is not None:
                    res = chamfer._nn_scan_launch(name, qs, ts, plan)
                else:
                    res = chamfer.nn_coords(qs, ts) if name == "nn_coords" else chamfer.nn_dense(qs, ts)
                torch.testing.assert_close(res[0].cpu(), pd, rtol=0, atol=0)
                torch.testing.assert_close(res[1].cpu(), pi, rtol=0, atol=0)
                if name == "nn_coords":
                    torch.testing.assert_close(res[2].cpu(), chamfer._gather_rows(ts.cpu(), pi),
                                               rtol=0, atol=0)


def test_nn_scan_kernel_refuses_a_bad_plan(cuda):
    q, t = (x.to(cuda) for x in _clouds(72, (1, 64, 3), (1, 20000, 3)))
    for name in ("nn_coords", "nn_dense"):
        for plan in ((8, 1, 1, 1, 1),   # 20 000 targets in one tile: 320 000 bytes
                     (4, 1, 1, 1, 0), (3, 1, 1, 1, 1), (4, 4, 4, 1, 1), (4, 1, 3, 1, 1),
                     (4, 1, 1, 16, 1)):
            with pytest.raises(RuntimeError, match=f"rfnet_{name} failed"):
                chamfer._nn_scan_launch(name, q, t, plan)


def _scatter_cases(b, n, m, seed):
    """Index layouts of the chamfer backward: banded (sorted argmins), all on
    one target, uniformly random (tests/test_chamfer.py's three cases)."""
    rng = np.random.RandomState(seed)
    banded = np.clip((np.arange(n) * m // n)[None, :] + rng.randint(-9, 9, (b, n)), 0, m - 1)
    return [banded.astype(np.int32), np.full((b, n), m - 1, np.int32),
            rng.randint(0, m, (b, n)).astype(np.int32)]


@pytest.mark.parametrize("b,n,m", [(2, 100, 140), (3, 2048, 2048), (1, 5000, 300)])
def test_nn_grad_kernel_equals_plain(cuda, b, n, m):
    from rfnet_tpu_torch.ops.nn_grad import nn_grad_scatter

    rng = np.random.RandomState(7)
    x1 = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, n).astype(np.float32))
    for case, idx in enumerate(_scatter_cases(b, n, m, 8)):
        idx = torch.from_numpy(idx)
        before = kernels.launches["nn_grad"]
        ksp, ksw = nn_grad_scatter(x1.to(cuda), g.to(cuda), idx.to(cuda), m)
        assert kernels.launches["nn_grad"] == before + 1
        psp, psw = nn_grad_scatter(x1, g, idx, m)  # CPU: index_add_ in query order
        # the same sums in the same ascending order: bit-equal
        torch.testing.assert_close(ksp.cpu(), psp, rtol=0, atol=0, msg=f"case {case}")
        torch.testing.assert_close(ksw.cpu(), psw, rtol=0, atol=0, msg=f"case {case}")
        # and both are the exact float64 sums to fp32 rounding
        ref = torch.zeros(b, m, 4, dtype=torch.float64)
        src = torch.cat([g[..., None] * x1, g[..., None]], -1).double()
        ref.scatter_add_(1, idx.long()[..., None].expand(-1, -1, 4), src)
        torch.testing.assert_close(ksp.cpu().double(), ref[..., :3], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ksw.cpu().double(), ref[..., 3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,m", [(2, 256, 256), (1, 300, 130), (2, 96, 520), (1, 2100, 1500)])
def test_emd_cost_kernel_matches_plain(cuda, b, n, m):
    from rfnet_tpu_torch.ops.emd import approx_match_cost

    x1, x2 = _clouds(9, (b, n, 3), (b, m, 3))
    before = kernels.launches["emd_cost"]
    got = approx_match_cost(x1.to(cuda), x2.to(cuda)).cpu()
    assert kernels.launches["emd_cost"] == before + 1
    # the same recurrence and d² formula, fp32 sums in another order: the JAX
    # package's own bar for its kernel against its XLA recurrence
    torch.testing.assert_close(got, approx_match_cost(x1, x2), rtol=2e-4, atol=0)


def test_emd_cost_kernel_is_deterministic(cuda):
    from rfnet_tpu_torch.ops.emd import approx_match_cost

    x1, x2 = (x.to(cuda) for x in _clouds(10, (2, 1500, 3), (2, 1500, 3)))
    torch.testing.assert_close(approx_match_cost(x1, x2), approx_match_cost(x1, x2),
                               rtol=0, atol=0)


def test_chamfer_backward_launches_k5_only_for_live_clouds(cuda):
    """The ground truth takes no gradient, so each backward scatters once:
    the pair loss and re_chamfer's folded slices each launch K5 one time.
    The card's gradients equal the CPU's bit for bit: K3 and K5 equal their
    plain versions, and the square roots are correctly rounded on both."""
    from rfnet_tpu_torch import losses

    gt, a, b = _clouds(11, (2, 512, 3), (2, 512, 3), (2, 512, 3))
    grads = {}
    for dev in ("cpu", cuda):
        xa = a.clone().to(dev).requires_grad_()
        xb = b.clone().to(dev).requires_grad_()
        before = kernels.launches["nn_grad"]
        m = chamfer.chamfer_means_pair(gt.to(dev), xa, xb)
        (m[0] + 2 * m[1] + 3 * m[2] + 4 * m[3] + losses.re_chamfer(gt.to(dev), xa)).backward()
        if dev != "cpu":
            assert kernels.launches["nn_grad"] == before + 2
        grads[str(dev)] = (xa.grad.cpu(), xb.grad.cpu())
    for k, c in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(k, c, rtol=0, atol=0)


def _runs_index(lengths, m, seed):
    """(n,) int32 index whose target j < len(lengths) is picked by lengths[j]
    queries, scattered over the query axis (the other targets by none)."""
    idx = np.repeat(np.arange(len(lengths)), lengths)
    assert len(lengths) <= m
    return np.random.RandomState(seed).permutation(idx).astype(np.int32)


# run lengths around every threshold of K5: the longest run one lane sums
# (8), a warp's width (32), the rows a warp stages (64) and has in flight
# (128, 192), and 0 and 1
_K5_LENGTHS = [0, 1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 127, 128, 129, 191, 192, 193, 0, 700, 5]


@pytest.mark.parametrize("b,m", [(1, 40), (1, 3001), (40, 20), (140, 64)])
def test_nn_grad_kernel_run_lengths_cross_every_threshold(cuda, b, m):
    """One block a cloud (b = 140), or 3 or 4 blocks each with a range of its
    targets (b = 40, b = 1): bit-equal to the CPU's index_add_ whatever the
    run lengths and however the runs' queries are scattered."""
    from rfnet_tpu_torch.ops.nn_grad import nn_grad_scatter

    lengths = _K5_LENGTHS[:m]
    idx = np.stack([np.roll(_runs_index(lengths, m, 20 + i), i) for i in range(b)])
    n = idx.shape[1]
    rng = np.random.RandomState(21)
    x1 = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, n).astype(np.float32))
    idx = torch.from_numpy(idx)
    ksp, ksw = nn_grad_scatter(x1.to(cuda), g.to(cuda), idx.to(cuda), m)
    psp, psw = nn_grad_scatter(x1, g, idx, m)
    torch.testing.assert_close(ksp.cpu(), psp, rtol=0, atol=0)
    torch.testing.assert_close(ksw.cpu(), psw, rtol=0, atol=0)


# shared memory K5's counters and slots may take (csrc/nn_grad.cu: kMaxShared
# less the warps' own 32 x 2048 bytes and 1024 of static room)
_K5_SHARED_INTS = (232448 - 1024 - 32 * 2048) // 4


@pytest.mark.parametrize("b,n,m,targets,fits", [
    (2, 40000, 50, 50, True),          # long runs over more queries than one bitmap window (16384)
    (1, 16385, 1, 1, True),            # all-to-one, one query past the window
    (2, 30000, 40000, 300, True),      # four blocks a cloud, near the shared-memory limit
    (1, 20000, 300000, 300, False),    # a block's counters alone exceed shared memory
    (1, 70000, 9, 9, False),           # slots exceed it, long runs over five windows
    (3, 45000, 64, 64, False),         # the same for twelve blocks, each with its scratch row
])
def test_nn_grad_kernel_large_sizes(cuda, b, n, m, targets, fits):
    from rfnet_tpu_torch.ops.nn_grad import _scratch_shape, nn_grad_scatter

    parts, _ = _scratch_shape(b, n, m, cuda)
    assert (-(-m // parts) + n <= _K5_SHARED_INTS) == fits
    rng = np.random.RandomState(22)
    x1 = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, n).astype(np.float32))
    idx = torch.from_numpy((rng.randint(0, targets, (b, n)) * (m // targets)).astype(np.int32))
    before = kernels.launches["nn_grad"]
    ksp, ksw = nn_grad_scatter(x1.to(cuda), g.to(cuda), idx.to(cuda), m)
    assert kernels.launches["nn_grad"] == before + 1
    psp, psw = nn_grad_scatter(x1, g, idx, m)
    torch.testing.assert_close(ksp.cpu(), psp, rtol=0, atol=0)
    torch.testing.assert_close(ksw.cpu(), psw, rtol=0, atol=0)


@pytest.mark.parametrize("b,n,m,one_target", [
    (64, 16384, 16384, True),     # the train step's pair, all-to-one: every block's longest run
    (64, 16384, 16384, False),    # the same with random indices
    (1, 70000, 9, False),         # counters and slots in the scratch
    (3, 45000, 64, True),
    (5, 1000, 3000, False),       # ragged, short runs
])
def test_nn_grad_kernel_stays_inside_its_scratch(cuda, b, n, m, one_target):
    """K5 launched on a scratch of exactly the wrapper's size that lies inside
    a larger tensor: the ints before and after it keep their values, and the
    sums equal the CPU's. A stride one int short is refused."""
    from rfnet_tpu_torch.ops.nn_grad import _scatter_plain, _scratch_shape

    rng = np.random.RandomState(23)
    x1 = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, n).astype(np.float32))
    idx = torch.from_numpy(np.full((b, n), m - 1, np.int32) if one_target
                           else rng.randint(0, m, (b, n)).astype(np.int32))
    parts, width = _scratch_shape(b, n, m, cuda)
    guard, mark = 1 << 20, -123456789
    arena = torch.full((guard + b * parts * width + guard,), mark, dtype=torch.int32, device=cuda)
    scratch = arena[guard : guard + b * parts * width]
    sp = torch.empty((b, m, 3), device=cuda)
    sw = torch.empty((b, m), device=cuda)
    args = (x1.to(cuda), g.to(cuda), idx.to(cuda), b, n, m, parts, scratch)
    kernels.launch("nn_grad", cuda, *args, width, sp, sw)
    torch.cuda.synchronize()
    assert bool((arena[:guard] == mark).all()) and bool((arena[-guard:] == mark).all())
    psp, psw = _scatter_plain(x1, g, idx, m)
    torch.testing.assert_close(sp.cpu(), psp, rtol=0, atol=0)
    torch.testing.assert_close(sw.cpu(), psw, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="rfnet_nn_grad failed"):
        kernels.launch("nn_grad", cuda, *args, width - 1, sp, sw)


def _blobs(seed, b, n, extent, blobs=7):
    rng = np.random.RandomState(seed)
    centres = extent * (rng.rand(b, blobs, 3) - 0.5)  # around the origin: fp32 d² is an expansion
    pick = rng.randint(0, blobs, (b, n))
    pts = np.take_along_axis(centres, pick[..., None].repeat(3, -1), 1)
    return torch.from_numpy((pts + 0.01 * extent * rng.randn(b, n, 3)).astype(np.float32))


@pytest.mark.parametrize("extent,n,m", [(80.0, 1500, 1100), (3.0, 2100, 2100), (0.04, 900, 1300)])
def test_emd_cost_kernel_band_skip(cuda, extent, n, m):
    """Clouds so spread that every level with lambda < 0 skips tile pairs
    (extent 80), unit-scale ones, and clouds so small that no level skips
    any (extent < 0.05): K6 within the bar of the plain recurrence, and
    bit-equal with its skip rule off."""
    from rfnet_tpu_torch.ops import emd

    x1, x2 = _blobs(14, 2, n, extent), _blobs(15, 2, m, extent)
    shares = emd._skipped_shares(emd._sorted_with_boxes(x1)[0], emd._sorted_with_boxes(x2)[0])
    if extent == 80.0:
        assert min(shares[:9]) > 0.0 and shares[9] == 0.0
    if extent < 0.05:
        assert shares == [0.0] * 10
    got = emd.approx_match_cost(x1.to(cuda), x2.to(cuda))
    every_pair = emd._approx_match_cost_kernel(x1.to(cuda), x2.to(cuda), band_skip=False)
    torch.testing.assert_close(got, every_pair, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), emd.approx_match_cost(x1, x2), rtol=2e-4, atol=0)


# ---------------------------------------------------------------------------
# K1's cluster forms and K3's slab walk at their edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,npoint,cluster", [
    (1, 40000, 64, 8), (1, 5000, 64, 4), (20, 3000, 32, 2), (100, 700, 50, 1), (1, 70000, 64, 8),
])
def test_fps_kernel_takes_every_cluster_size(cuda, b, n, npoint, cluster):
    """Each cluster size the wrapper chooses on this card (8 only where 4
    CTAs cannot hold the cloud), and the streaming form at n = 70 000 (more
    than 8 CTAs hold in registers): identical indices, one launch."""
    plan = fps._fps_plan(b, n, fps._sm_count(cuda))
    assert plan[0] == cluster and (plan[1] == 0) == (n > 8 * 256 * 32), plan
    (x,) = _clouds(20 + b, (b, n, 3))
    before = kernels.launches["fps"]
    got = fps.farthest_point_sample(npoint, x.to(cuda)).cpu()
    assert kernels.launches["fps"] == before + 1
    torch.testing.assert_close(got, fps._fps_plain(x, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("b,n,npoint,plan", [
    (2, 5, 5, (8, 1)),  # n < C: three CTAs hold no point
    (3, 3001, 40, (4, 4)),  # n not a multiple of C x threads
    (2, 3001, 40, (2, 8)),
    (2, 3001, 40, (2, 0)),  # the streaming form at a small size
    (1, 9000, 30, (8, 0)),
    (2, 300, 300, (4, 1)),  # npoint = n: the last picks have minimum 0
    (1, 60000, 16, (8, 32)),  # beyond the old kernel's 58 044 points
])
def test_fps_kernel_forms_equal_plain(cuda, b, n, npoint, plan):
    (x,) = _clouds(30 + n, (b, n, 3))
    got = fps._fps_launch(x.to(cuda), npoint, *plan).cpu()
    torch.testing.assert_close(got, fps._fps_plain(x, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("plan", [(4, 1), (8, 1), (2, 2), (8, 0)])
def test_fps_kernel_ties_across_ctas(cuda, plan):
    """The same points in every CTA's range, on a coarse grid: equal minima
    across CTAs, warps and lanes at every pick; the lowest index wins."""
    rng = np.random.RandomState(40)
    unit = (rng.randint(0, 4, (2, 250, 3)) / 4.0).astype(np.float32)
    x = torch.from_numpy(np.concatenate([unit] * 4, axis=1))  # 1000 points, CTA r holds copy r
    got = fps._fps_launch(x.to(cuda), 200, *plan).cpu()
    want = fps._fps_plain(x, 200)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want.max()) < 250  # the first copy wins every tie


def test_fps_kernel_refuses_a_short_plan(cuda):
    (x,) = _clouds(41, (1, 3000, 3))
    with pytest.raises(RuntimeError):
        fps._fps_launch(x.to(cuda), 8, 1, 4)  # 1 024 points of room for 3 000
    with pytest.raises(RuntimeError):
        fps._fps_launch(x.to(cuda), 8, 3, 4)  # not a power of two


def _z_sorted(a):
    a = np.asarray(a, np.float32)
    return a[np.arange(a.shape[0])[:, None], np.argsort(a[..., 2], axis=1, kind="stable")]


def _walk_cases():
    """Sorted clouds for K3's walk: the random-init regime (a blob against a
    spread cloud, both ways), a walk across many slabs on each side that
    ends before the cloud does, exact duplicates on either side of each slab
    boundary, all z equal, a tie exactly at the down side's frontier gap,
    and ragged sizes (m < S, m not a multiple of S, n < 32)."""
    rng = np.random.RandomState(50)
    spread = _z_sorted(rng.rand(2, 16384, 3) * 2.0 - 1.0)
    blob = _z_sorted(0.02 * rng.randn(2, 16384, 3))
    line = np.zeros((1, 8192, 3), np.float32)
    line[0, :, 2] = np.sort(rng.rand(8192)).astype(np.float32)
    q_line = _z_sorted(np.stack([np.full(300, 0.2), 0.01 * rng.randn(300),
                                 0.45 + 0.1 * rng.rand(300)], -1)[None])
    dup = _z_sorted(rng.rand(1, 1100, 3))
    for k in (127, 255, 511, 767, 1023):  # equal to the next point: ties across slabs
        dup[0, k + 1] = dup[0, k]
    q_dup = _z_sorted(np.concatenate([dup[:, 100:1100:3], dup[:, 120:1100:7] + 1e-3], 1))
    # the last target of the lowest of three slabs and the first of the
    # highest at exactly one distance from every query, all else far: the
    # walk starts in the highest slab and loads the middle one before it has
    # a best; only the down side's equality test reaches the lower index
    slab = chamfer._NN_DYN_SLAB
    tie = np.stack([np.full(3 * slab, 5.0), np.zeros(3 * slab),
                    np.concatenate([np.linspace(0.0, 0.25, slab), np.linspace(0.3, 0.45, slab),
                                    np.linspace(0.75, 1.0, slab)])], -1)[None].astype(np.float32)
    tie[0, [slab - 1, 2 * slab], 0] = 0.0
    flat_q = rng.rand(1, 700, 3).astype(np.float32)
    flat_t = rng.rand(1, 1000, 3).astype(np.float32)
    flat_q[..., 2] = flat_t[..., 2] = 0.25
    return {
        "blob->spread": (blob, spread),
        "spread->blob": (spread, blob),
        "line, many slabs each side": (q_line, line),
        "duplicates across slab boundaries": (q_dup, dup),
        "all z equal": (flat_q, flat_t),
        "tie at the down frontier": (np.tile(np.float32([0.0, 0.0, 0.5]), (1, 10, 1)), tie),
        "m < S": (_z_sorted(rng.rand(3, 600, 3)), _z_sorted(rng.rand(3, 100, 3))),
        "m not a multiple of S": (_z_sorted(rng.rand(2, 513, 3)), _z_sorted(rng.rand(2, 700, 3))),
        "n < 32": (_z_sorted(rng.rand(4, 5, 3)), _z_sorted(rng.rand(4, 3000, 3))),
    }


WALK_CASES = sorted(_walk_cases())


@pytest.mark.parametrize("name", WALK_CASES)
def test_nn_dyn_walk_edges_equal_plain_and_k7(cuda, name):
    from rfnet_tpu_torch.ops import chamfer_pruned

    slab = chamfer._NN_DYN_SLAB
    q, t = (torch.from_numpy(a) for a in _walk_cases()[name])
    before = kernels.launches["nn_dyn"]
    kd, ki = chamfer.nn_dyn(q.to(cuda), t.to(cuda))
    assert kernels.launches["nn_dyn"] == before + 1
    pd, pi = chamfer._nn_sorted_plain(q, t)
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    dd, di = chamfer_pruned.nn_pruned(q.to(cuda), t.to(cuda))
    torch.testing.assert_close(kd, dd, rtol=0, atol=0)
    torch.testing.assert_close(ki, di, rtol=0, atol=0)
    if name == "line, many slabs each side":
        # the exact z-window of every query reaches at least 3 slabs past
        # its own on each side, and stops short of the cloud's ends
        tz, qz = t[0, :, 2].contiguous(), q[0, :, 2].contiguous()
        r = torch.sqrt(pd[0].double()).float()
        lo = torch.searchsorted(tz, qz - r) // slab
        hi = torch.searchsorted(tz, qz + r) // slab
        own = torch.searchsorted(tz, qz) // slab
        assert int((own - lo).min()) >= 3 and int((hi - own).min()) >= 3
        assert int(lo.min()) > 0 and int(hi.max()) < (t.shape[1] - 1) // slab
    if name == "duplicates across slab boundaries":
        assert set(pi[0].tolist()) & {127, 255, 511, 767, 1023}  # ties resolved low
    if name == "tie at the down frontier":
        assert set(pi[0].tolist()) == {slab - 1}


@pytest.mark.parametrize("case", range(9))
def test_nn_dyn_kernel_tiled_cases_equal_plain_and_k7(cuda, case):
    from rfnet_tpu_torch.ops import chamfer_pruned

    q, t = (torch.from_numpy(a) for a in _tiled_cases()[case])
    qs, _ = chamfer.sort_by_z_with_order(q)
    ts, _ = chamfer.sort_by_z_with_order(t)
    kd, ki = chamfer.nn_dyn(qs.to(cuda), ts.to(cuda))
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    dd, di = chamfer_pruned.nn_pruned(qs.to(cuda), ts.to(cuda))
    torch.testing.assert_close(kd, dd, rtol=0, atol=0)
    torch.testing.assert_close(ki, di, rtol=0, atol=0)


def test_custom_ops_pass_opcheck(cuda):
    """``rfnet::fps`` and ``rfnet::nn_coords`` (K1, K2 as operators) pass
    ``torch.library.opcheck`` on CUDA inputs: schema, fake implementation
    against the kernel's outputs, autograd registration, AOT dispatch."""
    x, t = (a.to(cuda) for a in _clouds(9, (2, 3000, 3), (2, 300, 3)))
    for op, args in ((torch.ops.rfnet.fps.default, (x, 32)),
                     (torch.ops.rfnet.nn_coords.default, (t, x))):
        assert set(torch.library.opcheck(op, args).values()) == {"SUCCESS"}


@pytest.mark.parametrize("batch_size", [2, None])
def test_exported_forward_runs_the_kernels(cuda, tmp_path, batch_size):
    """A card artifact of the tiny model (static batch 2, and symbolic)
    equals the live forward bit for bit and launches K1 once and K2 three
    times a call."""
    from rfnet_tpu_torch import export
    from rfnet_tpu_torch.models import RFNet

    model = RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(1))
    model = model.to(cuda).eval()
    exported = export.export_forward(model, batch_size, innum=3000)
    ops = [str(n.target) for n in exported.graph.nodes if str(n.target).startswith("rfnet.")]
    assert ops == ["rfnet.fps.default"] + ["rfnet.nn_coords.default"] * 3
    path = str(tmp_path / "card.pt2")
    export.save_exported(exported, path)
    served = export.load_forward(path)
    for b in ((2,) if batch_size else (1, 3)):
        (x,) = _clouds(b, (b, 3000, 3))
        x = x.to(cuda)
        with torch.no_grad():
            want = model(x).out4
        kernels.reset_launch_counts()
        got = served(x)
        torch.cuda.synchronize()
        assert (kernels.launches["fps"], kernels.launches["nn_coords"]) == (1, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _variant_plan(fma, eq, b, n, m, per_thread, sms):
    """The variant's plan (K4's for v0, K9's for the others) at
    ``per_thread`` queries a thread."""
    from tools.bench_chamfer_variants_torch import variant_plan

    if fma or eq:
        return variant_plan(b, n, m, sms, per_thread)
    _, _, w, c, _ = chamfer._nn_scan_plan(b, n, m, sms)
    return chamfer._nn_scan_fill(b, n, m, per_thread, w, c, sms)


def _hold_variant(cuda, q, t, fma, eq, per_thread):
    """Launches K9 in the variant at ``per_thread`` queries a thread and
    holds it to its plain version bit for bit (the study's
    ``hold_to_plain``), v0 and v2 also to K4."""
    from tools.bench_chamfer_variants_torch import hold_to_plain

    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    plan = _variant_plan(fma, eq, b, n, m, per_thread, fps._sm_count(cuda))
    kd = torch.empty(b, n, device=cuda)
    ki = torch.empty(b, n, dtype=torch.int32, device=cuda)
    before = kernels.launches["nn_variant"]
    kernels.launch("nn_variant", cuda, q, t, b, n, m, *plan, int(fma), int(eq), kd, ki)
    assert kernels.launches["nn_variant"] == before + 1
    hold_to_plain(q, t, kd, ki, fma)
    if not fma:
        kd4, ki4 = chamfer.nn_dense(q, t)
        assert torch.equal(kd, kd4) and torch.equal(ki, ki4)


@pytest.mark.parametrize("per_thread", [4, 8])
@pytest.mark.parametrize("fma,eq", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("n,m", [(700, 1100), (3000, 16384), (1, 1), (70, 150)])
def test_nn_variant_kernel_equals_plain(cuda, per_thread, fma, eq, n, m):
    """K9 at 4 and at 8 queries a thread, under each variant's plan (K4's
    for v0, K9's own for the others, the targets split as they choose),
    against its plain version bit for bit, distances and indices; v0 and v2
    equal to K4."""
    q, t = (x.to(cuda) for x in _clouds(9, (2, n, 3), (2, m, 3)))
    _hold_variant(cuda, q, t, fma, eq, per_thread)


@pytest.mark.parametrize("per_thread", [4, 8])
@pytest.mark.parametrize("fma,eq", [(False, False), (True, False), (False, True), (True, True)])
def test_nn_variant_kernel_equals_plain_on_ties(cuda, per_thread, fma, eq):
    """K9 on clouds on a 1/64 grid with ties planted inside its chunks and
    across chunks, warps' shares and CTAs' ranges of its plan
    (``tie_clouds``), bit-equal to its plain version: the lowest index of
    every tie."""
    from tools.bench_chamfer_variants_torch import tie_clouds, variant_chunk

    b, n, m = 2, 700, 3000
    plan = _variant_plan(fma, eq, b, n, m, per_thread, fps._sm_count(cuda))
    step = variant_chunk(plan, fma) if fma or eq else 1
    q, t = (x.to(cuda) for x in tie_clouds(15, b, n, m, [(plan, step)]))
    _hold_variant(cuda, q, t, fma, eq, per_thread)


def test_nn_variant_refuses_an_unknown_variant(cuda):
    q, t = (x.to(cuda) for x in _clouds(9, (1, 40, 3), (1, 60, 3)))
    out = (torch.empty(1, 40, device=cuda), torch.empty(1, 40, dtype=torch.int32, device=cuda))
    with pytest.raises(RuntimeError, match="invalid argument"):
        kernels.launch("nn_variant", cuda, q, t, 1, 40, 60, 4, 1, 1, 1, 1, 2, 0, *out)


# K3's loaded pairs (tracing.py's ``k3.pairs_loaded``): the walk's cases of
# tests/test_torch_nn_dyn_walk.py, each tiled four times (as its test at the
# kernel's sizes does) to span several slabs and blocks
def _walk_case(name):
    from test_torch_nn_dyn_walk import CASES

    q, t = (torch.from_numpy(np.concatenate([a + k * np.float32(0.01) for k in range(4)])
                             .astype(np.float32))[None] for a in CASES[name])
    return chamfer.sort_by_z_with_order(q)[0], chamfer.sort_by_z_with_order(t)[0]


def _counted(qs, ts):
    """K3 under a profiler: (dist, idx, the counters)."""
    from torch.profiler import ProfilerActivity, profile

    from rfnet_tpu_torch import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        d, i = chamfer.nn_dyn(qs, ts)
    counts = tracing.counters()
    tracing.reset()
    return d, i, counts


@pytest.mark.parametrize("name", ["all points equal", "all z equal", "blob->spread", "blobs",
                                  "dup targets", "duplicates across slab boundaries",
                                  "line, many slabs", "m < slab, n < warp", "one target",
                                  "spread->blob", "tie at the down frontier"])
def test_nn_dyn_counts_the_pairs_its_blocks_loaded(cuda, name):
    """K3's counter equals the walk's loaded pairs (the targets of the
    slabs each query's block loaded) at the kernel's sizes; ``k3.pairs_dense``
    is b·n·m; distances and indices are the same bits with the counter on and
    off. Two copies of the pair in one launch count twice."""
    from test_torch_nn_dyn_walk import _walk

    qs, ts = _walk_case(name)
    _, _, loaded, _ = _walk(qs[0], ts[0], slab=chamfer._NN_DYN_SLAB, tile=256, warp_q=64,
                            chunk=32)
    n, m = qs.shape[1], ts.shape[1]
    off_d, off_i = chamfer.nn_dyn(qs.to(cuda), ts.to(cuda))
    d, i, counts = _counted(qs.to(cuda), ts.to(cuda))
    assert counts == {"k3.pairs_loaded": int(loaded.sum()), "k3.pairs_dense": n * m}
    torch.testing.assert_close(d, off_d, rtol=0, atol=0)
    torch.testing.assert_close(i, off_i, rtol=0, atol=0)
    _, _, twice = _counted(qs.repeat(2, 1, 1).to(cuda), ts.repeat(2, 1, 1).to(cuda))
    assert twice == {k: 2 * v for k, v in counts.items()}


# ptxas' registers a thread of K3 as built before it gained the counter
NN_DYN_REGISTERS = 32


def test_nn_dyn_registers_unchanged_by_the_counter(cuda):
    """``_build/build.log`` (ptxas -v) gives K3 the registers it had before
    the counter."""
    import os
    import re

    kernels.build()
    with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
        log = f.read()
    entry = re.search(r"Compiling entry function '\w*nn_dyn_kernel\w*'.*?Used (\d+) registers",
                      log, re.S)
    assert entry, "build.log reports no registers for nn_dyn_kernel"
    assert int(entry.group(1)) == NN_DYN_REGISTERS


# (queries, targets) of every k-NN SnowflakeNet runs at its published PCN
# widths (benchmark/flops_snowflake.py:knn_calls): the set abstractions'
# centres among their points, and the five transformers' points among
# themselves
SNOWFLAKE_KNN = [(512, 2048), (512, 512), (128, 512), (128, 128), (2048, 2048)]


@pytest.mark.parametrize("n,m", SNOWFLAKE_KNN + [(1, 16), (130, 17), (1000, 3000)])
def test_knn_kernel_equals_plain(cuda, n, m):
    from rfnet_tpu_torch.ops import knn

    b = 32 if (n, m) in SNOWFLAKE_KNN else 3
    q, t = _clouds(20, (b, n, 3), (b, m, 3))
    before = kernels.launches["knn"]
    kd, ki = knn.knn(16, t.to(cuda), q.to(cuda))
    assert kernels.launches["knn"] == before + 1
    pd, pi = knn._knn_plain(16, t.to(cuda), q.to(cuda))  # the plain version, on the card
    torch.testing.assert_close(kd, pd, rtol=0, atol=0)
    torch.testing.assert_close(ki, pi, rtol=0, atol=0)
    if b == 3:  # and the CPU's, at the small shapes
        cd, ci = knn.knn(16, t, q)
        torch.testing.assert_close(kd.cpu(), cd, rtol=0, atol=0)
        torch.testing.assert_close(ki.cpu(), ci, rtol=0, atol=0)


def test_knn_kernel_refuses_another_k_and_counts_its_launches(cuda):
    """On the card the op runs K10, built for k = 16, or refuses; the
    counters count K10's launches and pairs under a profiler."""
    from torch.profiler import ProfilerActivity, profile

    from rfnet_tpu_torch import tracing
    from rfnet_tpu_torch.ops import knn

    q, t = _clouds(22, (2, 64, 3), (2, 300, 3))
    with pytest.raises(ValueError, match="k = 16"):
        knn.knn(8, t.to(cuda), q.to(cuda))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        knn.knn(16, t.to(cuda), q.to(cuda))
    counts = tracing.counters()
    tracing.reset()
    assert counts["knn.launches"] == 1 and counts["knn.pairs"] == 2 * 64 * 300


def test_knn_kernel_ties_and_self(cuda):
    """On a 1/8 grid many distances tie exactly: the lower index comes first;
    a query that is a target has itself first, at distance 0."""
    from rfnet_tpu_torch.ops import knn

    rng = np.random.RandomState(21)
    pts = torch.from_numpy(rng.randint(0, 4, size=(4, 2048, 3)).astype(np.float32) / 8)
    kd, ki = knn.knn(16, pts.to(cuda), pts.to(cuda))
    pd, pi = knn._knn_plain(16, pts, pts)
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    assert (kd[..., 0] == 0).all()
    same = kd[..., 1:] == kd[..., :-1]
    assert same.any() and (ki[..., 1:][same] > ki[..., :-1][same]).all()


@pytest.fixture(scope="module")
def attn_inputs():
    """The five attention blocks' inputs of a SnowflakeNet forward at batch
    32 on the benchmark's weights (``chip_smoke.snowflake_attn_inputs``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    return chip_smoke.snowflake_attn_inputs(torch.device("cuda", 0))[0]


@pytest.mark.parametrize("block", range(5))
def test_attn_kernel_matches_plain(attn_inputs, block):
    """K11 at each block of the forward (b = 32; n = 512, 128, 512, 512,
    2 048) within ``chip_smoke.ATTN_ATOL`` of its plain version on the card,
    and the plain version with TF32 operands, the control, outside it. The
    tolerance comes from readings: float32 reordering moved the outputs
    1.79e-7 at most, TF32 operands 6.82e-5 at least (PERF.md §6)."""
    from chip_smoke import ATTN_ATOL
    from rfnet_tpu_torch.ops import vector_attention as va

    pos, idx, q, k, v, mlps, packed = attn_inputs[block]
    assert q.shape[:2] == (32, (512, 128, 512, 512, 2048)[block])
    before = kernels.launches["attn"]
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    with torch.inference_mode():
        got = va.vector_attention(pos, idx, q, k, v, mlps, packed)
        want = va._attention_plain(pos, idx, q, k, v, mlps)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = va._attention_plain(pos, idx, q, k, v, mlps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_was
    assert kernels.launches["attn"] == before + 1
    assert float((got - want).abs().max()) <= ATTN_ATOL
    assert float((tf32 - want).abs().max()) > ATTN_ATOL


def test_attn_kernel_counts_a_forward(cuda):
    """Every attention block of a SnowflakeNet forward goes through K11:
    ``attn.launches`` 5 and ``attn.pairs`` 59 392 a cloud under a profiler,
    five ``attn_gemm_kernel`` launches and no softmax kernel left."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from rfnet_tpu_torch import tracing

    model, partial = chip_smoke.snowflake_model(cuda), chip_smoke.snowflake_partials(cuda)
    with torch.inference_mode():
        model(partial)  # folds and packs the weights
        before = kernels.launches["attn"]
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(partial)
            torch.cuda.synchronize()
    counts = tracing.counters()
    tracing.reset()
    assert kernels.launches["attn"] == before + 5
    assert counts["attn.launches"] == 5 and counts["attn.pairs"] == 32 * 59_392
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in device if "attn_gemm_kernel" in e.key) == 5
    assert not any("softmax" in e.key.lower() for e in device)


def test_attn_kernel_refuses_other_widths(cuda):
    """On the card the op runs K11, built for the published widths, or
    refuses."""
    from rfnet_tpu_torch.ops import knn, vector_attention as va

    g = torch.Generator().manual_seed(23)
    pos = torch.rand(2, 40, 3, generator=g).to(cuda)
    q = torch.randn(2, 40, 64, generator=g).to(cuda)
    shapes = ((64, 3), (64,), (64, 64), (64,), (256, 64), (256,), (64, 256), (64,))
    mlps = va.AttnMLPs(*(torch.randn(*s, generator=g).to(cuda) / 8 for s in shapes))
    idx = knn.knn(16, pos, pos)[1]
    packed = va.pack(mlps)
    assert va.vector_attention(pos, idx, q, q, q, mlps, packed).shape == q.shape
    with pytest.raises(ValueError, match="K11 is built for"):
        va.vector_attention(pos, idx[..., :8].contiguous(), q, q, q, mlps, packed)
    with pytest.raises(ValueError, match="packed"):
        va.vector_attention(pos, idx, q, q, q, mlps)


def test_attn_kernel_refuses_autograd(cuda):
    """K11 has no backward: a SnowflakeNet forward on the card with autograd
    on raises instead of cutting the graph; under ``no_grad`` it runs."""
    import chip_smoke

    model, partial = chip_smoke.snowflake_model(cuda), chip_smoke.snowflake_partials(cuda, 2)
    with pytest.raises(ValueError, match="no backward"):
        model(partial)
    with torch.no_grad():
        assert torch.isfinite(model(partial).stages[-1]).all()

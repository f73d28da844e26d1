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


@pytest.mark.parametrize("n,m", [(64, 3000), (1024, 3000), (70, 150), (1, 1)])
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
    kd, ki = chamfer.nn_dyn(qs.to(cuda), ts.to(cuda))
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


@pytest.mark.parametrize("case", range(9))
def test_nn_pruned_kernel_equals_plain_and_k3(cuda, case):
    from rfnet_tpu_torch.ops import chamfer_pruned

    q, t = (torch.from_numpy(a) for a in _tiled_cases()[case])
    qs, _ = chamfer.sort_by_z_with_order(q)
    ts, _ = chamfer.sort_by_z_with_order(t)
    before = kernels.launches["nn_pruned"]
    kd, ki = chamfer_pruned.nn_pruned(qs.to(cuda), ts.to(cuda))
    assert kernels.launches["nn_pruned"] == before + 1
    pd, pi = chamfer_pruned.nn_pruned(qs, ts)  # CPU: the full plain scan
    # same sum-of-squares chain, bounds that never exceed it, lowest index on
    # ties whatever the visit order: bit-equal to the plain scan and to K3
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    dd, di = chamfer.nn_dyn(qs.to(cuda), ts.to(cuda))
    torch.testing.assert_close(kd, dd, rtol=0, atol=0)
    torch.testing.assert_close(ki, di, rtol=0, atol=0)


@pytest.mark.parametrize("tiles", [(128, 128), (256, 512), (32, 7), (64, 4096)])
@pytest.mark.parametrize("case", range(9))
def test_nn_tile_kernel_equals_plain(cuda, case, tiles):
    from rfnet_tpu_torch.ops import chamfer_tile

    q, t = (torch.from_numpy(a) for a in _tiled_cases()[case])
    qs, _ = chamfer_tile.sort_by_morton_with_order(q)
    ts, _ = chamfer_tile.sort_by_morton_with_order(t)
    before = kernels.launches["nn_tile"]
    kd, ki, _ = chamfer._nn_tiled("nn_tile", qs.to(cuda), ts.to(cuda), *tiles)
    assert kernels.launches["nn_tile"] == before + 1
    pd, pi = chamfer_tile.nn_tile(qs, ts)  # CPU: the full plain scan
    torch.testing.assert_close(kd.cpu(), pd, rtol=0, atol=0)
    torch.testing.assert_close(ki.cpu(), pi, rtol=0, atol=0)
    # exact for any order: unsorted clouds prune less and give the same answer
    ud, ui, _ = chamfer._nn_tiled("nn_tile", q.to(cuda), t.to(cuda), *tiles)
    fd, fi = chamfer._nn_sorted_plain(q, t)
    torch.testing.assert_close(ud.cpu(), fd, rtol=0, atol=0)
    torch.testing.assert_close(ui.cpu(), fi, rtol=0, atol=0)


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
    for sort_fn, name, tn, tm in ((chamfer.sort_by_z_with_order, "nn_pruned", 256, 256),
                                  (chamfer_tile.sort_by_morton_with_order, "nn_tile", 128, 128)):
        qs, _ = sort_fn(q)
        ts, _ = sort_fn(t)
        _, _, visited = chamfer._nn_tiled(name, qs, ts, tn, tm)
        share = float(visited.float().mean()) / (16384 // tm)
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


@pytest.mark.parametrize("b,n,m", [(2, 1024, 64), (1, 16384, 1024), (2, 70, 150), (1, 1, 1)])
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

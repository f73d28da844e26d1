"""The port's FPS and nearest-neighbour ops against the JAX package's.

Inputs come from numpy with a seed and go to both packages. Where the JAX
function reaches a Pallas kernel it runs in interpret mode on the CPU; the
port runs its kernels' plain versions (CPU tensors).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rfnet_tpu.ops import chamfer as jchamfer
from rfnet_tpu.ops import fps as jfps
from rfnet_tpu.ops.pallas.chamfer import nn_coords_pallas
from rfnet_tpu.ops.pallas.chamfer_dyn import nn_dyn_pallas
from rfnet_tpu.ops.pallas.fps import fps_pallas
from rfnet_tpu_torch.ops import chamfer, fps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _brute(q, t):
    """float64 squared distances (b, n, m)."""
    q, t = np.asarray(q, np.float64), np.asarray(t, np.float64)
    return np.sum((q[:, :, None] - t[:, None]) ** 2, -1)


def _blobs(rng, b, n):
    centers = rng.randn(6, 3).astype(np.float32)
    return np.stack([
        (centers[rng.randint(0, 6, n)] + 0.1 * rng.randn(n, 3)).astype(np.float32)
        for _ in range(b)
    ])


def _tie_cases(rng):
    t = rng.rand(1, 64, 3).astype(np.float32)
    flat_q, flat_t = rng.rand(1, 100, 3).astype(np.float32), rng.rand(1, 130, 3).astype(np.float32)
    flat_q[..., 2] = 0.5
    flat_t[..., 2] = 0.5
    return [
        (_blobs(rng, 2, 300), _blobs(rng, 2, 520)),
        # each target three times: exact distance ties
        (rng.rand(1, 40, 3).astype(np.float32), np.concatenate([t, t[:, ::-1], t], axis=1)),
        (flat_q, flat_t),  # all z equal
    ]


@pytest.mark.parametrize("b,n,npoint", [(2, 3000, 32), (2, 200, 24), (1, 500, 64)])
def test_fps_indices_identical_to_jax(rng, b, n, npoint):
    """FPS picks are discrete and one rounding flip cascades: the port's
    plain version must give the very indices of ``_fps_single`` and of the
    Pallas kernel (interpret mode)."""
    xyz = rng.randn(b, n, 3).astype(np.float32)
    ours = fps.farthest_point_sample(npoint, _t(xyz)).numpy()
    scan = np.asarray(jfps.farthest_point_sample(npoint, jnp.asarray(xyz)))
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(fps_pallas(npoint, jnp.asarray(xyz)))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, scan)
    np.testing.assert_array_equal(ours, kern)


def test_sampling_gathers_fps_points(rng):
    xyz = rng.rand(2, 100, 3).astype(np.float32)
    idx, pts = fps.sampling(8, _t(xyz))
    jidx, jpts = jfps.sampling(8, jnp.asarray(xyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    with pytest.raises(ValueError):
        fps.sampling(8, _t(xyz), "r")  # the random mode needs a generator


@pytest.mark.parametrize("case", ["random", "dup_targets"])
def test_nearest_neighbor_coords_matches_jax(rng, case):
    """Distances match the JAX CPU path and ``nn_coords_pallas``; each
    returned neighbour is a nearest one. Tolerance rtol 1e-5 / atol 1e-6:
    the |t|²−2q·t expansion rounds in another order in each (the JAX CPU
    path adds |q|² before the min, through a matmul)."""
    if case == "random":
        q, t = rng.rand(2, 70, 3).astype(np.float32), rng.rand(2, 150, 3).astype(np.float32)
    else:
        base = rng.rand(1, 90, 3).astype(np.float32)
        q, t = rng.rand(1, 50, 3).astype(np.float32), np.concatenate([base, base], 1)
    d, nn_pts = chamfer.nearest_neighbor_coords(_t(q), _t(t))
    jd, jnn = jchamfer.nearest_neighbor_coords(jnp.asarray(q), jnp.asarray(t))
    with pltpu.force_tpu_interpret_mode():
        kd, knn = nn_coords_pallas(jnp.asarray(q), jnp.asarray(t))
    bd = _brute(q, t).min(-1)
    for other in (jd, kd):
        np.testing.assert_allclose(d.numpy(), np.asarray(other), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-5, atol=1e-6)
    picked = np.sum((q.astype(np.float64) - nn_pts.numpy()) ** 2, -1)
    np.testing.assert_allclose(picked, bd, rtol=1e-5, atol=1e-6)
    if case == "dup_targets":
        # duplicated rows tie exactly: both sides return the same coordinates
        np.testing.assert_array_equal(nn_pts.numpy(), np.asarray(knn))
    # the first copy of a duplicated target wins
    _, idx = chamfer.nearest_neighbor(_t(q), _t(t))
    assert case == "random" or int(idx.max()) < 90


def test_sort_by_z_matches_jax(rng):
    x = rng.rand(2, 300, 3).astype(np.float32)
    x[:, ::7, 2] = 0.25  # ties in z: both sorts are stable
    xs, order = chamfer.sort_by_z_with_order(_t(x))
    jxs, jorder = jchamfer.sort_by_z_with_order(jnp.asarray(x))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))


@pytest.mark.parametrize("case", range(3))
def test_sorted_nn_matches_jax_dyn_kernel(rng, case):
    """The port's sorted-space scan (plain version of K3) against
    ``nn_dyn_pallas`` in interpret mode, and the unsorting wrapper against
    ``nearest_neighbor_dyn``. Distances to rtol 1e-5 / atol 1e-6 (sum of
    squares here, |t|²−2q·t there); each index picks a nearest target."""
    q, t = _tie_cases(rng)[case]
    qs, _ = chamfer.sort_by_z_with_order(_t(q))
    ts, _ = chamfer.sort_by_z_with_order(_t(t))
    d, i = chamfer.nn_dyn(qs, ts)
    with pltpu.force_tpu_interpret_mode():
        kd, _ = nn_dyn_pallas(jnp.asarray(qs.numpy()), jnp.asarray(ts.numpy()))
        jd, _ = jchamfer.nearest_neighbor_dyn(jnp.asarray(q), jnp.asarray(t))
    np.testing.assert_allclose(d.numpy(), np.asarray(kd), rtol=1e-5, atol=1e-6)
    bd = _brute(qs.numpy(), ts.numpy())
    np.testing.assert_allclose(np.take_along_axis(bd, i.numpy()[..., None].astype(np.int64), 2)[..., 0],
                               bd.min(-1), rtol=1e-5, atol=1e-6)
    ud, ui = chamfer.nearest_neighbor_dyn(_t(q), _t(t))
    np.testing.assert_allclose(ud.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    bu = _brute(q, t)
    np.testing.assert_allclose(np.take_along_axis(bu, ui.numpy()[..., None].astype(np.int64), 2)[..., 0],
                               bu.min(-1), rtol=1e-5, atol=1e-6)


def test_sorted_nn_ties_lowest_index(rng):
    """Duplicated targets: the index is the lowest sorted one, as the JAX
    kernel's (interpret mode) and numpy's argmin give — ties are exact, so
    indices are compared here."""
    base = rng.rand(1, 80, 3).astype(np.float32)
    t = np.concatenate([base, base], 1)
    q = rng.rand(1, 50, 3).astype(np.float32)
    qs, _ = chamfer.sort_by_z_with_order(_t(q))
    ts, _ = chamfer.sort_by_z_with_order(_t(t))
    _, i = chamfer.nn_dyn(qs, ts)
    with pltpu.force_tpu_interpret_mode():
        _, ki = nn_dyn_pallas(jnp.asarray(qs.numpy()), jnp.asarray(ts.numpy()))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(i.numpy(), _brute(qs.numpy(), ts.numpy()).argmin(-1))


@pytest.mark.parametrize("force_sorted", [False, True])
def test_eval_metrics_match_jax(rng, force_sorted):
    """Per-sample CD means and the one-sided fidelity mean against the JAX
    functions, on their dense CPU path and on their sorted path through the
    Pallas kernel (interpret mode). rtol 1e-5: these clouds have no
    near-zero distances, where √ would magnify the rounding of the JAX
    package's |t|²−2q·t expansion."""
    a, b = _blobs(rng, 2, 300), _blobs(rng, 2, 520)
    m1, m2 = chamfer.chamfer_sample_means(_t(a), _t(b))
    f = chamfer.nn_sample_mean_one(_t(a), _t(b))
    with pltpu.force_tpu_interpret_mode():
        j1, j2 = jchamfer.chamfer_sample_means(jnp.asarray(a), jnp.asarray(b), force_sorted)
        jf = jchamfer.nn_sample_mean_one(jnp.asarray(a), jnp.asarray(b), force_sorted)
    for ours, ref in ((m1, j1), (m2, j2), (f, jf)):
        assert ours.shape == (2,)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


def test_chamfer_sqrt_is_correctly_rounded():
    """The chamfer means' √ equals numpy's float32 √ (the IEEE root, correctly
    rounded) bit for bit, over squared distances from 1e-12 to 100."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(1 << 18), 10.0 ** rng.uniform(-12, 2, 1 << 18)])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(chamfer._sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


def test_ops_reject_bad_input(rng):
    q = _t(rng.rand(1, 10, 3).astype(np.float32))
    with pytest.raises(ValueError):
        chamfer.nn_coords(q.double(), q.double())
    with pytest.raises(ValueError):
        chamfer.nn_dyn(q, _t(rng.rand(2, 10, 3).astype(np.float32)))
    with pytest.raises(ValueError):
        fps.farthest_point_sample(4, q[..., :2])


def test_port_never_imports_jax():
    """Importing the port and every submodule (the trainer's and the data
    path's among them) loads neither JAX nor the JAX package, nor the
    ``msgpack`` and ``lmdb`` packages the card's machine lacks."""
    code = (
        "import sys, pkgutil, importlib, rfnet_tpu_torch\n"
        "names = {m.name for m in pkgutil.walk_packages(rfnet_tpu_torch.__path__,"
        " 'rfnet_tpu_torch.')}\n"
        "for name in sorted(names):\n"
        "    importlib.import_module(name)\n"
        "need = {'rfnet_tpu_torch.' + m for m in ('train', 'losses', 'eval', 'ops.emd',"
        " 'ops.nn_grad', 'ops.chamfer', 'ops.chamfer_pruned', 'ops.chamfer_tile', 'ops.grouping',"
        " 'ops.interpolate', 'ops.auction', 'data.dataset', 'kernels', 'data.lmdb_pure',"
        " 'data.msgpack_lite', 'data.convert', 'data.native', 'data.online',"
        " 'compat.ckpt_compat', 'parallel', 'parallel.mesh', 'ops.sharded')}\n"
        "assert need <= names, need - names\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import profile_torch_serving, bench_torch_nn_sorted\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'rfnet_tpu' or k.startswith('rfnet_tpu.')"
        " or k.split('.')[0] in ('msgpack', 'lmdb'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

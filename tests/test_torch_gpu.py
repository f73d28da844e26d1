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


def test_kernel_rejects_bad_input(cuda):
    q, t = _clouds(4, (1, 10, 3), (1, 10, 3))
    with pytest.raises(ValueError):
        chamfer.nn_coords(q.to(cuda).double(), t.to(cuda).double())
    with pytest.raises(ValueError):
        chamfer.nn_dyn(q.to(cuda), t)  # devices differ

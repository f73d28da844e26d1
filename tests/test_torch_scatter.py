"""K5's plain version (``rfnet_tpu_torch/ops/nn_grad.py:_scatter_plain``),
the CPU path of ``nn_grad_scatter``, against a float64 scatter in numpy, from
call to call, and against a sequential fp32 loop. The comparison with the JAX
package's ``nn_grad_scatter`` on the same numpy inputs is
``tests/test_torch_losses.py::test_nn_grad_plain_matches_jax_kernel``."""

import numpy as np
import pytest
import torch

from rfnet_tpu_torch.ops.nn_grad import nn_grad_scatter


def _case(kind, b, n, m, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    g = rng.randn(b, n).astype(np.float32)
    idx = {
        "random": rng.randint(0, m, (b, n)),
        "all_to_one": np.full((b, n), m - 1),
        "runs": np.sort(rng.randint(0, max(1, m // 40), (b, n)) * 40 % m, axis=1),
    }[kind].astype(np.int32)
    return x1, g, idx


@pytest.mark.parametrize("kind", ["random", "all_to_one", "runs"])
@pytest.mark.parametrize("b,n,m", [(2, 300, 130), (1, 96, 520), (2, 257, 257)])
def test_scatter_plain_equals_float64_scatter(kind, b, n, m):
    """Ragged n != m both ways and every query on one target: the plain sums
    are the float64 sums to fp32 rounding, and adding in ascending query
    order makes them the same from call to call."""
    x1, g, idx = _case(kind, b, n, m, 5)
    sp, sw = nn_grad_scatter(torch.from_numpy(x1), torch.from_numpy(g), torch.from_numpy(idx), m)
    assert sp.shape == (b, m, 3) and sw.shape == (b, m)
    ref = np.zeros((b, m, 4))
    src = np.concatenate([g[..., None].astype(np.float64) * x1, g[..., None]], -1)
    for bi in range(b):
        np.add.at(ref[bi], idx[bi], src[bi])
    scale = np.abs(src).sum(1, keepdims=True).max()  # a run can hold every query
    np.testing.assert_allclose(sp.numpy(), ref[..., :3], rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(sw.numpy(), ref[..., 3], rtol=0, atol=1e-6 * scale)
    sp2, sw2 = nn_grad_scatter(torch.from_numpy(x1), torch.from_numpy(g), torch.from_numpy(idx), m)
    assert torch.equal(sp, sp2) and torch.equal(sw, sw2)
    # a target no query picked holds exact zeros
    empty = np.setdiff1d(np.arange(m), idx[0])
    assert not sp[0, empty].any() and not sw[0, empty].any()


def test_scatter_plain_adds_in_ascending_query_order():
    """The order is the contract K5 is held to bit for bit: with values that
    do not commute under fp32 rounding, the sums equal a sequential loop."""
    g = torch.tensor([[1e8, 1.0, -1e8, 1.0, 3.0]])
    x1 = torch.ones(1, 5, 3)
    idx = torch.tensor([[2, 2, 2, 2, 0]], dtype=torch.int32)
    sp, sw = nn_grad_scatter(x1, g, idx, 4)
    seq = np.float32(0)
    for v in (1e8, 1.0, -1e8, 1.0):
        seq = np.float32(seq + np.float32(v))
    assert float(sw[0, 2]) == float(seq) == 1.0  # (1e8 + 1) rounds the 1 away
    assert sw[0].tolist() == [3.0, 0.0, 1.0, 0.0] and sp[0, 2].tolist() == [1.0] * 3

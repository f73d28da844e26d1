"""A dense layer given its input as blocks (``rfnet_tpu_torch/nn.py``): a
block with one point a cloud is multiplied once a cloud, into a per-cloud
bias, and the result equals the product of the blocks' concatenation, in
its values and in the gradients of the inputs, the weight and the bias."""

import numpy as np
import pytest
import torch

from rfnet_tpu_torch import nn as tnn
from rfnet_tpu_torch.eval import load_state
from rfnet_tpu_torch.models import RFNet

B, N = 3, 7
# blocks as (points, channels): 1 point is a per-cloud block
LAYOUTS = {
    "cloud_first": ((1, 5), (N, 3)),
    "cloud_middle": ((N, 3), (1, 5), (N, 4)),
    "cloud_last": ((N, 3), (N, 4), (1, 5)),
    "two_clouds": ((N, 3), (1, 5), (1, 6)),
    "every_block_per_point": ((N, 3), (N, 4)),
    "every_block_per_cloud": ((1, 3), (1, 5)),
}


def _layer(kind: str, in_ch: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(3)
    if kind == "dense":
        layer = tnn.Dense(in_ch, 6, g)
    elif kind == "step_dense":
        layer = tnn.StepDense(in_ch, 6, 3, g)
    else:
        layer = tnn.PointMLP(in_ch, (6, 4), generator=g)
    with torch.no_grad():  # biases away from zero, so each is exercised
        for name, p in layer.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g))
    return layer


def _call(kind: str, layer, x):
    return layer(x, 2) if kind == "step_dense" else layer(x)


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.shape == want.shape, what
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), (what, err)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["dense", "step_dense", "point_mlp"])
def test_blocks_equal_the_concatenated_product(kind, layout):
    """Output and the gradients of every block, the weight and the bias
    equal those of the concatenation to 1e-6 relative."""
    rng = np.random.RandomState(0)
    shapes = LAYOUTS[layout]
    blocks = [torch.from_numpy(rng.randn(B, n, c).astype(np.float32)).requires_grad_()
              for n, c in shapes]
    layer = _layer(kind, sum(c for _, c in shapes))
    n = max(n for n, _ in shapes)
    seed = torch.from_numpy(rng.randn(B, n, 6 if kind != "point_mlp" else 4).astype(np.float32))

    def grads(x):
        out = _call(kind, layer, x)
        layer.zero_grad()
        for blk in blocks:
            blk.grad = None
        (out * seed).sum().backward()
        params = {k: p.grad.clone() for k, p in layer.named_parameters()}
        return out.detach(), [blk.grad.clone() for blk in blocks], params

    joined = torch.cat([blk.expand(B, n, blk.shape[-1]) for blk in blocks], -1)
    want, want_x, want_p = grads(joined)
    got, got_x, got_p = grads(blocks)
    _close(got, want, "output")
    for i, (g, w) in enumerate(zip(got_x, want_x)):
        _close(g, w, f"block {i}'s gradient")
    for k in want_p:
        _close(got_p[k], want_p[k], f"{k}'s gradient")


def test_rfnet_state_dict_is_the_weights_file():
    """The parameters, their names and shapes are those of the converged
    weights' file, which loads strictly, and the count is the golden one."""
    model = load_state("weights/rfnet_r4_105000.npz")
    fresh = RFNet().state_dict()
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in fresh.items()]
    assert sum(v.numel() for v in fresh.values()) == 3_827_611

"""The port's point-MLP primitives and RFNet against the JAX package's, on
the same converted flax parameters and the same numpy inputs."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfnet_tpu import nn as jnn
from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu.ops.chamfer import chamfer_sample_means as j_cd_means
from rfnet_tpu.ops.chamfer import nn_sample_mean_one as j_fidelity
from rfnet_tpu_torch import nn as tnn
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.data.dataset import synthetic_pairs
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.ops.chamfer import chamfer_sample_means, nn_sample_mean_one

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("out1", "out2", "out3", "out4", "points1_pre", "points2_pre", "moves1",
          "moves2", "final_move", "code1", "code2", "code3", "decfactor_sq")


def _load(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(flatten_params(flax_params)), strict=True)
    return module


class _StepMLP(fnn.Module):
    """A StepDense-backed PointMLP with a linear last layer, for one test."""

    @fnn.compact
    def __call__(self, x, step):
        return jnn.PointMLP((16, 8), last_act=None, n_steps=3, name="mlp")(x, step)


@pytest.mark.parametrize("prim", ["dense", "step_dense", "point_mlp", "step_mlp"])
def test_primitives_match_flax(rng, prim):
    """Each primitive on converted params equals flax to rtol 1e-5 / atol
    1e-6 (the same float32 products, summed in another order)."""
    x = rng.randn(2, 7, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    if prim == "dense":
        fm, tm, args = jnn.dense(6, "d"), tnn.Dense(5, 6), ()
    elif prim == "step_dense":
        fm, tm, args = jnn.StepDense(6, 3), tnn.StepDense(5, 6, 3), (2,)
    elif prim == "point_mlp":
        fm, tm, args = jnn.PointMLP((16, 8)), tnn.PointMLP(5, (16, 8)), ()
    else:
        fm, args = _StepMLP(), (1,)
        tm = torch.nn.Module()
        tm.mlp = tnn.PointMLP(5, (16, 8), last_act=None, n_steps=3)
    params = fm.init(key, jnp.asarray(x), *args)["params"]
    # give biases nonzero values so the per-step table is actually exercised
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(key, p.shape), params
    )
    _load(tm, params)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x), *args))
    with torch.no_grad():
        mod = tm.mlp if prim == "step_mlp" else tm
        got = mod(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    l2 = tnn.l2_regularizer(tm).item()
    np.testing.assert_allclose(l2, float(jnn.l2_regularizer(params)), rtol=1e-5)


def test_small_model_every_output_matches_jax(rng):
    """RFNet(n_seed=4, up_ratio=4) on flax params from PRNGKey(seed), a
    (2, 3000, 3) input: every RFNetOutputs field agrees to rtol 1e-4 /
    atol 1e-5 — matmuls sum in another order, and three recurrent steps
    carry that rounding along."""
    pc = rng.rand(2, 3000, 3).astype(np.float32)
    jm = JRFNet(n_seed=4, up_ratio=4)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(pc))
    want = jm.apply(params, jnp.asarray(pc))
    model = _load(RFNet(n_seed=4, up_ratio=4), params["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(pc))
    for field in FIELDS:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=field)


def test_fullsize_param_count_golden():
    """3,827,611 parameters, as the JAX model and the reference checkpoint;
    the per-step bias tables are (n_steps, ch)."""
    model = RFNet()
    assert sum(p.numel() for p in model.parameters()) == 3_827_611
    assert model.cell.state_mlp.l0.bias.shape == (3, 256)
    assert model.decode_cell.mlp.l0.bias.shape == (2, 256)
    assert model.recover1.mlp.l0.bias.shape == (256,)


def test_init_is_seeded():
    a = RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(5))
    b = RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.recover1.out.weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6.0 / (256 + 256))
    assert float(a.recover1.out.bias.detach().abs().max()) == 0.0


def _f64_mean_nn(q, t):
    """float64 per-sample mean √NN distance, q -> t."""
    q = torch.from_numpy(np.asarray(q, np.float64))
    t = torch.from_numpy(np.asarray(t, np.float64))
    return torch.cdist(q, t).min(-1).values.mean(-1).numpy()


def test_converged_weights_full_size():
    """The committed converged weights (run_r4/bestrecord/105000), loaded by
    the JAX package's own loader, converted, run on one synthetic cloud at
    batch 1. out4: >= 99.9 % of points within 1e-4 (near-tie merges can
    flip an argmin). Per-sample cd and fidelity: within 1e-4 relative of
    the same metric in float64 on the JAX model's out4. (The JAX CPU metric
    itself, a |t|²−2q·t expansion whose rounding √ magnifies near d = 0,
    sits 1.0e-4 relative off float64 on this cloud, so it is held to the
    float64 value at 2e-4; the port's sums of squares agree with float64
    to ~1e-7.)"""
    from rfnet_tpu.eval import load_state
    from rfnet_tpu.train import TrainConfig

    state = load_state(os.path.join(REPO, "run_r4", "bestrecord"), TrainConfig())
    flat = flatten_params(jax.device_get(state.params["params"]))
    model = RFNet()
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    _, part, gt = next(synthetic_pairs(1, seed=1234))
    part, gt = part[None], gt[None]
    want = jax.jit(state.apply_fn)(state.params, jnp.asarray(part)).out4
    with torch.no_grad():
        got = model(torch.from_numpy(part)).out4
    close = np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-4, axis=-1)
    assert close.mean() >= 0.999, close.mean()

    w = np.asarray(want)
    cd64 = (_f64_mean_nn(w, gt) + _f64_mean_nn(gt, w)) / 2
    fid64 = _f64_mean_nn(part, w)
    m1, m2 = chamfer_sample_means(got, torch.from_numpy(gt))
    np.testing.assert_allclose(((m1 + m2) / 2).numpy(), cd64, rtol=1e-4)
    np.testing.assert_allclose(nn_sample_mean_one(torch.from_numpy(part), got).numpy(),
                               fid64, rtol=1e-4)
    jm1, jm2 = j_cd_means(want, jnp.asarray(gt))
    np.testing.assert_allclose(np.asarray((jm1 + jm2) / 2), cd64, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(j_fidelity(jnp.asarray(part), want)), fid64, rtol=2e-4)
    assert 0.0 < float(m1[0]) < 0.1  # a trained model: the completion fits

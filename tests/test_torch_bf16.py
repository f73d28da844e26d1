"""The port's bfloat16 compute mode (``RFNet(dtype=torch.bfloat16)``,
``TrainConfig.compute_dtype``) against the JAX package's, on the same
converted flax parameters and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_codec import private_jax_codec  # noqa: F401 (a fixture)
from test_torch_eval import _assert_rows_close, _serve_both

from rfnet_tpu import losses as jlosses
from rfnet_tpu import nn as jnn
from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu.ops.fps import farthest_point_sample as jfps
from rfnet_tpu.ops.fps import gather_point as jgather
from rfnet_tpu_torch import nn as tnn
from rfnet_tpu_torch import train
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.ops import chamfer, emd, fps

BF16 = torch.bfloat16
FIELDS = ("out1", "out2", "out3", "out4", "points1_pre", "points2_pre", "moves1",
          "moves2", "final_move", "code1", "code2", "code3", "decfactor_sq")


def _state_dict(params):
    return flax_to_state_dict(flatten_params(params["params"]))


@pytest.mark.parametrize("prim", ["dense", "step_dense", "point_mlp"])
def test_primitives_bf16_match_flax(rng, prim):
    """Each primitive computing in bfloat16 returns bfloat16, within 1e-2
    relative (a few bfloat16 ulps: both sum the products in float32 and
    round once, in other orders) of flax's bfloat16 layer, from float32
    parameters that stay float32."""
    x = rng.randn(2, 7, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    if prim == "dense":
        fm, tm, args = jnn.dense(6, "d", jnp.bfloat16), tnn.Dense(5, 6, dtype=BF16), ()
    elif prim == "step_dense":
        fm, tm, args = jnn.StepDense(6, 3, dtype=jnp.bfloat16), tnn.StepDense(5, 6, 3,
                                                                              dtype=BF16), (2,)
    else:
        fm = jnn.PointMLP((16, 8), dtype=jnp.bfloat16)
        tm, args = tnn.PointMLP(5, (16, 8), dtype=BF16), ()
    params = fm.init(key, jnp.asarray(x), *args)
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jax.random.normal(key, p.shape), params)
    want = fm.apply(params, jnp.asarray(x), *args)
    tm.load_state_dict(_state_dict(params), strict=True)
    got = tm(torch.from_numpy(x), *args)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_bf16_forward_matches_jax_bf16(rng):
    """Mirrors ``tests/test_model.py::test_bf16_compute_mode``: every output
    has JAX's dtype (the coordinates float32, the codes and moves
    bfloat16, so the same values are quantized); the final output is
    within 0.01 mean |Δ| of JAX's bfloat16 forward (a third of the bar JAX
    allows between bfloat16 and float32); and the port's bfloat16 forward
    really differs from its float32 one, by less than 0.03 mean |Δ|."""
    pc = rng.rand(2, 100, 3).astype(np.float32)
    params = jax.jit(JRFNet(n_seed=4, up_ratio=4).init)(jax.random.PRNGKey(0), jnp.asarray(pc))
    want = jax.jit(JRFNet(n_seed=4, up_ratio=4, dtype=jnp.bfloat16).apply)(params,
                                                                           jnp.asarray(pc))
    port16 = RFNet(n_seed=4, up_ratio=4, dtype=BF16)
    port32 = RFNet(n_seed=4, up_ratio=4)
    for m in (port16, port32):
        m.load_state_dict(_state_dict(params), strict=True)
    with torch.no_grad():
        got, ref32 = port16(torch.from_numpy(pc)), port32(torch.from_numpy(pc))
    for name in FIELDS:
        jd = getattr(want, name).dtype
        assert getattr(got, name).dtype == (BF16 if jd == jnp.bfloat16 else torch.float32), name
    assert got.out4.dtype == torch.float32
    err = float(np.abs(got.out4.numpy() - np.asarray(want.out4)).mean())
    assert err <= 0.01, err
    own = float((got.out4 - ref32.out4).abs().mean())
    assert 0 < own < 0.03, own


def test_bf16_train_step_matches_jax(rng):
    """One step at ``compute_dtype="bfloat16"`` from the JAX model's flax
    parameters: every loss term within 1e-3 relative of JAX's bfloat16 step
    (1.2e-4 measured, against 1.5e-6 in float32: the two packages round the
    bfloat16 features at different points, bias adds and reductions);
    the gradients come back float32 and finite, and the parameters stay
    float32."""
    gt = rng.rand(2, 128, 3).astype(np.float32)
    partial = (gt[:, :64] + 0.01 * rng.randn(2, 64, 3)).astype(np.float32)
    model = JRFNet(n_seed=4, up_ratio=4, dtype=jnp.bfloat16)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 3), jnp.float32))
    g1 = jgather(jnp.asarray(gt), jfps(8, jnp.asarray(gt)))
    g2 = jgather(jnp.asarray(gt), jfps(32, jnp.asarray(gt)))
    jlb = jax.jit(lambda p: jlosses.total_loss(model.apply(p, jnp.asarray(partial)),
                                               jnp.asarray(gt), g1, g2, 0))(params)
    config = train.TrainConfig(batch_size=2, innum=64, ptnum=128, n_seed=4, up_ratio=4,
                               compute_dtype="bfloat16")
    state = train.create_state(config, "cpu")
    state.model.load_state_dict(_state_dict(params), strict=True)
    lb, _ = train.train_step(state, torch.from_numpy(partial), torch.from_numpy(gt), n1=8, n2=32)
    for name in lb._fields:
        np.testing.assert_allclose(float(getattr(lb, name)), float(getattr(jlb, name)),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or (p.grad.dtype == torch.float32
                                  and bool(torch.isfinite(p.grad).all())), name
    with pytest.raises(ValueError, match="compute_dtype"):
        train.create_state(train.TrainConfig(compute_dtype="float16"), "cpu")


def test_kernel_wrappers_refuse_bfloat16_coordinates():
    """Coordinates reach K1, K2, K3 and K6 as float32 only: a bfloat16 cloud
    is refused with a message, not cast."""
    x = torch.rand(2, 40, 3).to(BF16)
    y = torch.rand(2, 40, 3)
    with pytest.raises(ValueError, match="float32"):
        fps.farthest_point_sample(4, x)
    with pytest.raises(ValueError, match="float32"):
        chamfer.nearest_neighbor_coords(x, y)
    with pytest.raises(ValueError, match="float32"):
        chamfer.nn_dyn(y, x)
    with pytest.raises(ValueError, match="float32"):
        chamfer.chamfer_sample_means(x, y)
    with pytest.raises(ValueError, match="float32"):
        emd.approx_match_cost(x, y)


@pytest.mark.usefixtures("private_jax_codec")
def test_eval_cli_bf16_matches_jax_bf16(tmp_path, rng, monkeypatch):
    """``--bf16`` serves the weights with bfloat16 feature MLPs: the CSV
    matches the JAX CLI's ``--bf16`` CSV to rtol 1e-3 and differs from the
    port's float32 CSV."""
    rows = _serve_both(tmp_path, rng, monkeypatch, {
        "bf16": (["--bf16"], ["--bf16"]), "f32": (None, [])})
    _assert_rows_close(rows["torch", "bf16"], rows["jax", "bf16"], 1e-3)
    assert rows["torch", "bf16"] != rows["torch", "f32"]

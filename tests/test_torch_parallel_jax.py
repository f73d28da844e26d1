"""The port's data-parallel train step (W=2 gloo ranks on the CPU, the
``--mesh`` step) against the JAX package's mesh step,
``make_jitted_steps(config, make_mesh(2))`` on the virtual CPU mesh, from
the same weights carried across by ``compat.convert``: on a random batch
and on the batch whose halves straddle ``zero_groupnear``'s hinge."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_dist
from rfnet_tpu import losses as jlosses
from rfnet_tpu import train as jtrain
from rfnet_tpu.ops.fps import farthest_point_sample as jfps
from rfnet_tpu.ops.fps import gather_point as jgather
from rfnet_tpu.parallel import make_mesh as j_make_mesh
from test_torch_parallel import B, TINY, _batch, _flat, _hinge_batch, _rel

from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict

N1, N2 = 8, 32  # the tiny config's pyramid sizes


@pytest.fixture(scope="module")
def jax_params():
    """The JAX trainer's init (``create_state``'s, PRNGKey(1)), jitted."""
    init = jax.jit(jtrain.RFNet(n_seed=4, up_ratio=4).init)
    return init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 3), jnp.float32))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's dp mesh step over 2 devices and its global-batch gradient,
    compiled once for the module."""
    config = jtrain.TrainConfig(batch_size=B, **TINY)
    jstep, _ = jtrain.make_jitted_steps(config, j_make_mesh(2))
    model = jtrain.RFNet(n_seed=4, up_ratio=4)

    def loss_fn(p, partial, gt):
        g1, g2 = jgather(gt, jfps(N1, gt)), jgather(gt, jfps(N2, gt))
        return jlosses.total_loss(model.apply(p, partial), gt, g1, g2, 0).total

    adam = optax.adam(learning_rate=functools.partial(jlosses.learning_rate, scale=1.0))

    def state(params):  # the step donates its state: a fresh one of copied parameters
        return jtrain.TrainState.create(apply_fn=model.apply, tx=adam,
                                        params=jax.tree_util.tree_map(jnp.array, params))

    return state, jstep, jax.jit(jax.grad(loss_fn))


@pytest.fixture(scope="module")
def weights(jax_params):
    return flax_to_state_dict(flatten_params(jax_params["params"]))


@pytest.fixture(scope="module")
def hinge_params(jax_params):
    """The JAX init with the decoder's offset layer 10 times larger, so that
    the offsets at init are large enough for the hinge term to move the
    gradient well beyond the rounding of a split batch."""
    scaled = jax.tree_util.tree_map(lambda x: x, jax_params)
    layer = scaled["params"]["decode_cell"]["points_out"]
    scaled["params"]["decode_cell"]["points_out"] = {k: v * 10 for k, v in layer.items()}
    return scaled


@pytest.fixture(scope="module")
def hinge_weights(hinge_params):
    return flax_to_state_dict(flatten_params(hinge_params["params"]))


@pytest.fixture(scope="module")
def w2(tmp_path_factory, weights, hinge_weights):
    """Both steps on 2 gloo ranks in one spawn: {case: rank 0's result}."""
    tasks = [(torch_dist.train_step, (weights, *_batch(0), B)),
             (torch_dist.train_step, (hinge_weights, *_hinge_batch(), B))]
    ranks = torch_dist.run(torch_dist.suite, 2, tmp_path_factory.mktemp("jax") / "spawn", tasks)
    return {"step": [r[0] for r in ranks], "hinge_step": [r[1] for r in ranks]}


def _jax_global_step(jax_steps, params, partial, gt):
    """JAX's loss terms from its dp mesh step and its global-batch gradient."""
    state, jstep, grad = jax_steps
    _, jlb, _ = jstep(state(params), jnp.asarray(partial), jnp.asarray(gt))
    grads = grad(params, jnp.asarray(partial), jnp.asarray(gt))
    return jlb, flax_to_state_dict(flatten_params(grads["params"]))


@pytest.mark.parametrize("case", ["step", "hinge_step"])
def test_mesh_step_matches_jax_mesh_step(w2, jax_steps, jax_params, hinge_params, case):
    """The port's W=2 step from the JAX init against ``make_jitted_steps``
    on a 2-device mesh: every loss term at rtol 1e-5, the whole gradient at
    1e-4 relative L2 (tests/test_torch_train.py's tolerances)."""
    partial, gt = _batch(0) if case == "step" else _hinge_batch()
    jlb, jg = _jax_global_step(jax_steps, jax_params if case == "step" else hinge_params,
                               partial, gt)
    got = w2[case][0]
    if case == "hinge_step":  # the halves straddle the first hinge in JAX too
        assert float(jlb.loss_d1) == 0.0
    for name in got["lb"]:
        np.testing.assert_allclose(got["lb"][name], float(getattr(jlb, name)), rtol=1e-5,
                                   atol=1e-9, err_msg=name)
    names = sorted(got["grads"])
    want = np.concatenate([np.asarray(jg[n]).ravel() for n in names])
    assert _rel(_flat(got["grads"], names), want) < 1e-4

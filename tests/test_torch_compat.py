"""The converged weights the card loads, and the legacy shared-bias upgrade,
against the JAX package's orbax load and its ``ckpt_compat.upgrade``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rfnet_tpu.compat import ckpt_compat as jcompat
from rfnet_tpu.train import TrainConfig, create_state
from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch.compat import ckpt_compat
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.models import RFNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "run_r4", "bestrecord")
WEIGHTS = os.path.join(REPO, "weights", "rfnet_r4_105000.npz")


@pytest.fixture(scope="module")
def orbax_params():
    """The record's params as the JAX eval loads them (orbax through
    ``ckpt_compat.restore_flexible``, as ``rfnet_tpu.eval.load_state`` does),
    with the abstract state traced instead of initialised eagerly."""
    import orbax.checkpoint as ocp

    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=cpu),
        jax.eval_shape(lambda: create_state(TrainConfig())))
    mgr = ocp.CheckpointManager(RECORD)
    state, upgraded = jcompat.restore_flexible(mgr, mgr.latest_step(), abstract)
    assert not upgraded and int(state.step) == 105000
    return jax.device_get(state.params["params"])


def test_weights_npz_equals_orbax_load(orbax_params):
    flat = flatten_params(orbax_params)
    with np.load(WEIGHTS) as z:
        assert sorted(z.files) == sorted([*flat, "__step__", "__cd__"])
        for k, v in flat.items():
            assert z[k].dtype == np.float32 and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
        with open(os.path.join(RECORD, "best.json")) as f:
            best = json.load(f)
        assert int(z["__step__"]) == best["step"] == 105000
        assert float(z["__cd__"]) == best["cd"]
    assert len(flat) == 225
    assert sum(v.size for v in flat.values()) == 3_827_611


def test_load_state_npz_equals_converted_orbax(orbax_params, capsys):
    model = teval.load_state(WEIGHTS)
    out = capsys.readouterr().out
    assert "step 105000" in out and "legacy" not in out
    want = flax_to_state_dict(flatten_params(orbax_params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _collapse(flat):
    """The legacy layout: every cell / decode_cell bias table shared, one
    (ch,) vector (its first row)."""
    return {k: (v[0] if jcompat._is_step_bias(_dict_path(k)) and v.ndim == 2 else v)
            for k, v in flat.items()}


def _dict_path(key):
    return tuple(jax.tree_util.DictKey(p) for p in key.split("/"))


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        *head, leaf = k.split("/")
        node = tree
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_legacy_upgrade_matches_jax(orbax_params, tmp_path, capsys):
    """A legacy flat tree upgrades to the state_dict JAX's upgrade gives on
    the same tree; load_state does it on an npz and says so."""
    flat = flatten_params(orbax_params)
    legacy = _collapse(flat)
    n_legacy = sum(legacy[k].shape != flat[k].shape for k in flat)
    assert n_legacy == 49  # 5 cell and 44 decode_cell biases
    expected = ckpt_compat.expected_shapes(RFNet().state_dict())
    assert expected == {k: v.shape for k, v in flat.items()}
    ours, upgraded = ckpt_compat.upgrade(legacy, expected)
    assert upgraded
    theirs = flatten_params(jax.device_get(jcompat.upgrade(_nest(legacy), orbax_params)))
    a, b = flax_to_state_dict(ours), flax_to_state_dict(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not ckpt_compat.upgrade(flat, expected)[1]

    path = str(tmp_path / "legacy.npz")
    np.savez(path, __step__=np.int64(7), **legacy)
    model = teval.load_state(path)
    out = capsys.readouterr().out
    assert "step 7" in out and "checkpoint upgraded from legacy shared-bias layout" in out
    for k, v in model.state_dict().items():
        assert torch.equal(v, a[k]), k


@pytest.mark.parametrize("leaf, shape", [
    ("cell/state_mlp/l1/bias", (385,)),          # a legacy bias of the wrong width
    ("decode_cell/mask_out/bias", (3, 256)),     # a table with another step count
    ("init_cell/mlp/l0/kernel", (255, 256)),     # not a bias at all
    ("params/init_cell/state_out/bias", (1, 512)),  # a non-cell bias as a table
])
def test_upgrade_refuses_other_mismatches(leaf, shape):
    expected = ckpt_compat.expected_shapes(RFNet(n_seed=4, up_ratio=4).state_dict())
    flat = {leaf: np.zeros(shape, np.float32)}
    with pytest.raises(ValueError, match=leaf):
        ckpt_compat.upgrade(flat, expected)


def test_eval_cli_serves_the_npz_like_the_jax_cpu_csv(tmp_path, capsys):
    """The port's eval CLI on the CPU, given the npz, scores the first cloud
    of the committed JAX CPU eval (``weights/rfnet_r4_105000.jax_cpu.csv``,
    the same dump of ``synthetic_pairs(64, seed=1234)``'s first clouds)
    within 1e-3 relative, as ``chip_smoke.py`` holds the card to all 16."""
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.data.pcd_io import save_pcd

    with open(os.path.join(REPO, "weights", "rfnet_r4_105000.jax_cpu.csv")) as f:
        mid, cd, fid = f.read().splitlines()[1].split(",")
    assert mid == "02691156/000000"
    _, part, gt = next(synthetic_pairs(1, seed=1234))
    for kind, cloud in (("partial", part), ("complete", gt)):
        path = tmp_path / "data" / kind / (mid + ".pcd")
        path.parent.mkdir(parents=True)
        save_pcd(str(path), cloud)
    (tmp_path / "test.list").write_text(mid)
    teval.main(["--list_path", str(tmp_path / "test.list"), "--data_dir",
                str(tmp_path / "data"), "--checkpoint", WEIGHTS, "--results_dir",
                str(tmp_path / "r"), "--device", "cpu", "--plot_freq", "1000"])
    assert "step 105000" in capsys.readouterr().out
    row = (tmp_path / "r" / "results.csv").read_text().splitlines()[1].split(",")
    assert row[0] == mid
    np.testing.assert_allclose([float(row[1]), float(row[2])], [float(cd), float(fid)],
                               rtol=1e-3)

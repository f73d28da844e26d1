"""Reference TF checkpoints in the port (``rfnet_tpu_torch.compat``): the
TensorBundle codec, the map of the reference graph's variables onto the
port's ``state_dict``, import and export, the CLI, and the inverse of the
flax converter — each held to the JAX package's counterpart.

The fixture ``fixtures/ref_ckpt_index.json`` is the parsed index of the
reference's trained checkpoint (``bestrecord/model-229999.index``), as in
``tests/test_ref_import.py``: every variable's name, dtype, shape and
whether Adam created slots for it (none = no gradient = a dead branch).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfnet_tpu.compat import ref_import as jref
from rfnet_tpu.compat import tf_bundle as jbundle
from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu_torch import checkpoints, train
from rfnet_tpu_torch.compat import ref_import, tf_bundle
from rfnet_tpu_torch.compat.convert import (
    flatten_params,
    flax_to_state_dict,
    save_npz,
    state_dict_to_flax,
)
from rfnet_tpu_torch.losses import chamfer_big
from rfnet_tpu_torch.models import RFNet

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_ckpt_index.json")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = 3_827_611  # the reference's trainable parameter count


def trainable_fixture_vars():
    with open(FIXTURE) as f:
        fix = json.load(f)
    return {name: rec for name, rec in fix["variables"].items()
            if rec["dtype"] == 1 and not name.startswith(ref_import.IGNORED_PREFIXES)}


def unflatten(flat):
    """Flat ``{"a/b/leaf": array}`` -> the nested dict of flax params."""
    tree = {}
    for path, value in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for key in mods:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def random_state_dict(seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
            for k, v in RFNet().state_dict().items()}


def assert_state_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def port_bundle(tmp_path_factory):
    """Full-size random weights and the bundle the port wrote of them at
    step 42, written once a module."""
    state_dict = random_state_dict(5)
    prefix = str(tmp_path_factory.mktemp("port_bundle") / "model-42")
    ref_import.export_reference_checkpoint(prefix, state_dict, step=42)
    return state_dict, prefix


# --------------------------------------------------------------------------
# TensorBundle codec
# --------------------------------------------------------------------------


def test_bundle_roundtrip(tmp_path, rng):
    tensors = {
        "a/weights": rng.randn(1, 1, 7, 5).astype(np.float32),
        "a/Variable": rng.randn(5).astype(np.float32),
        "nested/scope/x": rng.randint(0, 9, (3, 2)).astype(np.int32),
        "step": np.asarray(229999, np.int64),
    }
    prefix = str(tmp_path / "model-1")
    tf_bundle.write_bundle(prefix, tensors)
    back = tf_bundle.read_bundle(prefix)
    assert sorted(back) == sorted(tensors)
    for name, arr in tensors.items():
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(back[name]))
    num_shards, entries = tf_bundle.read_index(prefix + ".index")
    assert num_shards == 1
    assert entries["a/weights"].shape == (1, 1, 7, 5)
    assert entries["a/weights"].np_dtype == np.float32
    assert entries["step"].np_dtype == np.int64
    # the JAX codec reads what the port's wrote, and writes the same bytes
    jprefix = str(tmp_path / "jax-1")
    jbundle.write_bundle(jprefix, tensors)
    for ext in (".index", ".data-00000-of-00001"):
        with open(prefix + ext, "rb") as f, open(jprefix + ext, "rb") as g:
            assert f.read() == g.read(), ext
    for name, arr in jbundle.read_bundle(prefix).items():
        np.testing.assert_array_equal(arr, tensors[name])


def test_bundle_crc_detects_corruption(tmp_path, rng):
    prefix = str(tmp_path / "model-9")
    tf_bundle.write_bundle(prefix, {"w": rng.randn(4, 4).astype(np.float32)})
    data_file = prefix + ".data-00000-of-00001"
    raw = bytearray(open(data_file, "rb").read())
    raw[3] ^= 0xFF
    open(data_file, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        tf_bundle.read_bundle(prefix)
    assert tf_bundle.masked_crc32c(b"123456789") == jbundle.masked_crc32c(b"123456789")


# --------------------------------------------------------------------------
# The map: parity with the trained artifact
# --------------------------------------------------------------------------


def test_mapping_is_a_bijection_with_the_trained_artifact():
    """Every trainable variable of the trained reference checkpoint maps to
    one entry (or one bias row) of the port's full-size state_dict and back,
    shapes included; the map is JAX's, renamed to the port's keys."""
    mapping = ref_import.reference_variable_map()
    trainable = trainable_fixture_vars()
    assert sorted(mapping) == sorted(trainable)

    state_dict = RFNet().state_dict()
    covered = {}
    for ref_name, (kind, key, row) in mapping.items():
        shape = tuple(state_dict[key].shape)
        ref_shape = tuple(trainable[ref_name]["shape"])
        if kind == "kernel":
            assert ref_shape == (1, 1) + shape[::-1], ref_name
            covered[key] = covered.get(key, 0) + 1
        elif kind == "bias" and row is not None:
            assert ref_shape == shape[1:], ref_name
            covered.setdefault(key, set()).add(row)
        else:
            assert ref_shape == shape, ref_name
            covered[key] = covered.get(key, 0) + 1
    assert set(covered) == set(state_dict)
    for key, c in covered.items():
        if isinstance(c, set):
            assert c == set(range(state_dict[key].shape[0])), key  # every bias row
        else:
            assert c == 1, key

    total = sum(int(np.prod(r["shape"])) for r in trainable.values())
    assert total == sum(t.numel() for t in state_dict.values()) == PARAMS

    # the same variables as the JAX map, at the port's name of each flax leaf
    jmapping = jref.reference_variable_map()
    assert sorted(jmapping) == sorted(mapping)
    for ref_name, (kind, path, row) in jmapping.items():
        flax_key = "/".join(path)
        torch_key = next(iter(flax_to_state_dict({flax_key: np.zeros((1, 1))})))
        assert mapping[ref_name] == (kind, torch_key, row), ref_name


def _dead(key: str, row) -> bool:
    """The trained artifact's dead branches, in the port's names: the second
    decode step's state path (its output state feeds only the final refine
    layer's feat path) and that feat path itself."""
    parts = key.split(".")
    if parts[0] == "refine_layer_final" and parts[1] in ("feat_mlp", "feat_out"):
        return row is None
    if parts[0] == "decode_cell" and parts[-1] == "bias" and row == 1:
        return (parts[1] == "state_mlp" or parts[1].startswith("expand"))
    return False


def test_untrained_fingerprint_matches_dead_branches():
    """Variables WITHOUT Adam slots in the trained checkpoint land exactly on
    decode_cell's bias row 1 of the state layers and refine_layer_final's
    feat_mlp/feat_out, in the port's names — as in the JAX package."""
    mapping = ref_import.reference_variable_map()
    untrained = {(mapping[name][1], mapping[name][2])
                 for name, rec in trainable_fixture_vars().items() if not rec["has_adam_slot"]}
    everything = {(key, row) for _, key, row in mapping.values()}
    assert untrained == {e for e in everything if _dead(*e)}
    assert len(untrained) == 40


def test_gradient_flow_reproduces_fingerprint(rng):
    """The port's own gradient support, at the tiny config, reproduces the
    fingerprint: zero gradient exactly on decode_cell's step-1 state-path
    bias rows and refine_layer_final's feat layers, nonzero elsewhere."""
    model = RFNet(n_seed=4, up_ratio=4)
    pc = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32))
    gt = torch.from_numpy(rng.rand(2, 128, 3).astype(np.float32))
    out = model(pc)
    loss = (chamfer_big(gt[:, :8], out.out1)[0] + chamfer_big(gt[:, :32], out.out2)[0]
            + chamfer_big(gt, out.out3)[0] + chamfer_big(gt, out.out4)[0])
    loss.backward()
    checked = 0
    for key, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if _dead(key, None):
            assert torch.all(g == 0), f"expected dead: {key}"
        elif _dead(key, 1):
            assert torch.all(g[1] == 0), f"expected dead row 1: {key}"
            assert torch.any(g[0] != 0), f"expected live row 0: {key}"
        elif key.endswith("bias") and g.dim() == 2:
            for r in range(g.shape[0]):
                assert torch.any(g[r] != 0), f"expected live rows: {key} row {r}"
        else:
            assert torch.any(g != 0), f"expected live: {key}"
        checked += 1
    assert checked == len(model.state_dict())


# --------------------------------------------------------------------------
# Import and export
# --------------------------------------------------------------------------


def test_import_export_roundtrip(port_bundle, tmp_path):
    """export_reference_checkpoint -> import_reference_checkpoint is exact,
    and the result loads into the full-size model with strict=True."""
    state_dict, prefix = port_bundle
    assert os.path.exists(prefix + ".index")
    assert os.path.exists(prefix + ".data-00000-of-00001")
    with open(os.path.join(os.path.dirname(prefix), "checkpoint")) as f:
        assert f.read() == 'model_checkpoint_path: "model-42"\nall_model_checkpoint_paths: "model-42"\n'
    model = RFNet()
    back = ref_import.import_reference_checkpoint(prefix, model)
    assert_state_dicts_equal(back, state_dict)
    model.load_state_dict(back, strict=True)
    step = tf_bundle.read_bundle(prefix, names={"Variable"})["Variable"]
    # shape (1,), as the JAX writer stores it (np.ascontiguousarray is 1-d)
    assert step.dtype == np.int32 and step.tolist() == [42]


def test_import_rejects_missing_and_mismatched_variables(port_bundle, tmp_path):
    state_dict, prefix = port_bundle
    # every variable but one (the check reads names before shapes)
    tensors = {name: np.zeros(1, np.float32) for name in ref_import.reference_variable_map()}
    del tensors["cell/state0/weights"]
    tf_bundle.write_bundle(str(tmp_path / "model-7"), tensors)
    with pytest.raises(ValueError, match="missing 1 expected variables"):
        ref_import.import_reference_checkpoint(str(tmp_path / "model-7"), state_dict)
    # a model of another size: the first kernel whose shape differs is named
    with pytest.raises(ValueError, match="does not map to"):
        ref_import.import_reference_checkpoint(prefix, RFNet(n_seed=4, up_ratio=16))


def test_bundle_bytes_and_weights_cross_packages(port_bundle, tmp_path):
    """On the same weights the port's bundle is the JAX writer's byte for
    byte, and a bundle written by either package imports in the other to
    the same weights exactly."""
    state_dict, prefix = port_bundle
    params = unflatten(state_dict_to_flax(state_dict))
    jprefix = str(tmp_path / "jax" / "model-42")
    jref.export_reference_checkpoint(jprefix, params, step=42)
    for name in (".index", ".data-00000-of-00001"):
        with open(prefix + name, "rb") as f, open(jprefix + name, "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(os.path.dirname(prefix), "checkpoint")) as f, \
            open(os.path.join(os.path.dirname(jprefix), "checkpoint")) as g:
        assert f.read() == g.read()

    # the port's bundle into the JAX tree, and the JAX package's into the port
    back = jref.import_reference_checkpoint(prefix, params)
    assert_state_dicts_equal(flax_to_state_dict(flatten_params(back)), state_dict)
    assert_state_dicts_equal(ref_import.import_reference_checkpoint(jprefix, RFNet()), state_dict)


# --------------------------------------------------------------------------
# The inverse converter and its .npz
# --------------------------------------------------------------------------


def test_state_dict_to_flax_inverts_flax_to_state_dict(tmp_path, rng):
    """state_dict_to_flax ∘ flax_to_state_dict is the identity on the
    converged npz, and the .npz that save_npz writes of the port's weights
    gives the JAX forward of those weights (tiny config, the model tests'
    tolerance: rtol 1e-4, atol 1e-5)."""
    with np.load(os.path.join(REPO, "weights", "rfnet_r4_105000.npz")) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    back = state_dict_to_flax(flax_to_state_dict(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)

    model = RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(11))
    path = str(tmp_path / "tiny.npz")
    save_npz(path, model.state_dict(), step=123)
    with np.load(path) as z:
        assert int(z["__step__"]) == 123 and z["__step__"].dtype == np.int64
        params = unflatten({k: z[k] for k in z.files if not k.startswith("__")})
    assert_state_dicts_equal(flax_to_state_dict(flatten_params(params)), model.state_dict())
    pc = rng.rand(2, 256, 3).astype(np.float32)
    want = jax.jit(JRFNet(n_seed=4, up_ratio=4).apply)({"params": params}, jnp.asarray(pc)).out4
    with torch.no_grad():
        got = model(torch.from_numpy(pc)).out4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # the eval CLI serves the file
    served = checkpoints.load_state(path)
    assert_state_dicts_equal(served.state_dict(), model.state_dict())


# --------------------------------------------------------------------------
# The CLI, both ways, and TensorFlow's reader
# --------------------------------------------------------------------------


def test_cli_both_ways(tmp_path, capsys):
    """A JAX-written reference bundle -> the port's CLI -> ckpt_<step>.pt in
    the trainer's format (the step parsed from the prefix), which the eval
    CLI serves from the workdir and the trainer resumes from; --export of
    that workdir -> a bundle the JAX package imports to the same weights."""
    state_dict = random_state_dict(9)
    params = unflatten(state_dict_to_flax(state_dict))
    jprefix = str(tmp_path / "ref" / "model-229999")
    jref.export_reference_checkpoint(jprefix, params, step=229999)
    workdir = str(tmp_path / "work")
    ref_import.main(["--ref_prefix", jprefix, "--workdir", workdir])
    assert "step 229999" in capsys.readouterr().out
    assert [s for s, _ in checkpoints.list_checkpoints(workdir)] == [229999]

    served = checkpoints.load_state(workdir)  # a workdir of ckpt_<step>.pt
    assert_state_dicts_equal(served.state_dict(), state_dict)
    state = train.create_state(train.TrainConfig(), device="cpu")
    assert checkpoints.restore_if_available(state, workdir) and state.step == 229999
    assert_state_dicts_equal(state.model.state_dict(), state_dict)

    out_prefix = str(tmp_path / "out" / "model-0")
    ref_import.main(["--export", "--workdir", workdir, "--ref_prefix", out_prefix])
    assert "(step 229999)" in capsys.readouterr().out
    back = jref.import_reference_checkpoint(out_prefix, params)
    assert_state_dicts_equal(flax_to_state_dict(flatten_params(back)), state_dict)
    with pytest.raises(SystemExit, match="no checkpoint at step 5"):
        ref_import.main(["--export", "--workdir", workdir, "--ref_prefix", out_prefix,
                         "--step", "5"])


_TF_READ = """
import sys
import numpy as np
import tensorflow as tf
reader = tf.train.load_checkpoint(sys.argv[1])
names = sorted(reader.get_variable_to_shape_map())
np.savez(sys.argv[2], **{n.replace("/", "|"): reader.get_tensor(n) for n in names})
"""


def test_tensorflow_reads_the_port_bundle(port_bundle, tmp_path):
    """``tf.train.load_checkpoint`` reads the port's bundle to equal arrays
    (in a subprocess: TensorFlow takes seconds to import and shares no
    process with JAX and torch)."""
    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("tensorflow is not installed")
    state_dict, prefix = port_bundle
    out = str(tmp_path / "tf.npz")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TF_CPP_MIN_LOG_LEVEL": "3"}
    subprocess.run([sys.executable, "-c", _TF_READ, prefix, out], check=True, timeout=240,
                   env=env, capture_output=True)
    want = tf_bundle.read_bundle(prefix)
    with np.load(out) as z:
        got = {k.replace("|", "/"): z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert got["Variable"].tolist() == [42]
    assert len(got) == len(ref_import.reference_variable_map()) + 1

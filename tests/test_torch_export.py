"""The port's serving export (``rfnet_tpu_torch/export.py``) on the CPU:
export -> save -> load -> run equals the live forward, as
``tests/test_export.py`` holds the JAX package's; the CPU artifact loads
with torch alone; the custom operators of K1 and K2 trace and round-trip;
the eval CLI takes every form of ``--checkpoint`` the JAX CLI does."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch import export as texport
from rfnet_tpu_torch import train
from rfnet_tpu_torch.compat.convert import state_dict_to_flax
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.models import rfnet as rfnet_module
from rfnet_tpu_torch.ops import chamfer, fps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INNUM = 64  # the tiny model's input points (the CLI exports the serving 3000)


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


def tiny_model(seed=0):
    return RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(seed)).eval()


def live(model, x):
    with torch.no_grad():
        return model(x).out4


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The tiny model, the JAX model with the same weights (as flax params)
    and the port's CPU artifacts, batch 2 and symbolic, exported once."""
    model = tiny_model(2)
    params = {"params": unflatten(state_dict_to_flax(model.state_dict()))}
    jm = JRFNet(n_seed=4, up_ratio=4)
    root = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for name, bs in (("static", 2), ("symbolic", None)):
        exported = texport.export_forward(model, bs, innum=INNUM)
        paths[name] = str(root / f"{name}.pt2")
        size = texport.save_exported(exported, paths[name])
        assert size > 0 and os.path.getsize(paths[name]) == size
        paths[name + "_shapes"] = texport.io_shapes(exported)
    return model, (jm, params), paths


def test_export_roundtrip_matches_live_model(artifacts, rng):
    model, _, paths = artifacts
    assert paths["static_shapes"] == ((2, INNUM, 3), (2, 128, 3))
    x = torch.from_numpy(rng.rand(2, INNUM, 3).astype(np.float32))
    # the same program on the same device: the artifact reproduces the live
    # forward exactly
    served = texport.load_forward(paths["static"])
    torch.testing.assert_close(served(x), live(model, x), rtol=0, atol=0)


def test_export_symbolic_batch(artifacts, rng):
    """batch_size None -> one artifact serves any batch size, bit-exact (the
    plain scans' chunk does not depend on the batch while exporting)."""
    model, _, paths = artifacts
    shape_in, shape_out = paths["symbolic_shapes"]
    assert not isinstance(shape_in[0], int) and shape_out[1:] == (128, 3)
    served = texport.load_forward(paths["symbolic"])
    for bs in (1, 3):
        x = torch.from_numpy(rng.rand(bs, INNUM, 3).astype(np.float32))
        torch.testing.assert_close(served(x), live(model, x), rtol=0, atol=0)


def test_export_cli(tmp_path, monkeypatch, capsys):
    """The CLI surface, flags -> artifact on disk, from a bestrecord/ of the
    tiny model; a list of platforms and a wrong point count are refused."""
    model = tiny_model(3)
    os.makedirs(tmp_path / "bestrecord")
    torch.save(model.state_dict(), tmp_path / "bestrecord" / "model.pt")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "model.pt2")
    texport.main(["--out", out, "--batch_size", "2", "--num_gt_points", "128",
                  "--platforms", "cpu"])  # --checkpoint defaults to ./bestrecord
    text = capsys.readouterr().out
    assert f"trainable parameters: {teval.count_params(model)}" in text
    assert "in (2, 3000, 3) -> out (2, 128, 3), platform cpu" in text
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3000, 3).astype(np.float32))
    y = texport.load_forward(out)(x)
    assert y.shape == (2, 128, 3) and bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, live(model, x), rtol=0, atol=0)
    with pytest.raises(SystemExit, match="traced for one device"):
        texport.main(["--out", out, "--platforms", "cuda,cpu"])
    with pytest.raises(SystemExit, match="completes 128 points"):
        texport.main(["--out", out, "--platforms", "cpu"])


_TORCH_ONLY = """
import sys
import numpy as np
import torch
program = torch.export.load(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    y = program.module()(x)
np.save(sys.argv[3], y.numpy())
print(sorted(m for m in sys.modules if m.startswith("rfnet")))
"""


def test_cpu_artifact_loads_with_torch_alone(artifacts, tmp_path, rng):
    """A fresh interpreter that imports only torch loads the symbolic-batch
    CPU artifact and runs it to the live forward's values; no module of
    this repository is imported there."""
    model, _, paths = artifacts
    x = rng.rand(3, INNUM, 3).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _TORCH_ONLY, paths["symbolic"],
                          str(tmp_path / "x.npy"), str(tmp_path / "y.npy")], cwd=str(tmp_path),
                         env=env, timeout=240, capture_output=True, text=True, check=True)
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), live(model, torch.from_numpy(x)))


def test_cpu_artifact_equals_jax_forward(artifacts, rng):
    """The CPU artifact against the JAX forward of the same weights (the model tests' tolerance: rtol 1e-4, atol 1e-5)."""
    _, (jm, params), paths = artifacts
    x = rng.rand(2, INNUM, 3).astype(np.float32)
    got = texport.load_forward(paths["static"])(torch.from_numpy(x))
    want = jax.jit(jm.apply)(params, jnp.asarray(x)).out4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_fake_implementations_give_the_plain_shapes_and_dtypes():
    """The operators' fake implementations (what an export traces) give the
    shapes and dtypes of the plain versions' outputs, also for a symbolic
    batch."""
    x, t = torch.rand(3, 50, 3), torch.rand(3, 70, 3)
    plain = [fps._fps_plain(x, 7), *chamfer.nn_coords(x, t)]
    with FakeTensorMode() as mode:
        fx, ft = mode.from_tensor(x), mode.from_tensor(t)
        fake = [fps._fps_fake(fx, 7), *chamfer._nn_coords_fake(fx, ft)]
    assert [(f.shape, f.dtype, f.device) for f in fake] == \
        [(p.shape, p.dtype, p.device) for p in plain]
    assert [f.dtype for f in fake] == [torch.int32, torch.float32, torch.int32, torch.float32]


@pytest.fixture
def ops_on_cpu(monkeypatch):
    """The model's K1 and K2 calls routed through ``rfnet::fps`` and
    ``rfnet::nn_coords`` on CPU tensors, whose CPU bodies are (for this test
    only) the plain versions: the card's graph, traced and run here."""
    lib = torch.library.Library("rfnet", "IMPL")

    def nn_coords_plain(q, t):
        d, i = chamfer._one_sided(q.contiguous(), t.contiguous())
        return d, i, chamfer._gather_rows(t, i)

    lib.impl("fps", lambda x, n: fps._fps_plain(x.contiguous(), n), "CPU")
    lib.impl("nn_coords", nn_coords_plain, "CPU")
    monkeypatch.setattr(rfnet_module, "farthest_point_sample",
                        lambda npoint, xyz: torch.ops.rfnet.fps(xyz.detach(), npoint))
    monkeypatch.setattr(rfnet_module, "nearest_neighbor_coords",
                        lambda q, t: torch.ops.rfnet.nn_coords(q.detach(), t.detach())[::2])
    try:
        yield
    finally:
        lib._destroy()


@pytest.mark.usefixtures("ops_on_cpu")
def test_operators_trace_save_load_and_run(tmp_path, rng):
    """Through the operators a symbolic-batch export holds K1 once and K2
    three times, saves, loads and runs at batch 1 and 3 to the live forward
    bit for bit; ``torch.library.opcheck`` passes on both."""
    model = tiny_model(5)
    exported = texport.export_forward(model, None, innum=INNUM)
    ops = [str(n.target) for n in exported.graph.nodes if str(n.target).startswith("rfnet.")]
    assert ops == ["rfnet.fps.default"] + ["rfnet.nn_coords.default"] * 3
    path = str(tmp_path / "ops.pt2")
    texport.save_exported(exported, path)
    served = texport.load_forward(path)
    for bs in (1, 3):
        x = torch.from_numpy(rng.rand(bs, INNUM, 3).astype(np.float32))
        torch.testing.assert_close(served(x), live(model, x), rtol=0, atol=0)
    x, t = torch.rand(2, 50, 3), torch.rand(2, 70, 3)
    for op, args in ((torch.ops.rfnet.fps.default, (x, 8)),
                     (torch.ops.rfnet.nn_coords.default, (x, t))):
        assert set(torch.library.opcheck(op, args).values()) == {"SUCCESS"}


def _serve(tmp_path, checkpoint, tag):
    out = str(tmp_path / f"results_{tag}")
    np.random.seed(0)  # resample_pcd pads from the global numpy RNG
    teval.main(["--list_path", str(tmp_path / "test.list"), "--data_dir",
                str(tmp_path / "data"), "--num_gt_points", "128", "--plot_freq", "100",
                "--batch_size", "2", "--results_dir", out, "--device", "cpu",
                *([] if checkpoint is None else ["--checkpoint", checkpoint])])
    with open(os.path.join(out, "results.csv")) as f:
        return f.read()


def test_eval_cli_serves_checkpoint_directories(tmp_path, rng, monkeypatch, capsys):
    """The eval CLI given bestrecord/ (and by default ./bestrecord), a
    workdir of ckpt_<step>.pt, one ckpt_<step>.pt, and bestrecord/model.pt
    serves the saved weights: the same CSV each time, never the random
    init's."""
    from rfnet_tpu_torch.data import pcd_io

    ids = ["0001/a", "0001/b", "0002/c"]
    for mid in ids:
        for kind, n in (("partial", 40), ("complete", 128)):
            path = tmp_path / "data" / kind / (mid + ".pcd")
            os.makedirs(path.parent, exist_ok=True)
            pcd_io.save_pcd(str(path), rng.rand(n, 3).astype(np.float32))
    (tmp_path / "test.list").write_text("\n".join(ids))

    config = train.TrainConfig(n_seed=4, up_ratio=4, seed=7)
    state = train.create_state(config, device="cpu")
    best = tmp_path / "bestrecord"
    os.makedirs(best)
    torch.save(state.model.state_dict(), best / "model.pt")
    work = str(tmp_path / "work")
    state.step = 3
    train.save_checkpoint(state, work, 2)
    with torch.no_grad():  # an older checkpoint of other weights, not served
        for p in state.model.parameters():
            p.add_(1.0)
    state.step = 1
    train.save_checkpoint(state, work, 2)

    csvs = {"model.pt": _serve(tmp_path, str(best / "model.pt"), "file"),
            "bestrecord/": _serve(tmp_path, str(best), "dir"),
            "workdir": _serve(tmp_path, work, "work"),
            "ckpt_3.pt": _serve(tmp_path, os.path.join(work, "ckpt_3.pt"), "ckpt")}
    monkeypatch.chdir(tmp_path)
    csvs["default"] = _serve(tmp_path, None, "default")
    text = capsys.readouterr().out
    assert "WARNING" not in text and text.count("step 3") == 2
    assert len(set(csvs.values())) == 1, csvs
    assert csvs["model.pt"].count("\n") == len(ids) + 1
    os.remove(best / "model.pt")  # an empty directory: the random init, with a warning
    assert teval.load_state(str(best)).n_seed == 32
    assert "no checkpoint under" in capsys.readouterr().out

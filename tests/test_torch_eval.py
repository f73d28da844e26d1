"""The port's serving CLI and host data path against the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch
from jax_codec import private_jax_codec  # noqa: F401 (a fixture)

from rfnet_tpu import eval as jeval
from rfnet_tpu.data import dataset as jdataset
from rfnet_tpu.data import pcd_io as jpcd
from rfnet_tpu.train import TrainConfig, create_state
from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.data import dataset, pcd_io


def _fixtures(root, rng, ids, n_partial=40, n_gt=128):
    for mid in ids:
        for kind, n in (("partial", n_partial), ("complete", n_gt)):
            p = os.path.join(root, "data", kind, mid + ".pcd")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            jpcd.save_pcd(p, rng.rand(n, 3).astype(np.float32))
    list_path = os.path.join(root, "test.list")
    with open(list_path, "w") as f:
        f.write("\n".join(ids))
    return list_path


def _tree(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


@pytest.mark.usefixtures("private_jax_codec")
def test_eval_cli_csv_matches_jax(tmp_path, rng, monkeypatch):
    """Both CLIs on the same fixtures with the same weights: the JAX CLI's
    random init of the small model (PRNGKey(1)) and its conversion saved as
    the port's checkpoint. The CSVs agree to rtol 1e-4 (the metrics are the
    same means; the JAX CPU path rounds its |t|²−2q·t expansion, the port
    sums squares), and plots appear at the same cadence, file for file."""
    ids = ["0001/a", "0001/b", "0002/c", "0002/d", "0003/e"]
    list_path = _fixtures(str(tmp_path), rng, ids)
    tiny = lambda **kw: TrainConfig(n_seed=4, up_ratio=4, innum=3000, **kw)  # noqa: E731
    params = create_state(tiny(ptnum=128)).params["params"]
    ckpt = os.path.join(tmp_path, "model.pt")
    torch.save(flax_to_state_dict(flatten_params(params)), ckpt)
    monkeypatch.setattr(jeval, "TrainConfig", tiny)
    common = ["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
              "--num_gt_points", "128", "--plot_freq", "2", "--batch_size", "2"]
    dirs = {}
    for tag, main, extra in (
        ("jax", jeval.main, ["--checkpoint", os.path.join(tmp_path, "nockpt")]),
        ("torch", teval.main, ["--checkpoint", ckpt, "--device", "cpu"]),
    ):
        dirs[tag] = os.path.join(tmp_path, "results_" + tag)
        np.random.seed(0)  # resample_pcd pads from the global numpy RNG
        main([*common, "--results_dir", dirs[tag], *extra])
    rows = {t: open(os.path.join(d, "results.csv")).read().splitlines() for t, d in dirs.items()}
    assert rows["torch"][0] == "id,cd,emd" and len(rows["torch"]) == len(ids) + 1
    for rj, rt in zip(rows["jax"][1:], rows["torch"][1:]):
        idj, cdj, emdj = rj.split(",")
        idt, cdt, emdt = rt.split(",")
        assert idj == idt
        np.testing.assert_allclose(float(cdt), float(cdj), rtol=1e-4)
        np.testing.assert_allclose(float(emdt), float(emdj), rtol=1e-4)
    plots = {t: _tree(os.path.join(d, "plots")) for t, d in dirs.items()}
    assert plots["torch"] == plots["jax"]
    assert len(plots["torch"]) == 3 * 9  # models 0, 2, 4: 3 clouds × 3 views


def test_eval_cli_save_pcd_and_means(tmp_path, rng, capsys):
    """--save_pcd dumps each completion; the per-category means and the
    parameter count are printed; a missing checkpoint warns and uses the
    full-size random init."""
    ids = ["0001/a", "0002/b"]
    list_path = _fixtures(str(tmp_path), rng, ids, n_gt=16384)
    out = os.path.join(tmp_path, "results")
    teval.main(["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
                "--checkpoint", os.path.join(tmp_path, "nockpt.pt"), "--results_dir", out,
                "--plot_freq", "1000", "--save_pcd", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "WARNING: no checkpoint" in text
    assert "trainable parameters: 3827611" in text
    assert "Chamfer distance per category\n0001 " in text
    for mid in ids:
        pts = pcd_io.read_pcd(os.path.join(out, "pcds", mid + ".pcd"))
        assert pts.shape == (16384, 3) and np.isfinite(pts).all()


def test_eval_cuda_request_without_card_fails(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    list_path = _fixtures(str(tmp_path), rng, ["0001/a"])
    with pytest.raises(SystemExit):
        teval.main(["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
                    "--checkpoint", "absent.pt", "--results_dir", os.path.join(tmp_path, "r")])


def test_eval_loader_failure_raises(tmp_path, rng):
    """A corrupt .pcd surfaces as an exception, not a hang."""
    list_path = _fixtures(str(tmp_path), rng, ["0001/a", "0001/b"])
    with open(os.path.join(tmp_path, "data", "partial", "0001", "b.pcd"), "wb") as f:
        f.write(b"not a pcd file")
    with pytest.raises(ValueError):
        teval.main(["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
                    "--checkpoint", "absent.pt", "--results_dir", os.path.join(tmp_path, "r"),
                    "--num_gt_points", "128", "--device", "cpu"])


@pytest.mark.usefixtures("private_jax_codec")
@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_pcd_codec_matches_jax(tmp_path, rng, fmt):
    pts = (rng.randn(123, 3) * 10).astype(np.float32)
    path = os.path.join(tmp_path, "x.pcd")
    if fmt == "ascii":
        pcd_io.save_pcd(path, pts)
    else:
        header = ("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                  f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\nDATA binary\n")
        with open(path, "wb") as f:
            f.write(header.encode() + pts.tobytes())
    # read_pcd takes the native codec first in both packages, as the numpy
    # parsers do where it is unavailable
    ours = pcd_io.read_pcd(path)
    np.testing.assert_array_equal(ours, jpcd.read_pcd(path))
    np.testing.assert_array_equal(pcd_io._read_pcd_py(path), jpcd._read_pcd_py(path))
    np.testing.assert_array_equal(ours.astype(np.float32), pts)  # exact round trip


def test_resample_and_synthetic_pairs_match_jax():
    a = dict((i, (p, g)) for i, p, g in dataset.synthetic_pairs(3, 500, 700, seed=5))
    b = dict((i, (p, g)) for i, p, g in jdataset.synthetic_pairs(3, 500, 700, seed=5))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0])
        np.testing.assert_array_equal(a[k][1], b[k][1])
    pcd = np.arange(30.0).reshape(10, 3)
    np.testing.assert_array_equal(
        dataset.resample_pcd(pcd, 25, np.random.RandomState(1)),
        jdataset.resample_pcd(pcd, 25, np.random.RandomState(1)),
    )
    np.testing.assert_array_equal(dataset.resample_pcd(pcd, 4), pcd[:4])


def _serve_both(tmp_path, rng, monkeypatch, extra):
    """The JAX CLI and the port's on the same 5 fixtures with the same
    weights (as :func:`test_eval_cli_csv_matches_jax`), each run once per
    argument list of ``extra`` {tag: (jax args, port args)}; returns {tag:
    CSV lines}."""
    ids = ["0001/a", "0001/b", "0002/c", "0002/d", "0001/e"]
    list_path = _fixtures(str(tmp_path), rng, ids)
    tiny = lambda **kw: TrainConfig(n_seed=4, up_ratio=4, innum=3000, **kw)  # noqa: E731
    params = create_state(tiny(ptnum=128)).params["params"]
    ckpt = os.path.join(tmp_path, "model.pt")
    torch.save(flax_to_state_dict(flatten_params(params)), ckpt)
    monkeypatch.setattr(jeval, "TrainConfig", tiny)
    common = ["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
              "--num_gt_points", "128", "--plot_freq", "1000", "--batch_size", "2"]
    rows = {}
    for tag, (jax_args, port_args) in extra.items():
        for pkg, main, args in (("jax", jeval.main, jax_args), ("torch", teval.main, port_args)):
            if args is None:
                continue
            ckpt_args = (["--checkpoint", os.path.join(tmp_path, "nockpt")] if pkg == "jax"
                         else ["--checkpoint", ckpt, "--device", "cpu"])
            out = os.path.join(tmp_path, f"results_{pkg}_{tag}")
            np.random.seed(0)  # resample_pcd pads from the global numpy RNG
            main([*common, "--results_dir", out, *ckpt_args, *args])
            with open(os.path.join(out, "results.csv")) as f:
                rows[pkg, tag] = f.read().splitlines()
    return rows


def _assert_rows_close(got, want, rtol):
    assert len(got) == len(want) == 6 and got[0] == want[0] == "id,cd,emd"
    for rg, rw in zip(got[1:], want[1:]):
        ig, *vg = rg.split(",")
        iw, *vw = rw.split(",")
        assert ig == iw
        np.testing.assert_allclose([float(v) for v in vg], [float(v) for v in vw], rtol=rtol)


@pytest.mark.usefixtures("private_jax_codec")
def test_eval_cli_pipelined_matches_sync_and_jax(tmp_path, rng, monkeypatch):
    """Mirrors ``tests/test_data_eval.py::test_eval_cli_pipelined_matches_sync``:
    ``--pipeline`` writes the synchronous path's CSV row for row, character
    for character, and both match the JAX CLI's pipelined CSV to rtol 1e-5."""
    rows = _serve_both(tmp_path, rng, monkeypatch, {
        "sync": (None, []), "pipe": (["--pipeline"], ["--pipeline"])})
    assert rows["torch", "pipe"] == rows["torch", "sync"]
    _assert_rows_close(rows["torch", "pipe"], rows["jax", "pipe"], 1e-5)


def test_eval_profile_dir_writes_a_parseable_trace(tmp_path, rng):
    list_path = _fixtures(str(tmp_path), rng, ["0001/a"])
    ckpt = os.path.join(tmp_path, "model.pt")
    torch.save(teval.RFNet(n_seed=4, up_ratio=4).state_dict(), ckpt)
    prof = os.path.join(tmp_path, "prof")
    teval.main(["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
                "--checkpoint", ckpt, "--results_dir", os.path.join(tmp_path, "r"),
                "--num_gt_points", "128", "--device", "cpu", "--profile_dir", prof])
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_eval_profile_dir_writes_counters_beside_the_trace(tmp_path, rng):
    """``counters.json`` beside ``trace.json``: the counters of the run (on
    the CPU the dense layers' two alone: the plain scans count nothing) and
    the kernel launches; the trace holds the serving loop's and the model's
    spans."""
    from rfnet_tpu_torch import kernels

    list_path = _fixtures(str(tmp_path), rng, ["0001/a", "0001/b"])
    ckpt = os.path.join(tmp_path, "model.pt")
    torch.save(teval.RFNet(n_seed=4, up_ratio=4).state_dict(), ckpt)
    prof = os.path.join(tmp_path, "prof")
    teval.main(["--list_path", list_path, "--data_dir", os.path.join(tmp_path, "data"),
                "--checkpoint", ckpt, "--results_dir", os.path.join(tmp_path, "r"),
                "--num_gt_points", "128", "--device", "cpu", "--profile_dir", prof])
    assert sorted(os.listdir(prof)) == ["counters.json", "trace.json"]
    with open(os.path.join(prof, "counters.json")) as f:
        counts = json.load(f)
    assert counts["launches"] == dict(kernels.launches)
    dense = counts.pop("counters")
    assert sorted(dense) == ["dense.macs_per_cloud_saved", "dense.macs_per_point"]
    assert min(dense.values()) > 0 and counts == {"launches": dict(kernels.launches)}
    with open(os.path.join(prof, "trace.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("eval.copy_in") == 2 and names.count("rfnet.forward") == 2
    assert names.count("eval.metrics") == 2 and names.count("rfnet.merge") == 6

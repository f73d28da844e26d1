"""The port's serving CLI and host data path against the JAX package's."""

import os

import numpy as np
import pytest
import torch

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
    ours = pcd_io.read_pcd(path)
    np.testing.assert_array_equal(ours, jpcd._read_pcd_py(path))
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

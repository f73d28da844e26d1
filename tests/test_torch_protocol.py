"""The port's run-level tools (``tools/make_synthetic_evalset_torch.py``,
``tools/eval_curve_torch.py``, ``tools/protocol_drive_torch.py``) against
the JAX package's tools, and the package-free tools (``curve_report.py``,
``compare_results.py``) over the port's outputs, on the CPU at a tiny size."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu.train import TrainState as JTrainState
from rfnet_tpu.train import eval_step as j_eval_step
from rfnet_tpu_torch import kernels, train
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.data.dataset import synthetic_dataflow
from rfnet_tpu_torch.models import RFNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
NO_TENSORFLOW = os.path.join(REPO, "tests", "no_tensorflow")
TINY = ["--innum", "64", "--ptnum", "128", "--n_seed", "4", "--up_ratio", "4",
        "--batch_size", "4"]
VAL = 8  # held-out clouds of the tiny run
EVAL_LINE = re.compile(r"eval @ (\d+): mean cd ([\d.]+) mean emd ([\d.]+)")
# runs a tool's __main__ where neither JAX nor the JAX package can be imported
BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['rfnet_tpu'] = None; "
           "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_blocked(tool, *argv, env=None):
    """``tools/<tool>.py argv`` in a fresh interpreter without JAX; it and the
    processes it starts see no TensorFlow (``tests/no_tensorflow``)."""
    path = os.pathsep.join([NO_TENSORFLOW, *filter(None, [os.environ.get("PYTHONPATH")])])
    return subprocess.run([sys.executable, "-c", BLOCKED, os.path.join(TOOLS, tool + ".py"),
                           *map(str, argv)], capture_output=True, text=True, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": path, **(env or {})}, timeout=300)


def _evals(text):
    return {int(m.group(1)): m.group(2) for m in EVAL_LINE.finditer(text)}


@pytest.fixture(scope="module")
def drive_run(tmp_path_factory):
    """``protocol_drive_torch --synthetic --device cpu`` at the tiny size with
    a held-out set of 8 (4 steps, checkpoints and evals at 2 and 4), without
    JAX, its stages' launch counts logged."""
    root = tmp_path_factory.mktemp("drive")
    log = os.path.join(root, "launches.jsonl")
    proc = run_blocked("protocol_drive_torch", "--synthetic", "--device", "cpu", "--steps", 4,
                       "--ckpt_every", 2, "--workdir", root / "run" / "modelvv_recon",
                       "--results_dir", root / "results", "--train_extra", *TINY,
                       "--synthetic_size", 8, "--synthetic_val_size", VAL,
                       env={kernels.LAUNCH_LOG_ENV: log})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(os.path.join(root, "train.log"), "w") as f:
        f.write(proc.stdout)
    return {"root": root, "out": proc.stdout, "log": log,
            "workdir": os.path.join(root, "run", "modelvv_recon"),
            "csv": os.path.join(root, "results", "results.csv")}


@pytest.mark.parametrize("pcn_layout", [False, True])
def test_evalset_writer_is_byte_identical_to_jax(tmp_path, pcn_layout):
    """The port's writer, run without JAX, writes the JAX tool's bytes:
    every .pcd file and test.list."""
    argv = ["--num", "5", "--seed", "1234", "--input_size", "300", "--gt_size", "1024"]
    argv += ["--pcn_layout"] if pcn_layout else []
    _tool("make_synthetic_evalset").main(["--out", str(tmp_path / "jax"), *argv])
    proc = run_blocked("make_synthetic_evalset_torch", "--out", tmp_path / "port", *argv)
    assert proc.returncode == 0, proc.stderr

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                for d, _, fs in os.walk(root) for f in fs}

    jax_files, port_files = tree(tmp_path / "jax"), tree(tmp_path / "port")
    assert len(jax_files) == 2 * 5 + 1
    assert port_files == jax_files
    ids = jax_files["test.list"].decode().split()
    assert all(i.split("/")[0] in _tool("make_synthetic_evalset_torch").PCN_SYNSETS
               for i in ids) == pcn_layout


@pytest.mark.parametrize("innum,ptnum", [(64, 128), (300, 2048)])
def test_eval_curve_sets_equal_jax_and_the_trainers_held_out_batches(innum, ptnum):
    """``eval_curve_torch.build_set`` gives ``tools/eval_curve.py``'s arrays
    bit for bit, in-sample (seed 0) and held out (seed 1234), on the padding
    path (64 of 128) and the truncation path (300 of 2048); the held-out set
    is also the port trainer's held-out dataflow's batches, in order."""
    jtool, ttool = _tool("eval_curve"), _tool("eval_curve_torch")
    for seed in (ttool.IN_SAMPLE_SEED, ttool.HELD_OUT_SEED):
        parts, gts = ttool.build_set(VAL, seed, innum, ptnum)
        jparts, jgts = jtool.build_set(VAL, seed, innum, ptnum)
        assert parts.dtype == gts.dtype == np.float32
        assert np.array_equal(parts, np.asarray(jparts)) and np.array_equal(gts, np.asarray(jgts))
    df, _ = synthetic_dataflow(VAL, ttool.BATCH, innum, ptnum, is_training=False,
                               seed=ttool.HELD_OUT_SEED)
    batches = iter(df)
    for i in range(0, VAL, ttool.BATCH):
        _, partial, _, gt = next(batches)
        assert np.array_equal(partial, parts[i:i + ttool.BATCH])
        assert np.array_equal(gt, gts[i:i + ttool.BATCH])
    batches.close()


def test_held_out_sweep_equals_jax_eval_step():
    """One held-out sweep of the JAX model's weights carried across by
    ``compat.convert``: the port's mean of ``eval_step`` CDs equals the mean
    of the JAX package's ``eval_step`` on the same arrays to 1e-5
    relative."""
    ttool = _tool("eval_curve_torch")
    jmodel = JRFNet(n_seed=4, up_ratio=4)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 3), jnp.float32))
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.identity())
    parts, gts = ttool.build_set(VAL, ttool.HELD_OUT_SEED, 64, 128)
    jeval = jax.jit(j_eval_step)
    want = float(np.mean([float(jeval(jstate, parts[i:i + 4], gts[i:i + 4])[0])
                          for i in range(0, VAL, 4)]))
    model = RFNet(n_seed=4, up_ratio=4)
    model.load_state_dict(flax_to_state_dict(flatten_params(params["params"])), strict=True)
    got = ttool.sweep(train.TrainState(model, optimizer=None), torch.from_numpy(parts),
                      torch.from_numpy(gts))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_protocol_drive_trains_serves_the_best_record_and_compares(drive_run, tmp_path):
    """The drive, without JAX: train → ``bestrecord/`` (the best eval of the
    log) → the eval CLI's ``results.csv`` over the 3-model fixture; then
    ``--skip_train`` with its own CSV as the baseline exits 0 (the same CSV
    again), and ``compare_results`` against a baseline 5 % off exits
    non-zero (the JAX drive's test's form). Each stage process logged its
    launch counts (the plain versions on the CPU: 0)."""
    root = drive_run["root"]
    evals = _evals(drive_run["out"])
    assert sorted(evals) == [2, 4]
    with open(os.path.join(root, "run", "bestrecord", "best.json")) as f:
        best = json.load(f)
    assert f"{best['cd']:.6f}" == min(evals.values(), key=float) == evals[best["step"]]
    assert os.path.isfile(os.path.join(root, "run", "bestrecord", "model.pt"))
    assert "training logs in " + os.path.join(root, "run", "logs") in drive_run["out"]
    with open(drive_run["csv"]) as f:
        rows = f.read().splitlines()
    assert rows[0] == "id,cd,emd" and [r.split(",")[0] for r in rows[1:]] == ["0001/a", "0001/b",
                                                                            "0002/c"]
    assert all(np.isfinite(float(v)) and float(v) > 0 for r in rows[1:] for v in r.split(",")[1:])
    with open(drive_run["log"]) as f:
        staged = [json.loads(line) for line in f]
    assert [os.path.basename(s["argv"][0]) for s in staged] == ["train.py", "eval.py"]
    assert all(set(s["launches"]) == set(kernels.launches) and not any(s["launches"].values())
               for s in staged)

    same = run_blocked("protocol_drive_torch", "--synthetic", "--skip_train", "--device", "cpu",
                       "--workdir", drive_run["workdir"], "--results_dir", tmp_path / "same",
                       "--baseline_csv", drive_run["csv"])
    assert same.returncode == 0 and "PARITY" in same.stdout, same.stdout + same.stderr
    with open(tmp_path / "same" / "results.csv") as f:
        assert f.read().splitlines() == rows
    off = tmp_path / "baseline_off.csv"
    with open(off, "w") as f:
        f.write(rows[0] + "\n")
        for row in rows[1:]:
            mid, cd, emd = row.split(",")
            f.write(f"{mid},{float(cd) * 1.05},{emd}\n")
    assert _tool("compare_results").main([drive_run["csv"], str(off)]) != 0


def test_protocol_drive_stops_at_a_failed_train_stage(tmp_path):
    """A train stage that fails (here an inconsistent ``--ptnum``) ends the
    drive with a non-zero exit naming it; no eval runs."""
    drive = _tool("protocol_drive_torch")
    with pytest.raises(SystemExit) as exc:
        drive.main(["--synthetic", "--device", "cpu", "--steps", "2", "--workdir",
                    str(tmp_path / "run" / "modelvv_recon"), "--results_dir",
                    str(tmp_path / "results"), "--train_extra", "--ptnum", "100"])
    assert exc.value.code == "[protocol_drive_torch] train failed with exit 2"
    assert not os.path.exists(tmp_path / "results")
    with pytest.raises(SystemExit) as exc:
        drive.main(["--skip_train", "--device", "cpu", "--workdir",
                    str(tmp_path / "none" / "modelvv_recon")])
    assert "no best checkpoint" in exc.value.code


def test_tools_refuse_a_missing_card(tmp_path, drive_run):
    """Without ``--device cpu`` the tools run on the card, and where there is
    none they stop: the drive's train stage and eval_curve exit non-zero
    with the eval CLI's message; nothing falls back to the CPU."""
    hide = {"CUDA_VISIBLE_DEVICES": ""}
    proc = run_blocked("protocol_drive_torch", "--synthetic", "--steps", 2, "--workdir",
                       tmp_path / "run" / "modelvv_recon", "--train_extra", *TINY, env=hide)
    assert proc.returncode != 0 and "train failed" in proc.stderr
    assert "no CUDA device is available" in proc.stderr
    assert not os.path.exists(tmp_path / "run" / "modelvv_recon")
    proc = run_blocked("eval_curve_torch", drive_run["workdir"], VAL, "--innum", 64,
                       "--ptnum", 128, env=hide)
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr


def test_eval_curve_held_out_column_is_the_training_log(drive_run, tmp_path):
    """``eval_curve_torch`` without JAX over the tiny run's workdir: one row
    a checkpoint, whose held-out CD is the log's ``eval @ N`` line to the 6
    printed digits; ``--json`` holds the same rows. One checkpoint given as
    ``bestrecord/`` or a ``ckpt_<step>.pt`` gives that step's row."""
    evals = _evals(drive_run["out"])
    out = tmp_path / "curve.json"
    proc = run_blocked("eval_curve_torch", drive_run["workdir"], VAL, "--device", "cpu",
                       "--innum", 64, "--ptnum", 128, "--json", out)
    assert proc.returncode == 0, proc.stderr
    with open(out) as f:
        rows = json.load(f)
    assert [r["step"] for r in rows] == [2, 4]
    assert {r["step"]: f"{r['heldout_cd']:.6f}" for r in rows} == evals
    table = [line.split() for line in proc.stdout.splitlines()[1:]]
    assert table == [[str(r["step"]), f"{r['in_cd']:.6f}", f"{r['heldout_cd']:.6f}"] for r in rows]

    ttool = _tool("eval_curve_torch")
    best = os.path.join(os.path.dirname(drive_run["workdir"]), "bestrecord")
    for path in (best, os.path.join(drive_run["workdir"], "ckpt_2.pt")):
        (row,) = ttool.main([path, str(VAL), "--device", "cpu", "--innum", "64",
                             "--ptnum", "128"])
        assert row == next(r for r in rows if r["step"] == row["step"])


def test_curve_report_reads_the_port_logs(drive_run, tmp_path, monkeypatch, capsys):
    """``tools/curve_report.py --json`` over the port's
    ``<workdir>/../logs/metrics.jsonl`` and its log: the drive's run gives
    the held-out rows its log printed; a run logging every step (in process)
    also gives the train-CD rows its ``batch`` lines printed."""
    report = _tool("curve_report")
    root = drive_run["root"]
    out = tmp_path / "curves.json"
    assert report.main([os.path.join(root, "run", "logs", "metrics.jsonl"),
                        os.path.join(root, "train.log"), "--json", str(out)]) == 0
    with open(out) as f:
        curves = json.load(f)
    assert {r["step"]: f"{r['cd']:.6f}" for r in curves["eval"]} == _evals(drive_run["out"])

    monkeypatch.setattr(train, "_tb_writer", lambda logdir: None)
    config = train.TrainConfig(iters=4, batch_size=4, eval_size=4, innum=64, ptnum=128,
                               n_seed=4, up_ratio=4, log_every=1, ckpt_every=2,
                               workdir=str(tmp_path / "run" / "modelvv_recon"))
    df, _ = synthetic_dataflow(8, 4, 64, 128)
    vdf, vn = synthetic_dataflow(VAL, 4, 64, 128, is_training=False, seed=1234)
    capsys.readouterr()
    train.train(config, df, vdf, vn, "cpu")
    log = tmp_path / "train.log"
    log.write_text(capsys.readouterr().out)
    assert report.main([str(tmp_path / "run" / "logs" / "metrics.jsonl"), str(log),
                        "--json", str(out)]) == 0
    with open(out) as f:
        curves = json.load(f)
    printed = [(int(m.group(1)), float(m.group(2))) for m in
               re.finditer(r"batch (\d+)  loss [\d.]+  cd ([\d.]+)", log.read_text())]
    assert [(r["step"], r["cd"]) for r in curves["train_cd"]] == [
        (s, pytest.approx(cd, abs=1e-6)) for s, cd in printed]
    assert [r["step"] for r in curves["train_cd"]] == [0, 1, 2, 3]
    assert {r["step"]: f"{r['cd']:.6f}" for r in curves["eval"]} == _evals(log.read_text())


def test_committed_convergence_run_reads_back(tmp_path):
    """The port's 10 000-step run on the card (``run_torch_conv/``):
    ``curve_report`` over its metrics and log rebuilds its ``curves.json``;
    the eval curve's held-out column is its log's ``eval @ N`` lines and
    its best record the lowest of them; every logged loss is finite; the
    held-out CD lies within 10 % of run_r4's at the same steps."""
    run = os.path.join(REPO, "run_torch_conv")
    out = tmp_path / "curves.json"
    assert _tool("curve_report").main([os.path.join(run, "metrics.jsonl"),
                                       os.path.join(run, "train.log"), "--json", str(out)]) == 0
    with open(out) as f, open(os.path.join(run, "curves.json")) as g:
        assert json.load(f) == json.load(g)
    with open(os.path.join(run, "train.log")) as f:
        evals = _evals(f.read())
    with open(os.path.join(run, "eval_curve.json")) as f:
        curve = json.load(f)
    assert {r["step"]: f"{r['heldout_cd']:.6f}" for r in curve} == evals
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    assert f"{best['cd']:.6f}" == min(evals.values(), key=float) == evals[best["step"]]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    with open(os.path.join(REPO, "run_r4", "curves.json")) as f:
        jax_evals = {r["step"]: r["cd"] for r in json.load(f)["eval"]}
    assert sorted(evals) == [5000, 10000]
    for step, cd in evals.items():
        assert abs(float(cd) / jax_evals[step] - 1) <= 0.10, (step, cd, jax_evals[step])

"""The drivers end to end on the CPU at a tiny size, through the harness's
function-level entry: sound runs come out correct with every metric of
their lines; the control (the reference one precision below, TF32) and
each planted fault come out not correct. ``run.py`` itself refuses
without a card, and a checkout without the program gives no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import controls, harness

SEED = 2**31 + 11  # past 32 signed bits, as the driver's seeds may be


def _run(cell, trace=False, program=None, seconds=0.5):
    import time

    return harness.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(), program)


@pytest.mark.parametrize("name", ["serve_b32", "train_b32"])
def test_sound_run_is_correct_with_its_metrics(tiny_cell, name):
    cell = tiny_cell(name)
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert list(res)[-1] == "checks"
    assert all(c["value"] < c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", ["serve_b32", "train_b32"])
def test_traced_run_reads_the_host_spans(tiny_cell, name):
    res = _run(tiny_cell(name), trace=True, seconds=3.0)
    assert res["correct"]
    host = "host_ms." + ("serve" if name.startswith("serve") else "train")
    assert res["metrics"][host]["value"] > 0  # the CPU has no device metrics
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("name", ["serve_b32", "train_b32"])
def test_same_seed_same_inputs(tiny_cell, name):
    from benchmark.traffic import synthetic

    mix = tiny_cell(name)["traffic"]
    a, b = synthetic.pool(mix, SEED), synthetic.pool(mix, SEED)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (synthetic.pool(mix, SEED + 1)[0] == a[0]).all()


@pytest.mark.parametrize("name,kind", [("serve_b32", "serve"), ("train_b32", "train")])
def test_control_is_not_correct(tiny_cell, name, kind):
    res = _run(tiny_cell(name), program=controls.CONTROLS[kind])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name,kind,fault", [
    ("serve_b32", "serve", "answer_altered"), ("serve_b32", "serve", "score_altered"),
    ("serve_b32", "serve", "half_batch"), ("train_b32", "train", "state_unchanged"),
    ("train_b32", "train", "half_batch")])
def test_planted_fault_is_not_correct(tiny_cell, name, kind, fault):
    res = _run(tiny_cell(name), program=controls.FAULTS[kind][fault])
    assert not res["correct"], res["checks"]


def test_bf16_program_is_not_correct(tiny_cell):
    """The port's own bfloat16 mode in the float32 configuration's place."""
    for name in ("serve_b32", "train_b32"):
        cell = tiny_cell(name)
        cell["config"]["dtype"] = "bfloat16"
        res = _run(cell)
        assert not res["correct"], (name, res["checks"])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          "serve_b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert got.returncode != 0 and got.stdout == ""


def test_checkout_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the program is
    missing, so a run stops before any result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from benchmark import harness; "
            "c = harness.load_cell('serve_b32'); "
            "print(harness.run_cell(c, 1, 0.1, False, 'cpu', time.perf_counter()))")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert got.returncode != 0 and got.stdout == ""
    assert "rfnet_tpu_torch" in got.stderr


@pytest.mark.gpu
def test_run_on_the_card(cuda, tmp_path):
    """A short run of each cell of ``BENCHMARK.json`` on the card: a
    correct result line."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        got = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                              name, "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                             capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
        assert got.returncode == 0, got.stderr[-2000:]
        assert json.loads(got.stdout.strip().splitlines()[-1])["correct"]

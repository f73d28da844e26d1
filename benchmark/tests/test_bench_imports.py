"""What the benchmark may import, and the shape of ``BENCHMARK.json``.

Nothing under ``benchmark/`` imports JAX or the JAX package (compared by
whole top-level module name: ``rfnet_tpu_torch`` is the program, not
``rfnet_tpu``), and nothing under ``benchmark/reference/`` imports the
program. ``BENCHMARK.json`` keeps to the contract's keys, names and
lengths, and every name in it has its file.
"""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from benchmark import harness
from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import benchmark_files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", benchmark_files(), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_imports(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", benchmark_files("reference"),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"rfnet_tpu_torch", *FORBIDDEN}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    for name in ("rfnet_tpu_torch_x", "rfnet_tpu_torch_x.ops", "jaxtyping", "jax.numpy",
                 "rfnet_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = set(forbidden_modules())
    assert {"jax.numpy", "rfnet_tpu.models"} <= found
    assert not {"rfnet_tpu_torch_x", "rfnet_tpu_torch_x.ops", "jaxtyping"} & found


def _bench(with_pending: bool = False) -> dict:
    """``BENCHMARK.json``; with the entries that cells left out for now keep
    in their workload files, as it reads with those cells back."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    if with_pending:
        spec_dir = os.path.join(harness.HERE, "workloads")
        for name in sorted(os.listdir(spec_dir)):
            with open(os.path.join(spec_dir, name)) as f:
                pending = json.load(f).get("pending", {})
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                b[key] = b[key] + pending.get(key, [])
    return b


@pytest.mark.parametrize("with_pending", [False, True], ids=["as_is", "with_pending"])
def test_benchmark_json_keys_and_names(with_pending):
    b = _bench(with_pending)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert c["reduced"] == [] and 0 < len(c["why"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(harness.HERE, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(harness.HERE, "workloads", w["name"] + ".json"))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        for cell in m["workloads"]:  # each cell that reads it reports what it moves
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _bench(True)["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]

"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` names the cell's configuration and traffic, and which
  metrics it reports;
* ``configs/<config>.json`` holds the configuration's sizes and weights;
* ``traffic/<traffic>.json`` holds the mix that ``traffic/synthetic.py``
  generates;
* ``workloads/<cell>.json`` names the driver (``drivers/<driver>.py``), the
  warm-up, the profiled slice and the check's sample and limits;
* ``metrics/<metric>.py`` holds the reader of each per-layer metric
  (``read(slice) -> float | None``).

A driver is a class ``Driver(cell, seed, device, program=None)`` with
``warm()``, ``step(i)``, ``sync()``, ``host_s`` (the host seconds of each
step's span, by the host clock), ``end_to_end(window_s)``,
``tally() -> (attempted, failed)``, ``work() -> (matmuls, scan FLOPs)``
a step, ``release()`` and ``check() -> [(name, value, limit)]``, which also
leaves ``details`` (readings beside the compared numbers, printed before
them);
``program`` replaces the program under test (the control, the planted
faults).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = float(1 << 30)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for_cell(entries: list[dict], cell: str) -> list[dict]:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    """The cell ``name`` with its configuration, mix, workload file and
    metric entries, as plain data. A cell that ``BENCHMARK.json`` leaves out
    for now is found by the entries its workload file keeps under
    ``pending`` (the ones ``BENCHMARK.json`` takes when the cell comes back),
    so its tests and readings still run."""
    from benchmark.traffic import synthetic

    bench = _json(bench_path)
    spec_path = os.path.join(HERE, "workloads", name + ".json")
    spec = _json(spec_path) if os.path.isfile(spec_path) else {}
    pending = spec.get("pending", {})
    workloads = bench["workloads"] + pending.get("workloads", [])
    found = [w for w in workloads if w["name"] == name]
    if not found or not spec:
        raise SystemExit(f"no workload {name!r} in {bench_path} or {spec_path}")
    wl = found[0]
    cfg = [c for c in bench["configs"] + pending.get("configs", [])
           if c["name"] == wl["config"]][0]
    return {
        "name": name, "chips": wl["chips"],
        "config": _json(os.path.join(ROOT, cfg["file"])),
        "traffic": synthetic.load_mix(wl["traffic"]),
        "spec": spec,
        "end_to_end": _for_cell(bench["end_to_end"] + pending.get("end_to_end", []), name),
        "per_layer": _for_cell(bench["per_layer"] + pending.get("per_layer", []), name),
    }


def driver_class(cell: dict):
    return importlib.import_module("benchmark.drivers." + cell["spec"]["driver"]).Driver


def read_per_layer(cell: dict, sl) -> dict:
    """Each per-layer metric of the cell that its reader finds in the slice."""
    out = {}
    for m in cell["per_layer"]:
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(sl)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 and got.stdout else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             program=None) -> dict:
    """One run: returns the result line's object (``checks`` last).

    With ``trace`` the profiler records the window's first
    ``trace_steps`` steps (the slice); the rest of the window runs
    unprofiled, and its steps, wall and mean host span are handed to the
    metrics beside the slice, so that numbers the profiler's own host
    overhead would distort (host time, idle share, the step's rate) are
    read where it is off."""
    device = torch.device(device)
    peaks = _json(os.path.join(HERE, "peaks.json"))
    spec = cell["spec"]
    with contextlib.redirect_stdout(sys.stderr):  # the program's prints stay off stdout
        built = time.perf_counter()
        driver = driver_class(cell)(cell, seed, device, program)
        warming = time.perf_counter()
        driver.warm()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.3f} s: {built - t0:.3f} to start, {warming - built:.3f} to build the "
          f"driver, {setup_s - (warming - t0):.3f} to warm", file=sys.stderr)

    prof = slice_span = None
    trace_steps = spec["trace_steps"] if trace else 0
    if trace_steps:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    start = time.perf_counter()
    steps = 0
    rest_start = None  # when the profiler stopped: the rest of the window runs unprofiled
    while True:
        if steps == 0 and prof is not None:
            slice_span = torch.profiler.record_function("bench.slice")
            slice_span.__enter__()
        driver.step(steps)
        steps += 1
        if steps == trace_steps:
            driver.sync()
            slice_span.__exit__(None, None, None)
            prof.stop()
            rest_start = time.perf_counter()
        if steps >= trace_steps and time.perf_counter() - start >= seconds:
            break
    driver.sync()
    end = time.perf_counter()
    window_s = end - start

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, failed = driver.tally()
    result = {"correct": False, "attempted": attempted, "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if trace_steps:
        from benchmark import tracing

        matmuls, scan_flops = driver.work()
        host = driver.host_s[trace_steps:]
        rest = {"steps": steps - trace_steps, "wall_s": end - rest_start,
                "host_s": sum(host) / len(host) if host else None}
        sl = tracing.Slice(tracing.collect(prof), trace_steps, matmuls, scan_flops, peaks,
                           rest)
        result["metrics"] = read_per_layer(cell, sl)
        dev.update(busy_s=sl.busy_s(), window_s=sl.wall_s)
        result["device"] = dev
        result["breakdown"] = sl.breakdown()
        del prof, sl
    else:
        values = dict(driver.end_to_end(window_s), setup_s=setup_s, peak_mem_gib=peak / GIB)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell["end_to_end"]}
        result["device"] = dev

    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with contextlib.redirect_stdout(sys.stderr):
        checks = driver.check()
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["correct"] = bool(ok and failed == 0 and attempted > 0)
    result["details"] = driver.details  # readings beside the compared numbers
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result

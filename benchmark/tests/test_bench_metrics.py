"""Each per-layer metric's reader on a small trace written by hand.

The trace: a ``bench.slice`` span of 100 µs holding two steps. Each step
has a ``bench.dispatch``/``bench.step`` span, a ``bench.complete`` and a
``bench.metrics`` span, an ``aten::addmm`` operator and PyTorch's
``Optimizer.step#Adam.step`` span; runtime calls launch kernels tied to
them by correlation id. Two kernels overlap, so the busy time is their
union, and one kernel runs past the slice's end, so only its part inside
counts.
"""

from __future__ import annotations

import os

import pytest

from benchmark import flops, harness
from benchmark.tracing import Event, Slice

PEAKS = {"fp32_flops": 1e6, "hbm_bytes_per_s": 1e12}  # 1 FLOP a microsecond
# the unprofiled rest of the window: 4 steps of 50 µs, 40 µs of host span each
REST = {"steps": 4, "wall_s": 200e-6, "host_s": 40e-6}


def _trace() -> list[Event]:
    ev = [Event("range", "bench.slice", 0.0, 100.0, tid=1)]
    for s, base in enumerate((0.0, 50.0)):
        ev += [
            Event("range", "bench.dispatch", base, 40.0, tid=1),
            Event("range", "bench.step", base, 40.0, tid=1),
            Event("range", "bench.complete", base + 1, 20.0, tid=1),
            Event("op", "aten::addmm", base + 2, 5.0, tid=1),
            Event("range", "bench.metrics", base + 22, 10.0, tid=1),
            Event("range", "Optimizer.step#Adam.step", base + 33, 5.0, tid=1),
        ]
        c = 100 * (s + 1)
        # launches: a matmul (inside addmm), an elementwise kernel, a metrics
        # kernel, an Adam kernel
        ev += [Event("runtime", "cudaLaunchKernel", base + 3, 1.0, corr=c, tid=1),
               Event("runtime", "cudaLaunchKernel", base + 10, 1.0, corr=c + 1, tid=1),
               Event("runtime", "cudaLaunchKernel", base + 23, 1.0, corr=c + 2, tid=1),
               Event("runtime", "cudaLaunchKernel", base + 34, 1.0, corr=c + 3, tid=1)]
        ev += [Event("kernel", "volta_sgemm_128x64_nn", base + 5, 8.0, corr=c),
               Event("kernel", "elementwise_add", base + 11, 6.0, corr=c + 1),  # overlaps the next
               Event("kernel", "nn_dyn_kernel", base + 15, 10.0, corr=c + 2),
               Event("kernel", "multi_tensor_apply_kernel", base + 40, 4.0, corr=c + 3)]
    ev.append(Event("memcpy", "Memcpy HtoD", 95.0, 10.0))  # runs 5 µs past the slice
    return ev


def _slice(matmuls=None, scan=0.0) -> Slice:
    matmuls = matmuls if matmuls is not None else [flops.Matmul("a", 4.0, 0.0)]
    return Slice(_trace(), steps=2, matmuls=matmuls, scan_flops=scan, peaks=PEAKS,
                 rest=REST)


def _read(name: str, sl: Slice):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"),
                               "m_" + name.replace(".", "_")).read(sl)


def test_busy_is_the_union_inside_the_slice():
    sl = _slice()
    # a step: 5-13, 11-25 (union 5-25), 40-44; the copy 95-100 inside
    assert sl.busy_s() == pytest.approx((2 * (20 + 4) + 5) / 1e6)
    assert sl.wall_s == pytest.approx(100e-6)


def test_idle_and_launches_and_host():
    sl = _slice()
    # 26.5 µs busy a step in the slice, 50 µs a step where the profiler is off
    assert _read("device_idle_pct.serve", sl) == pytest.approx(100 * (1 - 26.5 / 50))
    assert _read("device_idle_pct.train", sl) == _read("device_idle_pct.serve", sl)
    assert _read("launches.serve", sl) == 4
    assert _read("host_ms.serve", sl) == pytest.approx(0.040)
    assert _read("host_ms.train", sl) == pytest.approx(0.040)


def test_device_ms_under_spans():
    sl = _slice()
    # complete: the sgemm and the elementwise kernel (8 + 6 µs); metrics the
    # scan (10 µs); Adam its kernel (4 µs)
    assert _read("model_device_ms.serve", sl) == pytest.approx(14e-3)
    assert _read("metrics_device_ms.serve", sl) == pytest.approx(10e-3)
    assert _read("adam_device_ms.train", sl) == pytest.approx(4e-3)


def test_gemm_roofline_and_mfu():
    sl = _slice([flops.Matmul("a", 4.0, 0.0)], scan=6.0)
    # 4 FLOPs a step at 1 FLOP/µs = 4 µs a step, over the sgemm's 8 µs
    assert _read("gemm_roofline.serve", sl) == pytest.approx(50.0)
    assert _read("gemm_roofline.train", sl) == pytest.approx(50.0)
    # (4 + 6) FLOPs a step, a step 50 µs where the profiler is off, at 1 FLOP/µs
    assert _read("mfu.serve", sl) == pytest.approx(20.0)
    assert _read("mfu.train", sl) == pytest.approx(20.0)


def test_matmul_kernels_found_by_operator_where_the_name_is_silent():
    ev = [e._replace(name="Kernel2") if e.name.startswith("volta") else e for e in _trace()]
    sl = Slice(ev, 2, [flops.Matmul("a", 4.0, 0.0)], 0.0, PEAKS, REST)
    assert _read("gemm_roofline.serve", sl) == pytest.approx(50.0)


def test_linked_correlation_ids_are_followed():
    ev = [e._replace(corr=0, link=e.corr) if e.kind == "kernel" else e for e in _trace()]
    sl = Slice(ev, 2, [flops.Matmul("a", 4.0, 0.0)], 0.0, PEAKS, REST)
    assert _read("metrics_device_ms.serve", sl) == pytest.approx(10e-3)


def test_readers_find_nothing_in_a_trace_without_device_work():
    ev = [e for e in _trace() if e.kind in ("range", "op", "runtime")]
    sl = Slice(ev, 2, [flops.Matmul("a", 4.0, 0.0)], 0.0, PEAKS, REST)
    for name in ("device_idle_pct.serve", "launches.serve", "model_device_ms.serve",
                 "metrics_device_ms.serve", "adam_device_ms.train", "gemm_roofline.serve",
                 "gemm_roofline.train", "mfu.serve", "mfu.train"):
        assert _read(name, sl) is None, name


def test_no_rest_no_wall_metrics():
    sl = Slice(_trace(), 2, [flops.Matmul("a", 4.0, 0.0)], 0.0, PEAKS,
               {"steps": 0, "wall_s": 0.0, "host_s": None})
    for name in ("device_idle_pct.serve", "mfu.train", "host_ms.serve", "host_ms.train"):
        assert _read(name, sl) is None, name
    assert _read("launches.serve", sl) == 4


def test_breakdown_lists_ops_and_gaps():
    bd = _slice().breakdown()
    assert bd["device_ops"][0] == ["nn_dyn_kernel", pytest.approx(20e-6)]
    assert len(bd["idle_gaps"]) <= 10
    # gaps 0-5, 25-40, 44-55, 75-90, 94-95 µs; the first of the two longest
    # has its middle (32.5) in the first step's spans, the innermost of which
    # (latest start, last listed) is bench.step
    assert bd["idle_gaps"][0] == ["bench.step", pytest.approx(15e-6)]
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx([15e-6, 15e-6, 11e-6, 5e-6, 1e-6])

"""The readers of the program's spans and counters on a small trace written
by hand.

The trace: a ``bench.slice`` span of 100 µs holding two batches of 50 µs.
Each batch has the program's ``eval.dispatch`` span around ``eval.copy_in``
(0-4 µs of the batch), ``rfnet.forward`` (5-30 µs: a stage span of each
name, and one launch outside them) and ``eval.metrics`` (31-40 µs); runtime
calls launch kernels tied to them by correlation id. The copy to the card
runs from 2 to 6 µs of each batch, so the gap that ends it straddles the
start of the second batch's ``eval.copy_in``.
"""

from __future__ import annotations

import os
import sys

import pytest

from benchmark import flops, harness
from benchmark.tracing import Event, Slice

PEAKS = {"fp32_flops": 1e6, "hbm_bytes_per_s": 1e12}
REST = {"steps": 4, "wall_s": 200e-6, "host_s": 40e-6}
STAGES = ("encode", "decode", "merge", "refine")
NEW = ("encode_device_ms.serve", "decode_device_ms.serve", "merge_device_ms.serve",
       "refine_device_ms.serve", "copy_in_idle_ms.serve", "forward_idle_ms.serve",
       "scan_pairs_pct.serve")


def _trace() -> list[Event]:
    ev = [Event("range", "bench.slice", 0.0, 100.0, tid=1)]
    for s, base in enumerate((0.0, 50.0)):
        c = 100 * (s + 1)
        ev += [Event("range", "bench.dispatch", base, 41.0, tid=1),
               Event("range", "eval.dispatch", base, 40.0, tid=1),
               Event("range", "eval.copy_in", base, 4.0, tid=1),
               Event("runtime", "cudaMemcpyAsync", base + 1, 1.0, corr=c, tid=1),
               Event("memcpy", "Memcpy HtoD (Pinned -> Device)", base + 2, 4.0, corr=c),
               Event("range", "bench.complete", base + 5, 25.0, tid=1),
               Event("range", "rfnet.forward", base + 5, 25.0, tid=1)]
        # a stage each 5 µs from 6 µs, each launching a kernel of 1, 2, 3, 4
        # µs that runs 2 µs after its launch
        for k, stage in enumerate(STAGES):
            t = base + 6 + 5 * k
            ev += [Event("range", f"rfnet.{stage}", t, 4.0, tid=1),
                   Event("runtime", "cudaLaunchKernel", t + 1, 0.5, corr=c + 1 + k, tid=1),
                   Event("kernel", f"{stage}_kernel", t + 3, 1.0 + k, corr=c + 1 + k)]
        # decfactor_sq's launch: in the forward, in no stage
        ev += [Event("runtime", "cudaLaunchKernel", base + 27, 0.5, corr=c + 5, tid=1),
               Event("kernel", "pow_kernel", base + 28, 1.0, corr=c + 5),
               Event("range", "bench.metrics", base + 31, 9.0, tid=1),
               Event("range", "eval.metrics", base + 31, 9.0, tid=1),
               Event("runtime", "cudaLaunchKernel", base + 32, 1.0, corr=c + 6, tid=1),
               Event("kernel", "nn_dyn_kernel", base + 33, 10.0, corr=c + 6)]
    return ev


def _slice(events=None) -> Slice:
    return Slice(events if events is not None else _trace(), steps=2,
                 matmuls=[flops.Matmul("a", 4.0, 0.0)], scan_flops=0.0, peaks=PEAKS, rest=REST)


def _read(name: str, sl: Slice):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"),
                               "m_" + name.replace(".", "_")).read(sl)


def test_stage_device_ms():
    sl = _slice()
    for k, stage in enumerate(STAGES):  # a kernel of 1 + k µs a batch
        assert _read(f"{stage}_device_ms.serve", sl) == pytest.approx((1 + k) * 1e-3)
    # the stages partition the forward but for the one kernel outside them
    stages = sum(_read(f"{s}_device_ms.serve", sl) for s in STAGES)
    assert _read("model_device_ms.serve", sl) == pytest.approx(stages + 1e-3)


def test_idle_under_spans_is_the_intersection():
    sl = _slice()
    # a batch's busy time: the copy 2-6, the kernels 9-10, 14-16, 19-22,
    # 24-28, 28-29 and 33-43 µs. eval.copy_in (0-4) holds 2 µs of idle: the
    # first batch's 0-2, the second's 50-52 of the gap 43-52 that starts in
    # the first batch; rfnet.forward (5-30) holds 6-9, 10-14, 16-19, 22-24
    # and 29-30: 13 µs
    assert _read("copy_in_idle_ms.serve", sl) == pytest.approx(2e-3)
    assert _read("forward_idle_ms.serve", sl) == pytest.approx(13e-3)


def test_idle_counts_a_gap_that_straddles_a_span_edge_in_part():
    # the copy to the card runs 4 µs later, 6-10: the gap 0-6 straddles the
    # end of eval.copy_in (4 µs) and the start of rfnet.forward (5 µs); each
    # takes its own part, and the µs between them neither
    ev = [e._replace(start=e.start + 4) if e.kind == "memcpy" else e for e in _trace()]
    sl = _slice(ev)
    assert _read("copy_in_idle_ms.serve", sl) == pytest.approx(4e-3)
    assert _read("forward_idle_ms.serve", sl) == pytest.approx((1 + 4 + 3 + 2 + 1) * 1e-3)


def test_idle_shares_add_up_to_no_more_than_the_slice_idle():
    sl = _slice()
    idle_a_batch = sum(b - a for a, b in sl.idle_gaps()) / 1e3 / sl.steps
    assert (_read("copy_in_idle_ms.serve", sl) + _read("forward_idle_ms.serve", sl)
            <= idle_a_batch)


def test_readers_find_nothing_without_the_programs_spans_or_module(monkeypatch):
    # the parent tree: the harness's spans alone, and no tracing module to
    # import (scan_pairs_pct.serve's counters)
    monkeypatch.setitem(sys.modules, "rfnet_tpu_torch.tracing", None)
    import rfnet_tpu_torch

    monkeypatch.delattr(rfnet_tpu_torch, "tracing", raising=False)
    ev = [e for e in _trace() if not e.name.startswith(("eval.", "rfnet."))]
    sl = _slice(ev)
    for name in NEW:
        assert _read(name, sl) is None, name
    assert _read("model_device_ms.serve", sl) is not None  # the harness's own span stays


def test_scan_pairs_pct_reads_the_programs_counters(monkeypatch):
    from rfnet_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters",
                        lambda: {"k3.pairs_loaded": 300, "k3.pairs_dense": 1200})
    assert _read("scan_pairs_pct.serve", _slice()) == pytest.approx(25.0)
    monkeypatch.setattr(tracing, "counters", dict)  # a run that counted nothing (the CPU)
    assert _read("scan_pairs_pct.serve", _slice()) is None


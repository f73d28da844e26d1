"""What the benchmark reads from a ``torch.profiler`` trace.

:func:`collect` turns the profiler's events into plain :class:`Event`
records; :class:`Slice` answers the per-layer metrics' questions about the
profiled slice of a window: which device operations ran in it and for how
long, which of them a host span launched, and where the device sat idle.
The records are plain data, so the tests build small traces by hand.

A kernel is tied to the host call that launched it by the CUDA runtime's
correlation id; it counts as launched inside a span when that call's start
lies inside the span.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import NamedTuple

import torch

from benchmark import flops

DEVICE_KINDS = ("kernel", "memcpy", "memset")
SLICE_RANGE = "bench.slice"
NAME_CHARS = 160  # longest kernel name the breakdown keeps


class Event(NamedTuple):
    kind: str  # kernel, memcpy, memset, runtime, range (a span), op (a PyTorch operator)
    name: str
    start: float  # microseconds
    dur: float  # microseconds
    corr: int = 0  # correlation id (runtime calls and device operations)
    link: int = 0  # the linked correlation id, where the profiler gives one
    tid: int = 0  # host thread

    @property
    def end(self) -> float:
        return self.start + self.dur


_RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernelEx, ...


def _host_kind(name: str) -> str:
    if _RUNTIME_CALL.match(name):
        return "runtime"
    return "op" if "::" in name else "range"


def collect(prof) -> list[Event]:
    """The events of a stopped ``torch.profiler.profile``, without building
    its per-operator tables. Each event's kind comes from its device and
    name, which every PyTorch version gives (not all give an activity
    type); a device event that repeats a host span's name is the span's
    shadow on the device, and is dropped."""
    raw = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = {e.name() for e in raw if e.device_type() == cpu and _host_kind(e.name()) == "range"}
    out = []
    for e in raw:
        name = e.name()
        if e.device_type() == cpu:
            kind = _host_kind(name)
        elif name in ranges:
            continue
        else:
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
        out.append(Event(kind, name, e.start_ns() / 1e3, e.duration_ns() / 1e3,
                         e.correlation_id(), e.linked_correlation_id(), e.start_thread_id()))
    return out


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class _Cover:
    """A union of intervals, asked whether it holds a time."""

    def __init__(self, intervals):
        merged = _union(intervals)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]

    def __contains__(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


class Slice:
    """The profiled slice of a window: the ``bench.slice`` span's interval,
    the ``steps`` (batches or train steps) run in it, and what the cell's
    work is a step (``matmuls``: :class:`flops.Matmul` list; ``scan_flops``),
    with the card's ``peaks``; ``rest`` describes the window's
    unprofiled steps after the slice: ``steps``, ``wall_s`` and ``host_s``
    (the mean host seconds of a step's span, None where none ran)."""

    def __init__(self, events: list[Event], steps: int, matmuls, scan_flops: float,
                 peaks: dict, rest: dict | None = None):
        spans = [e for e in events if e.kind == "range" and e.name == SLICE_RANGE]
        if len(spans) != 1:
            raise ValueError(f"expected one {SLICE_RANGE} span, found {len(spans)}")
        self.t0, self.t1, self.main_tid = spans[0].start, spans[0].end, spans[0].tid
        self.events = events
        self.steps = steps
        self.matmuls, self.scan_flops, self.peaks = matmuls, scan_flops, peaks
        self.rest = rest if rest and rest["steps"] > 0 else None
        self.device = [e for e in events if e.kind in DEVICE_KINDS
                       and e.end > self.t0 and e.start < self.t1]
        self.kernels = [e for e in self.device if e.kind == "kernel"]
        self._launch = self._link_launches(events)

    def _link_launches(self, events) -> dict[int, tuple[float, int]]:
        """(start, thread) of the runtime call that launched each device
        operation (by index in ``self.device``) whose call is in the trace:
        tied by correlation id, or by the linked id where that ties more."""
        calls = {e.corr: (e.start, e.tid) for e in events if e.kind == "runtime" and e.corr}
        best: dict[int, tuple[float, int]] = {}
        for field in ("corr", "link"):
            got = {i: calls[getattr(e, field)] for i, e in enumerate(self.device)
                   if getattr(e, field) in calls}
            if len(got) > len(best):
                best = got
        return best

    # --- device time ------------------------------------------------------

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        return _union((max(e.start, self.t0), min(e.end, self.t1)) for e in self.device)

    def busy_s(self) -> float:
        """Seconds of the slice in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        return gaps

    def rest_step_s(self) -> float | None:
        """Wall seconds a step in the unprofiled rest of the window."""
        return self.rest["wall_s"] / self.rest["steps"] if self.rest else None

    # --- what several metrics read, each for its own cells ------------------

    def host_ms(self) -> float | None:
        """Mean host milliseconds of a step's span in the unprofiled rest."""
        return self.rest["host_s"] * 1e3 if self.rest and self.rest["host_s"] is not None else None

    def idle_pct(self) -> float | None:
        """1 − device busy a step (the slice's union over its steps) / wall a
        step where the profiler is off, in %."""
        step_s = self.rest_step_s()
        if not self.device or step_s is None:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.steps / step_s)

    def mfu_pct(self) -> float | None:
        """The step's counted FLOPs (products and dense scans) over the wall
        a step where the profiler is off, against the float32 peak, in %."""
        step_s = self.rest_step_s()
        if not self.device or step_s is None:
            return None
        work = flops.total_flops(self.matmuls) + self.scan_flops
        return 100.0 * work / step_s / self.peaks["fp32_flops"]

    def roofline_pct(self, name_keys, ops) -> float | None:
        """The step's products at their roofline (each at the larger of its
        FLOPs at the float32 peak and its bytes at the bandwidth) over the
        device time of the product kernels: those whose name holds one of
        ``name_keys`` or that an operator in ``ops`` launched, in %."""
        by_op = {id(e) for e in self.launched_in(ops, kinds=("op",), same_thread=True)}
        kernels = [e for e in self.kernels
                   if id(e) in by_op or any(k in e.name.lower() for k in name_keys)]
        if not kernels:
            return None
        least, _, _ = flops.roofline_seconds(self.matmuls, self.peaks["fp32_flops"],
                                             self.peaks["hbm_bytes_per_s"])
        return 100.0 * least * self.steps / self.kernel_s(kernels)

    def kernel_s(self, kernels) -> float:
        return sum(min(e.end, self.t1) - max(e.start, self.t0) for e in kernels) / 1e6

    # --- attribution --------------------------------------------------------

    def launched_in(self, names, kinds=("range",), same_thread: bool = False) -> list[Event]:
        """Kernels of the slice whose launching call starts inside a host
        event of one of ``kinds`` named in ``names`` (on the launching
        thread where ``same_thread``)."""
        names = set(names)
        by_tid: dict[int, list] = defaultdict(list)
        for e in self.events:
            if e.kind in kinds and e.name in names:
                by_tid[e.tid if same_thread else 0].append((e.start, e.end))
        covers = {tid: _Cover(iv) for tid, iv in by_tid.items()}
        out = []
        for i, e in enumerate(self.device):
            launch = self._launch.get(i)
            if e.kind != "kernel" or launch is None:
                continue
            cover = covers.get(launch[1] if same_thread else 0)
            if cover is not None and launch[0] in cover:
                out.append(e)
        return out

    def spans(self, name: str) -> list[Event]:
        return [e for e in self.events if e.kind == "range" and e.name == name
                and self.t0 <= e.start and e.end <= self.t1]

    def host_at(self, t: float, host=None) -> str:
        """The innermost host event of the slice's thread running at ``t``."""
        best = None
        for e in host if host is not None else self.events:
            if (e.kind in ("range", "op", "runtime") and e.tid == self.main_tid
                    and e.start <= t <= e.end and (best is None or e.start >= best.start)):
                best = e
        return best.name if best is not None else "(no host event)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by what the host was doing in its middle."""
        total: dict[str, float] = defaultdict(float)
        for e in self.device:
            total[e.name[:NAME_CHARS]] += (min(e.end, self.t1) - max(e.start, self.t0)) / 1e6
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        host = [e for e in self.events if e.tid == self.main_tid and e.kind in ("range", "op",
                "runtime") and e.end >= self.t0 and e.start <= self.t1]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_at((a + b) / 2, host), (b - a) / 1e6] for a, b in gaps]}

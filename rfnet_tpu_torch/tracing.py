"""Spans and counters at the serving path's layer boundaries, and the
profiler trace that records them.

Tracing is on exactly while a ``torch.profiler`` records: the eval and train
CLIs' ``--profile_dir`` (:func:`profile_trace`), or any caller's own
``torch.profiler.profile``. There is no other switch.

* :func:`span` opens a named host range. The profiler records it on the
  clock of the card's kernels and copies, so an idle stretch of the device
  can be put down to the span the host was in. Its keyword arguments (a
  batch's ordinal, a recurrent step) are the record's inputs: they appear in
  the trace where the profiler records inputs (``record_shapes``, as
  :func:`profile_trace` does).
* :func:`count` adds to a host counter; :func:`device_counter` gives a
  kernel an int64 buffer on the card to add to. :func:`counters` reads all
  of them as plain ints, the device ones back once, after the work;
  :func:`reset` starts them again from nothing.

With no profiler running a span is one flag check and the shared no-op
context, a host count is dropped and ``device_counter`` returns None (a
kernel then gets a null pointer and counts nothing): no ``record_function``
is entered and no buffer is allocated.

Spans of a serving batch (``eval.dispatch`` and the model): ``eval.dispatch``
(args: the batch's ordinal) around ``eval.copy_in`` (the partial),
``rfnet.forward``, ``eval.copy_in`` (the ground truth) and
``eval.metrics``; inside ``rfnet.forward``, for each recurrent step 1-3 (the
``step`` arg), ``rfnet.encode``, ``rfnet.decode``, ``rfnet.merge`` and
``rfnet.refine``. SnowflakeNet's forward (``models/snowflakenet.py``) in
place of ``rfnet.forward``: ``snow.forward`` around ``snow.extract``,
``snow.seed`` and ``snow.spd`` (the ``step`` arg, 0-2), with ``snow.attn``
(the ``block`` arg, 0-4) around each attention block. Counters:
``k3.pairs_loaded`` (K3's blocks: the targets of every slab a block loaded,
times its live queries), ``k3.pairs_dense`` (b·n·m of the same launches),
``knn.pairs`` (b·n·m of every k-NN call, ``ops/knn.py``: K10 on the card)
and ``knn.launches`` (the calls), and for every dense layer call
``dense.macs_per_point`` (the multiply-adds it did at every point) and
``dense.macs_per_cloud_saved`` (those over per-cloud columns that it did
once a cloud instead, ``nn.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from rfnet_tpu_torch import kernels

_OFF = contextlib.nullcontext()
_host: dict[str, int] = defaultdict(int)
_device: dict[tuple[str, torch.device], torch.Tensor] = {}


def span(name: str, **args):
    """A host range ``name`` while a profiler records (its keyword
    arguments as the record's inputs); otherwise the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name, (), args)


def active() -> bool:
    """Whether a profiler records (spans and counters are on)."""
    return _profiler._is_profiler_enabled


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _host[name] += n


def device_counter(name: str, device: torch.device) -> torch.Tensor | None:
    """The int64 counter ``name`` on ``device`` (one element, zero when
    made) for a kernel to add to, while a profiler records; None otherwise.
    Made by a copy from pinned host memory, so it launches no kernel."""
    if not _profiler._is_profiler_enabled:
        return None
    buf = _device.get((name, device))
    if buf is None:
        buf = torch.zeros(1, dtype=torch.int64).pin_memory().to(device, non_blocking=True)
        _device[name, device] = buf
    return buf


def counters() -> dict[str, int]:
    """Every counter as a plain int, device counters summed over devices
    (read back here, which waits for the kernels that add to them)."""
    out = dict(_host)
    for (name, _), buf in _device.items():
        out[name] = out.get(name, 0) + int(buf.item())
    return out


def reset() -> None:
    """Forget every counter: each starts again from zero at its next use."""
    _host.clear()
    _device.clear()


@contextlib.contextmanager
def profile_trace(profile_dir: str | None, device: torch.device, name: str = "trace.json"):
    """``torch.profiler`` around the block, as ``jax.profiler`` wraps the
    JAX CLIs' runs: host activity with the package's spans and their
    arguments, and the card's kernels and copies where ``device`` is CUDA.
    However the block ends, the Chrome trace is written to
    ``<profile_dir>/<name>`` and, beside it, ``counters<rest of name>``
    (``counters.json`` beside ``trace.json``): :func:`counters` of the block
    and :data:`kernels.launches` at its end. Does nothing without a
    directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    reset()
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(profile_dir, name)
        prof.export_chrome_trace(path)
        counts = os.path.join(profile_dir, "counters" + name.removeprefix("trace"))
        with open(counts, "w") as f:
            json.dump({"counters": counters(), "launches": dict(kernels.launches)}, f, indent=1)
        print(f"profiler trace written to {path}, counters to {counts}")

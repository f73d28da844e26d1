"""What the per-layer metrics read of the program's own spans
(``rfnet_tpu_torch/tracing.py``), through :class:`benchmark.tracing.Slice`.

Each returns None where the program records none of them: a tree without
its spans, a run without the card's device timeline.
"""

from __future__ import annotations


def device_ms(sl, span: str) -> float | None:
    """Device milliseconds a step of the kernels launched inside ``span``."""
    kernels = sl.launched_in((span,))
    return sl.kernel_s(kernels) * 1e3 / sl.steps if kernels else None


def idle_ms(sl, span: str) -> float | None:
    """Milliseconds a step in which the device sat idle while the slice's
    thread was inside ``span``: the intersection of the slice's idle gaps
    with the span's intervals on that thread."""
    spans = sorted((e.start, e.end) for e in sl.spans(span) if e.tid == sl.main_tid)
    if not spans:
        return None
    held = []  # the spans' union
    for a, b in spans:
        if held and a <= held[-1][1]:
            held[-1][1] = max(held[-1][1], b)
        else:
            held.append([a, b])
    idle, i = 0.0, 0
    for a, b in sl.idle_gaps():  # sorted and disjoint, as the union is
        while i < len(held) and held[i][1] <= a:
            i += 1
        j = i
        while j < len(held) and held[j][0] < b:
            idle += min(b, held[j][1]) - max(a, held[j][0])
            j += 1
    return idle / 1e3 / sl.steps

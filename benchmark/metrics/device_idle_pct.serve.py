"""Share of a step's wall in which nothing runs on the card: 1 − (device
busy time a step, the union of the profiled slice's kernels, copies and
memsets over its steps) / (wall a step in the unprofiled rest of the
window). The profiler's host overhead stretches the slice's own wall, so
the wall is read where it is off; the driver's idle share from
``device.busy_s`` and ``device.window_s`` is the slice's own."""


def read(sl):
    return sl.idle_pct()

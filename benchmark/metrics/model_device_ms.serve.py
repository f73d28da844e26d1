"""Device milliseconds a batch of the kernels launched inside the
harness's span around the serving entry's ``complete`` (the model's
forward)."""

SPANS = ("bench.complete",)


def read(sl):
    kernels = sl.launched_in(SPANS)
    return sl.kernel_s(kernels) * 1e3 / sl.steps if kernels else None

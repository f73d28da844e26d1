"""Device milliseconds a step of the kernels launched inside PyTorch's own
span around the optimizer's update."""

SPANS = ("Optimizer.step#Adam.step",)


def read(sl):
    kernels = sl.launched_in(SPANS)
    return sl.kernel_s(kernels) * 1e3 / sl.steps if kernels else None

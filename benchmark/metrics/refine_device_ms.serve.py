"""Device milliseconds a batch of the kernels launched inside the program's
``rfnet.refine`` spans (the forward's refine stage, its three recurrent
steps together)."""

from benchmark import program_spans


def read(sl):
    return program_spans.device_ms(sl, "rfnet.refine")

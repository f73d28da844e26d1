"""Device milliseconds a batch of the kernels launched inside the program's
``rfnet.encode`` spans (the forward's encode stage, its three recurrent
steps together)."""

from benchmark import program_spans


def read(sl):
    return program_spans.device_ms(sl, "rfnet.encode")

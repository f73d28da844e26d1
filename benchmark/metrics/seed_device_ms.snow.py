"""Device milliseconds a batch of the kernels launched inside the program's
``snow.seed`` span (the seed generator, and the FPS that merges its seeds
with the partial into P0)."""

from benchmark import program_spans


def read(sl):
    return program_spans.device_ms(sl, "snow.seed")

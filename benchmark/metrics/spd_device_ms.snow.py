"""Device milliseconds a batch of the kernels launched inside the program's
``snow.spd`` spans (the three SPD stages together, their skip-transformers
included)."""

from benchmark import program_spans


def read(sl):
    return program_spans.device_ms(sl, "snow.spd")

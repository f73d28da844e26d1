"""Device milliseconds a batch of the kernels launched inside the program's
``snow.extract`` span (the feature extractor: its three set abstractions,
FPS and k-NN included, and its two point transformers)."""

from benchmark import program_spans


def read(sl):
    return program_spans.device_ms(sl, "snow.extract")

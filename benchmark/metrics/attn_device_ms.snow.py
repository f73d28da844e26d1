"""Device milliseconds a batch of the kernels launched inside the program's
``snow.attn`` spans: the five k-NN vector attention blocks (the encoder's
two point transformers and the three SPD skip-transformers), each with its
k-NN, the mechanism's own share of the forward."""

from benchmark import program_spans


def read(sl):
    return program_spans.device_ms(sl, "snow.attn")

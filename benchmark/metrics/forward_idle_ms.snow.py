"""Milliseconds a batch in which the device sat idle while the host was
inside the program's ``snow.forward`` span: the device waiting on the
host's launches of SnowflakeNet's forward (the slice's idle intervals
intersected with the span's)."""

from benchmark import program_spans


def read(sl):
    return program_spans.idle_ms(sl, "snow.forward")

"""Milliseconds a batch in which the device sat idle while the host was
inside the program's ``eval.copy_in`` span (pinning the partial and the
ground truth, their host copies and the queued copies to the card): the
slice's idle intervals intersected with the span's."""

from benchmark import program_spans


def read(sl):
    return program_spans.idle_ms(sl, "eval.copy_in")

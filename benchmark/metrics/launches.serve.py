"""Kernels a batch: every kernel that ran on the card in the profiled slice,
over the batches in it (copies and memsets not counted)."""


def read(sl):
    return len(sl.kernels) / sl.steps if sl.kernels else None

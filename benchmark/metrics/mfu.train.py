"""The whole step's share of the card's float32 peak (outside the tensor
cores): the step's matrix-product FLOPs and its dense nearest-neighbour
scans' FLOPs (``flops.py``, from the published widths) over the wall a
step in the unprofiled rest of the window, against the peak. The
early-exit chamfer scans and the approx-EMD recurrences are not counted."""


def read(sl):
    return sl.mfu_pct()

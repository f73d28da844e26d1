"""K10's share of its roofline: the least time the card could take for a
batch's k-NN (``flops_snowflake.knn_least_seconds``: each call at the
larger of its FLOPs, 8 a pair, at the float32 peak and its bytes at the
bandwidth, from the published widths) over the device time a batch of
K10's kernel (``knn_kernel``) in the profiled slice. The batch's clouds are
the program's ``knn.pairs`` counter over the slice's batches and the pairs
a cloud of the published widths. None where the program runs no K10 or
counts no pairs (a tree before it)."""

import json
import os

from benchmark import flops_snowflake
from benchmark.harness import HERE

KERNEL = "knn_kernel"


def read(sl):
    try:
        from rfnet_tpu_torch import tracing
    except ImportError:
        return None
    pairs = tracing.counters().get("knn.pairs")
    kernels = [e for e in sl.kernels if KERNEL in e.name]
    if not pairs or not kernels:
        return None
    with open(os.path.join(HERE, flops_snowflake.CONFIG)) as f:
        cfg = json.load(f)
    clouds = pairs / flops_snowflake.knn_pairs(cfg) / sl.steps
    least = flops_snowflake.knn_least_seconds(cfg, clouds, sl.peaks)
    return 100.0 * least * sl.steps / sl.kernel_s(kernels)

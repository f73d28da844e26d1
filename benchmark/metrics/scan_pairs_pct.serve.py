"""Pairs K3's blocks loaded, as a share of the dense scan's pairs, in %:
100 × ``k3.pairs_loaded`` / ``k3.pairs_dense``, the program's counters of
the profiled slice (every K3 launch of its batches counts in both). None
where the program has no tracing module (a tree before it) or counted
nothing (the CPU's plain scans)."""


def read(sl):
    try:
        from rfnet_tpu_torch import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    dense = counts.get("k3.pairs_dense")
    if not dense or "k3.pairs_loaded" not in counts:
        return None
    return 100.0 * counts["k3.pairs_loaded"] / dense

"""k nearest neighbours: SnowflakeNet's grouping (kernel K10, ``csrc/knn.cu``).

``knn(k, targets, queries)`` returns, for each query, the squared distances
to its ``k`` nearest targets of the same cloud and their int32 indices,
nearest first, the lower index first among equal distances. A distance is
taken from the coordinate differences, ``(dx² + dy²) + dz²`` with one
rounding per op (``chamfer._sq3``), not from the expansion |q|² + |t|² −
2·q·t that the published ``square_distance`` takes, so a point's distance
to itself is exactly 0; and the order among ties is fixed where the
published ``argsort`` promises none.

CUDA tensors go through K10, which is built for k = 16 only: another k on
the card is an error, not a slower path. CPU tensors go through the plain
version :func:`_knn_plain` (every distance, then a stable sort), which
rounds as the kernel does, so the two agree bit for bit. Each K10 launch
adds its ``b·m·n`` pairs to the counter ``knn.pairs`` and one to
``knn.launches`` while a profiler records (``tracing.py``); the plain
version counts nothing.

Unlike ``grouping.knn_point`` (the JAX package's contract: negated
distances, JAX parity), this op is the port's own.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels, tracing
from rfnet_tpu_torch.ops.chamfer import _PLAIN_CHUNK_ELEMS, _sq3

KNN_KERNEL_K = 16  # the k K10 is built for (csrc/knn.cu)


def _knn_plain(k: int, targets: torch.Tensor, queries: torch.Tensor):
    """Plain version of K10: (b, n, k) squared distances and int32 indices,
    in chunks of queries."""
    b, n, _ = queries.shape
    m = targets.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // (b * m))
    dist, idx = [], []
    for lo in range(0, n, step):
        d = _sq3(queries[:, lo:lo + step, None, :] - targets[:, None, :, :])
        val, arg = torch.sort(d, dim=-1, stable=True)
        dist.append(val[..., :k])
        idx.append(arg[..., :k].to(torch.int32))
    return torch.cat(dist, 1), torch.cat(idx, 1)


def _knn_launch(k: int, targets: torch.Tensor, queries: torch.Tensor):
    b, n, _ = queries.shape
    dist = torch.empty((b, n, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=queries.device)
    kernels.launch("knn", queries.device, queries, targets, b, n, targets.shape[1], k, dist, idx)
    tracing.count("knn.pairs", b * n * targets.shape[1])
    tracing.count("knn.launches", 1)
    return dist, idx


def knn(k: int, targets: torch.Tensor, queries: torch.Tensor):
    """The ``k`` nearest of the (b, m, 3) ``targets`` to each of the (b, n,
    3) ``queries``: (squared distances (b, n, k) float32, indices (b, n, k)
    int32), nearest first, the lower index first among ties. Needs m >= k,
    and k = 16 on the card. Gradient-free."""
    for name, x in (("targets", targets), ("queries", queries)):
        if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected (b, n, 3) float32, got {tuple(x.shape)} {x.dtype}")
    b, n, _ = queries.shape
    m = targets.shape[1]
    if targets.shape[0] != b or targets.device != queries.device:
        raise ValueError(f"targets {tuple(targets.shape)} on {targets.device} and queries "
                         f"{tuple(queries.shape)} on {queries.device} differ in batch or device")
    if not 1 <= k <= m or n == 0:
        raise ValueError(f"k = {k} needs 1 <= k <= {m} targets and at least one query")
    if queries.is_cuda and k != KNN_KERNEL_K:
        raise ValueError(f"k = {k}: K10 is built for k = {KNN_KERNEL_K} only")
    targets = targets.detach().contiguous()
    queries = queries.detach().contiguous()
    if queries.is_cuda:
        return _knn_launch(k, targets, queries)
    return _knn_plain(k, targets, queries)

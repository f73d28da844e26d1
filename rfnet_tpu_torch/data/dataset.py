"""Resampling and synthetic clouds — copies of the JAX package's
``resample_pcd`` and ``synthetic_pairs`` (``rfnet_tpu/data/dataset.py``),
producing the same arrays from the same seeds."""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def resample_pcd(pcd: np.ndarray, n: int, rng: np.random.RandomState | None = None):
    """Drop or duplicate points so pcd has exactly n points: truncation keeps
    the FIRST n points; padding appends uniformly random duplicates (drawn
    from ``rng``, or the global numpy RNG)."""
    if pcd.shape[0] == n:
        return pcd
    idx = np.arange(pcd.shape[0])
    if idx.shape[0] < n:
        r = rng if rng is not None else np.random
        idx = np.concatenate([idx, r.randint(pcd.shape[0], size=n - pcd.shape[0])])
    return pcd[idx[:n]]


def synthetic_pairs(
    num: int, input_size: int = 3000, gt_size: int = 16384, seed: int = 0
) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
    """Deterministic random (id, partial, gt) triples: the gt is a mixture of
    gaussian blobs and the partial the points on one side of a random plane,
    resampled to ``input_size``."""
    rng = np.random.RandomState(seed)
    for i in range(num):
        centers = rng.randn(8, 3).astype(np.float32) * 0.3
        which = rng.randint(0, 8, size=gt_size)
        gt = centers[which] + 0.08 * rng.randn(gt_size, 3).astype(np.float32)
        normal = rng.randn(3).astype(np.float32)
        side = (gt @ normal) > np.median(gt @ normal)
        part = resample_pcd(gt[side], input_size, rng)
        yield f"synthetic/{i:06d}", part.astype(np.float32), gt.astype(np.float32)

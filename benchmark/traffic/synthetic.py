"""The one traffic generator: pools of (partial, ground truth) clouds.

A frozen copy of the blob-mixture distribution that the converged weights
``weights/rfnet_r4_105000.npz`` were trained on (the program's
``data/dataset.py:synthetic_pairs``): the ground truth is ``ptnum`` points
of a mixture of 8 gaussian blobs (centres N(0, 0.3²), spread 0.08), and the
partial is the points on one side of a random plane through the median,
its first ``innum`` kept (random duplicates added where fewer).

A mix is a data file of this directory (``<traffic>.json``) naming the
pool: its ``pool`` clouds, their ``innum`` and ``ptnum``, the ``batch`` the
pool is cut into, and how the batches are sent (``loop``: "closed", one
client with ``in_flight`` batches; "steps", one training step after
another). Every seed gives the same sizes in the same order; only the
points differ.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, name + ".json")) as f:
        return json.load(f)


def seed32(seed: int) -> int:
    """A 32-bit seed for numpy's legacy generator from any whole number
    (the benchmark's seeds may pass 2³¹)."""
    return int(np.random.SeedSequence(abs(int(seed))).generate_state(1)[0])


def _resample(pcd: np.ndarray, n: int, rng: np.random.RandomState) -> np.ndarray:
    if pcd.shape[0] == n:
        return pcd
    idx = np.arange(pcd.shape[0])
    if idx.shape[0] < n:
        idx = np.concatenate([idx, rng.randint(pcd.shape[0], size=n - pcd.shape[0])])
    return pcd[idx[:n]]


def pairs(num: int, innum: int, ptnum: int, seed: int):
    """``num`` (partial (innum, 3), gt (ptnum, 3)) float32 pairs."""
    rng = np.random.RandomState(seed32(seed))
    for _ in range(num):
        centers = rng.randn(8, 3).astype(np.float32) * 0.3
        which = rng.randint(0, 8, size=ptnum)
        gt = centers[which] + 0.08 * rng.randn(ptnum, 3).astype(np.float32)
        normal = rng.randn(3).astype(np.float32)
        side = (gt @ normal) > np.median(gt @ normal)
        part = _resample(gt[side], innum, rng)
        yield part.astype(np.float32), gt.astype(np.float32)


def pool(mix: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The mix's pool cut into batches: partials (batches, batch, innum, 3)
    and ground truths (batches, batch, ptnum, 3), float32 on the host."""
    n, b = mix["pool"], mix["batch"]
    if n % b:
        raise ValueError(f"pool {n} is not a whole number of batches of {b}")
    ps, gs = zip(*pairs(n, mix["innum"], mix["ptnum"], seed))
    shape = (n // b, b)
    return (np.stack(ps).reshape(*shape, mix["innum"], 3),
            np.stack(gs).reshape(*shape, mix["ptnum"], 3))

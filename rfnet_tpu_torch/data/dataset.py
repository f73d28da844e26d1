"""Resampling, synthetic clouds and the training dataflow — copies of the
JAX package's ``resample_pcd``, ``synthetic_pairs``, ``BatchedDataflow`` and
``synthetic_dataflow`` (``rfnet_tpu/data/dataset.py``), producing the same
arrays in the same order from the same seeds. The LMDB source
(``lmdb_dataflow``) is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator

import numpy as np

_SEED = 1  # the JAX package's BatchedDataflow default
_PREFETCH = 8


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


class BatchedDataflow:
    """index stream (a permutation per epoch when training) → resample →
    batch → background prefetch thread, with the JAX package's seeds (1 for
    the index stream and for resampling) and depth (8 batches).

    Batches are ``(ids, inputs (b, input_size, 3) f32, input_size,
    gts (b, gt_size, 3) f32)``, the reference's ``BatchData`` contract."""

    def __init__(self, size: int, load_fn, batch_size: int, input_size: int, gt_size: int,
                 is_training: bool = True):
        self.size = size
        self._load = load_fn
        self.batch_size = batch_size
        self.input_size = input_size
        self.gt_size = gt_size
        self.is_training = is_training

    def _index_stream(self):
        # infinite epochs in both modes, as the reference's RepeatedData(-1)
        rng = np.random.RandomState(_SEED)
        while True:
            order = np.arange(self.size)
            if self.is_training:
                rng.shuffle(order)
            yield from order

    def _batches(self):
        rng = np.random.RandomState(_SEED)
        holder = []
        for i in self._index_stream():
            holder.append(self._load(int(i)))
            if len(holder) == self.batch_size:
                yield self._aggregate(holder, rng)
                holder = []

    def _aggregate(self, holder, rng):
        ids = np.stack([x[0] for x in holder])
        inputs = np.stack([resample_pcd(x[1], self.input_size, rng) for x in holder])
        gts = np.stack([resample_pcd(x[2], self.gt_size, rng) for x in holder])
        return ids, inputs.astype(np.float32), self.input_size, gts.astype(np.float32)

    def __iter__(self):
        """Batches made by a background thread, ``_PREFETCH`` ahead. Closing
        the iterator (or dropping it) stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # never block for good in put: an abandoned iterator sets stop
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._batches():
                    if not put(item):
                        return
            except BaseException as exc:  # re-raised by the consumer
                put(exc)
                return
            put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while (item := q.get()) is not None:
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def synthetic_dataflow(num: int, batch_size: int, input_size: int, output_size: int,
                       is_training: bool = True, seed: int = 0):
    """A dataflow over ``num`` synthetic pairs (partials of 2·input_size
    points, resampled to input_size per batch): returns (df, num)."""
    items = list(synthetic_pairs(num, input_size * 2, output_size, seed))
    df = BatchedDataflow(num, items.__getitem__, batch_size, input_size, output_size,
                         is_training)
    return df, num

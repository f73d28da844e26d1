"""Resampling, the data sources and the training dataflow — copies of the
JAX package's ``rfnet_tpu/data/dataset.py`` (``resample_pcd``,
``synthetic_pairs``, ``dir_source``, the tensorpack LMDB decoding,
``BatchedDataflow``, ``lmdb_dataflow`` and ``synthetic_dataflow``),
producing the same arrays in the same order from the same seeds.

Sources:
  * ``lmdb_dataflow`` — a tensorpack ``LMDBSerializer`` database (the PCN
    training data), read with the pure-Python engine
    :mod:`rfnet_tpu_torch.data.lmdb_pure` and the codec
    :mod:`rfnet_tpu_torch.data.msgpack_lite`: no ``lmdb`` or ``msgpack``
    package is needed;
  * ``dir_source`` — a directory of ``.npz`` files with ``partial``/``gt``
    arrays (``rfnet_tpu_torch.data.convert`` writes them);
  * ``synthetic_pairs`` — deterministic random clouds for tests and benches.
"""

from __future__ import annotations

import os
import queue
import threading
from collections.abc import Iterator

import numpy as np

from rfnet_tpu_torch.data import lmdb_pure, msgpack_lite

_SEED = 1  # the JAX package's BatchedDataflow default
_PREFETCH = 8
PREFETCH_THREAD = "rfnet-prefetch"  # the name of every dataflow's prefetch thread


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


def dir_source(path: str):
    """A directory of .npz files, each with ``partial`` and ``gt`` arrays.
    Returns (ids, load_fn)."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".npz"))
    ids = [os.path.splitext(f)[0] for f in files]

    def load(i: int):
        with np.load(os.path.join(path, files[i])) as z:
            return ids[i], z["partial"], z["gt"]

    return ids, load


def _decode_msgpack_array(obj):
    """One msgpack-numpy array (``{b"nd": True, b"type": dtype str,
    b"shape": [...], b"data": bytes}``, or the same with str keys as an
    older writer packed them) as an ndarray; any other object unchanged."""
    if isinstance(obj, dict):
        for nd_key, type_key, shape_key, data_key in (
            (b"nd", b"type", b"shape", b"data"),
            ("nd", "type", "shape", "data"),
        ):
            if obj.get(nd_key) is True and data_key in obj:
                return np.frombuffer(obj[data_key], dtype=np.dtype(obj[type_key])).reshape(
                    obj[shape_key])
    return obj


def decode_datapoint(raw: bytes):
    """One LMDBSerializer value, a msgpack list ``[id, partial, gt]`` with
    msgpack-numpy arrays: returns (id str, partial (p, 3), gt (g, 3))."""
    dp = [_decode_msgpack_array(x) for x in msgpack_lite.unpackb(raw)]
    ident = dp[0]
    if isinstance(ident, bytes):
        ident = ident.decode("utf-8")
    return ident, np.asarray(dp[1]), np.asarray(dp[2])


def decode_key_list(keys_raw: bytes | None, cursor_keys=None):
    """LMDBSerializer's key order: the msgpack'd list under ``b"__keys__"``;
    where it is absent, cursor order without that meta key."""
    if keys_raw is not None:
        return list(msgpack_lite.unpackb(keys_raw))
    return [k for k in (cursor_keys or []) if k != b"__keys__"]


def _lmdb_items(lmdb_path: str):
    """(size, load_fn) over a tensorpack LMDBSerializer database, a file or a
    directory holding ``data.mdb``."""
    env = lmdb_pure.open(lmdb_path, subdir=os.path.isdir(lmdb_path), readonly=True,
                         lock=False)
    with env.begin() as txn:
        keys = decode_key_list(txn.get(b"__keys__"), (k for k, _ in txn.cursor()))

    def load(i: int):
        key = keys[i]
        if isinstance(key, str):
            key = key.encode("utf-8")
        with env.begin() as txn:
            return decode_datapoint(txn.get(key))

    return len(keys), load


class BatchedDataflow:
    """index stream (a permutation per epoch when training) → this shard's
    indices → resample → batch → background prefetch thread, with the JAX
    package's seeds (1 for the index stream, 1 + 997·shard_id for
    resampling) and depth (8 batches). Shard ``shard_id`` of ``num_shards``
    takes every ``num_shards``-th index of the stream from ``shard_id``, so
    the shards of one step hold the rows of the one-shard stream's step.

    Batches are ``(ids, inputs (b, input_size, 3) f32, input_size,
    gts (b, gt_size, 3) f32)``, the reference's ``BatchData`` contract."""

    def __init__(self, size: int, load_fn, batch_size: int, input_size: int, gt_size: int,
                 is_training: bool = True, shard_id: int = 0, num_shards: int = 1):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} is not one of {num_shards} shards")
        self.size = size
        self._load = load_fn
        self.batch_size = batch_size
        self.input_size = input_size
        self.gt_size = gt_size
        self.is_training = is_training
        self.shard_id = shard_id
        self.num_shards = num_shards

    def _index_stream(self):
        # infinite epochs in both modes, as the reference's RepeatedData(-1)
        rng = np.random.RandomState(_SEED)
        while True:
            order = np.arange(self.size)
            if self.is_training:
                rng.shuffle(order)
            yield from order[self.shard_id :: self.num_shards]

    def _batches(self):
        rng = np.random.RandomState(_SEED + 997 * self.shard_id)
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

        threading.Thread(target=worker, daemon=True, name=PREFETCH_THREAD).start()
        try:
            while (item := q.get()) is not None:
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def lmdb_dataflow(lmdb_path: str, batch_size: int, input_size: int, output_size: int,
                  is_training: bool, shard_id: int = 0, num_shards: int = 1):
    """The reference's entry (``data_util.py:73-87``) over a tensorpack
    LMDBSerializer database: returns (df, size)."""
    size, load = _lmdb_items(lmdb_path)
    return BatchedDataflow(size, load, batch_size, input_size, output_size, is_training,
                           shard_id, num_shards), size


def synthetic_dataflow(num: int, batch_size: int, input_size: int, output_size: int,
                       is_training: bool = True, seed: int = 0, shard_id: int = 0,
                       num_shards: int = 1):
    """A dataflow over ``num`` synthetic pairs (partials of 2·input_size
    points, resampled to input_size per batch): returns (df, num)."""
    items = list(synthetic_pairs(num, input_size * 2, output_size, seed))
    df = BatchedDataflow(num, items.__getitem__, batch_size, input_size, output_size,
                         is_training, shard_id, num_shards)
    return df, num

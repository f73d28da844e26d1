"""Optional Grain-backed input pipeline — a copy of the JAX package's
``rfnet_tpu/data/grain_pipeline.py`` on the port's own ``resample_pcd``.

A drop-in alternative to :class:`rfnet_tpu_torch.data.dataset.BatchedDataflow`
built on `grain` (Google's data loading library), for deployments that want
its worker threads, determinism guarantees and checkpointable iterators.
Produces the same batch contract:
``(ids, inputs (b, in, 3) f32, npts, gts (b, out, 3) f32)``.

grain is imported when a dataflow is built, so the module imports without
it; the built-in threaded dataflow stays the default and needs no package.
"""

from __future__ import annotations

import numpy as np

from rfnet_tpu_torch.data.dataset import resample_pcd


def grain_dataflow(
    items,
    batch_size: int,
    input_size: int,
    gt_size: int,
    is_training: bool = True,
    seed: int = 1,
    shard_id: int = 0,
    num_shards: int = 1,
    prefetch: int = 8,
):
    """Build a grain.MapDataset pipeline over an in-memory/list-like source.

    ``items`` must support len() and [i] -> (id, partial, gt).
    Returns an iterable of batches.
    """
    import grain.python as grain

    class _Source(grain.RandomAccessDataSource):
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            return items[i]

    ds = grain.MapDataset.source(_Source())
    ds = ds[shard_id::num_shards]
    if is_training:
        ds = ds.shuffle(seed=seed)
    ds = ds.repeat()

    rng = np.random.RandomState(seed + 997 * shard_id)

    def prepare(item):
        mid, partial, gt = item
        return (
            mid,
            resample_pcd(np.asarray(partial), input_size, rng).astype(np.float32),
            resample_pcd(np.asarray(gt), gt_size, rng).astype(np.float32),
        )

    ds = ds.map(prepare)
    ds = ds.batch(batch_size, drop_remainder=True)

    def to_contract(batch):
        ids, inputs, gts = batch
        return np.asarray(ids), np.stack(inputs) if isinstance(inputs, list) else inputs, input_size, (
            np.stack(gts) if isinstance(gts, list) else gts
        )

    it = ds.to_iter_dataset(
        grain.ReadOptions(prefetch_buffer_size=prefetch) if prefetch else None
    )

    def gen():
        for batch in it:
            yield to_contract(batch)

    return gen()

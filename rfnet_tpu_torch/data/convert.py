"""Dataset conversion: PCN LMDB ↔ .npz directory, and .pcd directory → .npz.

A copy of the JAX package's ``rfnet_tpu/data/convert.py`` on the port's own
LMDB engine (:mod:`rfnet_tpu_torch.data.lmdb_pure`) and msgpack codec
(:mod:`rfnet_tpu_torch.data.msgpack_lite`): for the same datapoints it writes
the same LMDB bytes as the JAX converter. The npz format stores ``partial``
and ``gt`` float32 arrays per model, named ``<synset>__<model>.npz`` (the
'/' of PCN ids is encoded as '__').

``to_lmdb`` writes a tensorpack-``LMDBSerializer``-layout database (msgpack
values with msgpack-numpy array dicts, the ordered key list under
``__keys__``: the format ``data_util.py:73-87`` reads) from an .npz
directory.

Usage:
    python -m rfnet_tpu_torch.data.convert lmdb     train.lmdb out_dir/
    python -m rfnet_tpu_torch.data.convert pcds     list.txt data_dir/ out_dir/
    python -m rfnet_tpu_torch.data.convert to_lmdb  npz_dir/ out.lmdb
"""

from __future__ import annotations

import os
import sys

import numpy as np

from rfnet_tpu_torch.data import msgpack_lite
from rfnet_tpu_torch.data.dataset import _lmdb_items, dir_source
from rfnet_tpu_torch.data.lmdb_pure import write_lmdb
from rfnet_tpu_torch.data.pcd_io import read_pcd


def convert_lmdb(lmdb_path: str, out_dir: str) -> int:
    size, load = _lmdb_items(lmdb_path)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(size):
        mid, partial, gt = load(i)
        name = str(mid).replace("/", "__")
        np.savez_compressed(os.path.join(out_dir, f"{name}.npz"),
                            partial=np.asarray(partial, np.float32),
                            gt=np.asarray(gt, np.float32))
    return size


def encode_msgpack_array(arr: np.ndarray) -> dict:
    """msgpack-numpy wire layout (inverse of dataset._decode_msgpack_array)."""
    arr = np.ascontiguousarray(arr)
    return {b"nd": True, b"type": arr.dtype.str, b"shape": list(arr.shape),
            b"data": arr.tobytes()}


def encode_datapoint(ident: str, partial: np.ndarray, gt: np.ndarray) -> bytes:
    """Inverse of dataset.decode_datapoint: one LMDBSerializer value."""
    return msgpack_lite.packb([ident.encode("utf-8"), encode_msgpack_array(partial),
                               encode_msgpack_array(gt)])


def write_tensorpack_lmdb(path: str, triples, subdir: bool = False) -> int:
    """Write (id, partial, gt) triples as a tensorpack-LMDBSerializer-layout
    database: datapoints keyed by id, plus the ordered ``__keys__`` list.
    Returns the number of datapoints."""
    keys, items = [], []
    for ident, partial, gt in triples:
        key = ident.encode("utf-8")
        keys.append(key)
        items.append((key, encode_datapoint(ident, partial, gt)))
    items.append((b"__keys__", msgpack_lite.packb(keys)))
    write_lmdb(path, items, subdir=subdir)
    return len(keys)


def convert_npz_to_lmdb(npz_dir: str, out_path: str) -> int:
    ids, load = dir_source(npz_dir)

    def triples():
        for i in range(len(ids)):
            name, partial, gt = load(i)
            yield name.replace("__", "/"), partial, gt

    return write_tensorpack_lmdb(out_path, triples())


def convert_pcds(list_path: str, data_dir: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    with open(list_path) as f:
        ids = f.read().splitlines()
    for mid in ids:
        partial = read_pcd(os.path.join(data_dir, "partial", f"{mid}.pcd"))
        gt = read_pcd(os.path.join(data_dir, "complete", f"{mid}.pcd"))
        np.savez_compressed(os.path.join(out_dir, mid.replace("/", "__") + ".npz"),
                            partial=partial.astype(np.float32), gt=gt.astype(np.float32))
    return len(ids)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    if argv[0] == "lmdb":
        n = convert_lmdb(argv[1], argv[2])
    elif argv[0] == "to_lmdb":
        n = convert_npz_to_lmdb(argv[1], argv[2])
    elif argv[0] == "pcds":
        n = convert_pcds(argv[1], argv[2], argv[3])
    else:
        print(__doc__)
        return 1
    print(f"converted {n} models")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

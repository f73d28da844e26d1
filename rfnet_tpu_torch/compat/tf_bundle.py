"""Pure-Python TensorFlow TensorBundle checkpoint codec — the port's own
copy of the JAX package's ``rfnet_tpu/compat/tf_bundle.py`` (numpy only; the
port imports nothing of that package). Its writer gives the same bytes as
that one on the same tensors.

The reference trains with TF1 ``tf.train.Saver`` (`vv_recon.py:461-550`),
whose on-disk format is a *TensorBundle*: a ``<prefix>.index`` file — a
leveldb/SSTable mapping variable names to ``BundleEntryProto`` records —
plus ``<prefix>.data-NNNNN-of-MMMMM`` shard file(s) of raw little-endian
tensor bytes. This module reads and writes that format without TensorFlow,
so reference users can carry trained weights in either direction (see
:mod:`rfnet_tpu_torch.compat.ref_import`).

Format notes (verified against `bestrecord/model-229999.index` in the
reference checkout):

* SSTable: sequence of blocks; each block is entries with key prefix
  compression (``varint shared, varint non_shared, varint value_len, key
  bytes, value bytes``) followed by a u32 restart-offset array and a u32
  restart count. Each block is stored as ``content + 1-byte compression
  type (0 = raw) + 4-byte masked crc32c``. The 48-byte footer holds the
  metaindex and index BlockHandles (varint offset/size pairs) and the magic
  ``0xdb4775248b80fb57``. The index block's values are BlockHandles of the
  data blocks.
* Key ``""`` (first entry) holds a ``BundleHeaderProto`` (num_shards,
  endianness, version); every other key is a tensor name with a
  ``BundleEntryProto`` value (dtype, shape, shard_id, offset, size,
  crc32c of the raw bytes).
* The writer emits a single uncompressed data block, a single shard, and
  correct masked crc32c everywhere, which both this reader and TF's
  ``BundleReader`` accept.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57
_CRC_MASK_DELTA = 0xA282EAD8

# TF DataType enum -> numpy (the subset that appears in model checkpoints)
DTYPES = {
    1: np.dtype("float32"),
    2: np.dtype("float64"),
    3: np.dtype("int32"),
    4: np.dtype("uint8"),
    6: np.dtype("int8"),
    9: np.dtype("int64"),
    14: np.dtype("uint16"),  # bfloat16 is 14 in TF; stored as raw u16 here
    19: np.dtype("float16"),
}
DTYPE_CODES = {v: k for k, v in DTYPES.items() if k != 14}


# --------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — needed for block and tensor checksums.
# --------------------------------------------------------------------------

def _make_crc_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


# a buffer of at least _LANES * _MIN_LANE bytes is checksummed in _LANES
# lanes at once with numpy (the byte loop takes seconds on the full-size
# model's 15 MB)
_LANES = 1024
_MIN_LANE = 16


def _crc_register(reg: int, data: bytes) -> int:
    for b in data:
        reg = _CRC_TABLE[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def crc32c(data: bytes, crc: int = 0) -> int:
    """crc32c of ``data``, continuing from ``crc``.

    The register's update is linear over GF(2): the register after a run of
    bytes is the register before it carried over as many zero bytes, XOR the
    register of the run from zero. So equal lanes of a long buffer are run
    side by side from zero (the first from the incoming register), and
    folded in order, each fold carrying the sum so far over one lane of zero
    bytes through the images of the register's 32 bits; the tail that does
    not fill a lane runs byte by byte. The result is the byte loop's."""
    reg = crc ^ 0xFFFFFFFF
    n = len(data) // _LANES
    if n >= _MIN_LANE:
        table = np.asarray(_CRC_TABLE, dtype=np.uint32)
        lanes = np.frombuffer(data, np.uint8, count=n * _LANES).reshape(_LANES, n).T.copy()
        regs = np.zeros(_LANES, dtype=np.uint32)
        regs[0] = reg
        for column in lanes:
            regs = table[(regs ^ column) & 0xFF] ^ (regs >> 8)
        images = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
        for _ in range(n):
            images = table[images & 0xFF] ^ (images >> 8)
        images = images.tolist()
        regs = regs.tolist()
        reg = regs[0]
        for lane in regs[1:]:
            carried = 0
            for bit in range(32):
                if reg >> bit & 1:
                    carried ^= images[bit]
            reg = carried ^ lane
        data = data[n * _LANES:]
    return _crc_register(reg, data) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA & 0xFFFFFFFF


# --------------------------------------------------------------------------
# varint / protobuf primitives
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _pb_tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _pb_varint_field(field: int, value: int) -> bytes:
    return _pb_tag(field, 0) + _write_varint(value)


def _pb_bytes_field(field: int, payload: bytes) -> bytes:
    return _pb_tag(field, 2) + _write_varint(len(payload)) + payload


def _pb_scan(buf: bytes):
    """Yield (field, wire, value) where value is int (wire 0/5) or bytes."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            v = struct.unpack("<I", buf[pos : pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<Q", buf[pos : pos + 8])[0]
            pos += 8
        else:  # pragma: no cover - groups don't occur in bundle protos
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


# --------------------------------------------------------------------------
# SSTable reading
# --------------------------------------------------------------------------

def _read_handle(buf: bytes, pos: int):
    off, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (off, size), pos


def _read_table_block(data: bytes, handle):
    off, size = handle
    raw = data[off : off + size]
    ctype = data[off + size]
    if ctype != 0:
        raise NotImplementedError(
            f"compressed SSTable block (type {ctype}); TF writes bundle "
            "indexes uncompressed — unsupported input"
        )
    return raw


def _block_entries(block: bytes):
    (n_restarts,) = struct.unpack("<I", block[-4:])
    end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _table_entries(data: bytes):
    if struct.unpack("<Q", data[-8:])[0] != _TABLE_MAGIC:
        raise ValueError("not an SSTable: bad magic (is this a .index file?)")
    footer = data[-48:-8]
    _metaindex, pos = _read_handle(footer, 0)
    index_handle, pos = _read_handle(footer, pos)
    for _key, value in _block_entries(_read_table_block(data, index_handle)):
        handle, _ = _read_handle(value, 0)
        yield from _block_entries(_read_table_block(data, handle))


# --------------------------------------------------------------------------
# Bundle protos
# --------------------------------------------------------------------------

@dataclass
class BundleEntry:
    """One tensor's metadata from the bundle index."""

    dtype: int  # TF DataType enum value
    shape: tuple
    shard_id: int
    offset: int
    size: int
    crc: int

    @property
    def np_dtype(self):
        try:
            return DTYPES[self.dtype]
        except KeyError:
            raise NotImplementedError(f"TF dtype enum {self.dtype}") from None


def _parse_shape(buf: bytes) -> tuple:
    dims = []
    for field, _wire, v in _pb_scan(buf):
        if field == 2:  # TensorShapeProto.Dim
            size = 0
            for f2, _w2, v2 in _pb_scan(v):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _encode_shape(shape) -> bytes:
    out = b""
    for dim in shape:
        out += _pb_bytes_field(2, _pb_varint_field(1, int(dim)))
    return out


def _parse_entry(buf: bytes) -> BundleEntry:
    e = BundleEntry(dtype=0, shape=(), shard_id=0, offset=0, size=0, crc=0)
    for field, wire, v in _pb_scan(buf):
        if field == 1 and wire == 0:
            e.dtype = v
        elif field == 2 and wire == 2:
            e.shape = _parse_shape(v)
        elif field == 3 and wire == 0:
            e.shard_id = v
        elif field == 4 and wire == 0:
            e.offset = v
        elif field == 5 and wire == 0:
            e.size = v
        elif field == 6 and wire == 5:
            e.crc = v
    return e


def _parse_header(buf: bytes):
    num_shards = 1
    for field, wire, v in _pb_scan(buf):
        if field == 1 and wire == 0:
            num_shards = v
    return num_shards


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def read_index(index_path: str):
    """Parse ``<prefix>.index`` → (num_shards, {name: BundleEntry})."""
    with open(index_path, "rb") as f:
        data = f.read()
    entries = {}
    num_shards = 1
    for key, value in _table_entries(data):
        if key == b"":
            num_shards = _parse_header(value)
        else:
            entries[key.decode("utf-8")] = _parse_entry(value)
    return num_shards, entries


def read_bundle(prefix: str, names=None):
    """Load tensors from a TF checkpoint bundle → {name: np.ndarray}.

    ``prefix`` is the checkpoint path without extension (e.g.
    ``.../model-229999``). ``names`` optionally restricts which tensors are
    materialized. Verifies each tensor's stored crc32c.
    """
    num_shards, entries = read_index(prefix + ".index")
    shards = {}
    out = {}
    for name, e in entries.items():
        if names is not None and name not in names:
            continue
        if e.shard_id not in shards:
            path = f"{prefix}.data-{e.shard_id:05d}-of-{num_shards:05d}"
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"bundle shard missing: {path} (the reference checkout "
                    "ships only the .index — a full checkpoint is required "
                    "to load tensor values)"
                )
            with open(path, "rb") as f:
                shards[e.shard_id] = f.read()
        raw = shards[e.shard_id][e.offset : e.offset + e.size]
        if len(raw) != e.size:
            raise ValueError(f"{name}: truncated shard data")
        if e.crc and masked_crc32c(raw) != e.crc:
            raise ValueError(f"{name}: tensor data crc32c mismatch")
        arr = np.frombuffer(raw, dtype=e.np_dtype)
        out[name] = arr.reshape(e.shape) if e.shape else arr[0]
    return out


def _encode_block(items) -> bytes:
    """One SSTable block, no prefix compression (restart at every entry —
    simple and always-correct; index size is irrelevant at our scale)."""
    out = bytearray()
    restarts = []
    for key, value in items:
        restarts.append(len(out))
        out += _write_varint(0)  # shared
        out += _write_varint(len(key))
        out += _write_varint(len(value))
        out += key + value
    for r in restarts or [0]:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts) or 1)
    return bytes(out)


class _TableWriter:
    def __init__(self):
        self.buf = bytearray()

    def add_block(self, block: bytes):
        handle = _write_varint(len(self.buf)) + _write_varint(len(block))
        self.buf += block
        self.buf += b"\x00"  # compression type: none
        self.buf += struct.pack("<I", masked_crc32c(block + b"\x00"))
        return handle

    def finish(self, metaindex_handle: bytes, index_handle: bytes) -> bytes:
        footer = metaindex_handle + index_handle
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        return bytes(self.buf) + footer


def write_bundle(prefix: str, tensors: dict):
    """Write ``{name: np.ndarray}`` as a single-shard TF checkpoint bundle
    (``<prefix>.index`` + ``<prefix>.data-00000-of-00001``) that TF's
    ``BundleReader``/``tf.train.load_checkpoint`` can read back."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    data = bytearray()
    index_items = []
    header = _pb_varint_field(1, 1) + _pb_bytes_field(3, _pb_varint_field(1, 1))
    index_items.append((b"", header))
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in DTYPE_CODES:
            raise NotImplementedError(f"{name}: unsupported dtype {arr.dtype}")
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        entry = (
            _pb_varint_field(1, DTYPE_CODES[arr.dtype])
            + _pb_bytes_field(2, _encode_shape(arr.shape))
            + _pb_varint_field(4, len(data))
            + _pb_varint_field(5, len(raw))
            + _pb_tag(6, 5)
            + struct.pack("<I", masked_crc32c(raw))
        )
        data += raw
        index_items.append((name.encode("utf-8"), entry))

    writer = _TableWriter()
    data_handle = writer.add_block(_encode_block(index_items))
    meta_handle = writer.add_block(_encode_block([]))
    # the index key must compare >= the data block's last key (leveldb
    # binary-search invariant) — reuse the last key itself
    last_key = index_items[-1][0]
    index_handle = writer.add_block(_encode_block([(last_key, data_handle)]))
    table = writer.finish(meta_handle, index_handle)

    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
    with open(prefix + ".index", "wb") as f:
        f.write(table)

"""A msgpack codec for the subset tensorpack's ``LMDBSerializer`` writes.

The PCN training databases hold each datapoint as ``msgpack.packb([id,
partial, gt], use_bin_type=True)`` with msgpack-numpy's array dicts
(``{b"nd": True, b"type": "<f4", b"shape": [n, 3], b"data": <bytes>}``),
and the ordered key list under ``b"__keys__"``. This module reads and writes
that subset with no ``msgpack`` package (the card's machine has none):

* nil, bool, int (fixint, int8-64, uint8-64), float32 and float64, str
  (fixstr, str8/16/32, UTF-8), bin (bin8/16/32), array and map;
* ``unpackb(data)`` decodes as ``msgpack.unpackb(data, raw=False,
  strict_map_key=False)`` does: str to ``str``, bin to ``bytes``, arrays to
  lists, maps to dicts (so the old raw-str keys ``"nd"`` of msgpack-numpy
  arrays packed without ``use_bin_type`` come back as ``str``);
* ``packb(obj)`` encodes as ``msgpack.packb(obj, use_bin_type=True)`` does,
  byte for byte: the narrowest int format, str8 for 32-255 bytes, floats as
  float64, tuples as arrays.

Any other type or format byte (ext, timestamps) raises ``ValueError``, as
does a truncated buffer or bytes left after the object.
"""

from __future__ import annotations

import struct

_INT_FORMATS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported subset."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix_base: int | None, fix_max: int, codes) -> None:
    """A length header: a fix form below ``fix_max``, else the 8/16/32-bit
    ``codes`` (None where the family has no such width)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} exceeds 2**32 - 1")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -0x20 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
            return
        for code, lo, hi in ((0xCC, 0x80, 0xFF), (0xD0, -0x80, -1), (0xCD, 0, 0xFFFF),
                             (0xD1, -0x8000, -1), (0xCE, 0, 0xFFFFFFFF),
                             (0xD2, -0x80000000, -1), (0xCF, 0, 0xFFFFFFFFFFFFFFFF),
                             (0xD3, -0x8000000000000000, -1)):
            if lo <= obj <= hi:
                out.append(code)
                out += struct.pack(_INT_FORMATS[code], obj)
                return
        raise ValueError(f"msgpack: integer {obj} does not fit 64 bits")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise ValueError(f"msgpack: cannot pack an object of type {type(obj).__name__}")


def unpackb(data) -> object:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)`` for the
    supported subset."""
    buf = bytes(data)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} bytes left after the object")
    return obj


def _take(buf: bytes, pos: int, n: int) -> tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated buffer")
    return buf[pos:pos + n], pos + n


def _number(buf: bytes, pos: int, fmt: str):
    raw, pos = _take(buf, pos, struct.calcsize(fmt))
    return struct.unpack(fmt, raw)[0], pos


def _unpack(buf: bytes, pos: int):
    head, pos = _take(buf, pos, 1)
    c = head[0]
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(buf, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F)
    if c == 0xC0:
        return None, pos
    if c in (0xC2, 0xC3):
        return c == 0xC3, pos
    if c in _INT_FORMATS:
        return _number(buf, pos, _INT_FORMATS[c])
    if c == 0xCA:
        return _number(buf, pos, ">f")
    if c == 0xCB:
        return _number(buf, pos, ">d")
    widths = {0: ">B", 1: ">H", 2: ">I"}
    if c in (0xD9, 0xDA, 0xDB):
        n, pos = _number(buf, pos, widths[c - 0xD9])
        return _str(buf, pos, n)
    if c in (0xC4, 0xC5, 0xC6):
        n, pos = _number(buf, pos, widths[c - 0xC4])
        return _take(buf, pos, n)
    if c in (0xDC, 0xDD):
        n, pos = _number(buf, pos, widths[c - 0xDC + 1])
        return _array(buf, pos, n)
    if c in (0xDE, 0xDF):
        n, pos = _number(buf, pos, widths[c - 0xDE + 1])
        return _map(buf, pos, n)
    raise ValueError(f"msgpack: unsupported format byte {c:#04x}")


def _str(buf: bytes, pos: int, n: int):
    raw, pos = _take(buf, pos, n)
    return raw.decode("utf-8"), pos


def _array(buf: bytes, pos: int, n: int):
    items = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        items.append(item)
    return items, pos


def _map(buf: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        value, pos = _unpack(buf, pos)
        try:
            out[key] = value
        except TypeError:
            raise ValueError(f"msgpack: unhashable map key {key!r}") from None
    return out, pos

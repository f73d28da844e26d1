"""Point Cloud Data (.pcd) file I/O — pure numpy.

A copy of the JAX package's numpy codec (``rfnet_tpu/data/pcd_io.py``:
``_read_pcd_py``, ``save_pcd``), kept here so the port imports nothing of
that package. Reads ascii, binary and binary_compressed xyz clouds; writes
ascii with 9 significant digits, which round-trips float32 exactly.
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4", ("U", 4): "u4",
           ("I", 1): "i1", ("U", 1): "u1", ("I", 2): "i2", ("U", 2): "u2"}


def read_pcd(filename: str) -> np.ndarray:
    """Read a .pcd file, returning the (n, 3) xyz float64 array."""
    with open(filename, "rb") as f:
        header = {}
        while True:
            raw_line = f.readline()
            if not raw_line:
                raise ValueError(f"{filename}: no DATA line in the PCD header")
            line = raw_line.decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        npts = int(header["POINTS"])
        fmt = header["DATA"]

        np_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            dt = _DTYPES[(t, s)]
            np_fields.append((name, dt) if c == 1 else (name, dt, (c,)))
        dtype = np.dtype(np_fields)

        if fmt == "ascii":
            data = np.atleast_2d(np.loadtxt(f, dtype=np.float64, max_rows=npts))
            col = {name: i for i, name in enumerate(fields)}
            xyz = data[:, [col["x"], col["y"], col["z"]]]
        elif fmt == "binary":
            rec = np.frombuffer(f.read(dtype.itemsize * npts), dtype=dtype, count=npts)
            xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
        elif fmt == "binary_compressed":
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = _lzf_decompress(f.read(comp_size), uncomp_size)
            # compressed PCD stores fields SOA-style
            cols = {}
            offset = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                if name in ("x", "y", "z"):
                    cols[name] = np.frombuffer(raw, dtype=_DTYPES[(t, s)], count=npts, offset=offset)
                offset += s * c * npts
            xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        else:
            raise ValueError(f"unsupported PCD DATA format: {fmt}")
    return np.ascontiguousarray(xyz, dtype=np.float64)


def save_pcd(filename: str, points: np.ndarray) -> None:
    """Write an (n, 3) array as an ascii .pcd file."""
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
    )
    with open(filename, "w") as f:
        f.write(header)
        np.savetxt(f, pts, fmt="%.9g")


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Minimal LZF decompressor (PCL's binary_compressed codec)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)

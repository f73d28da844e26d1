"""Pure-Python LMDB storage engine (read + bulk write), no C dependency.

A copy of the JAX package's ``rfnet_tpu/data/lmdb_pure.py``, kept here so
the port imports nothing of that package. The PCN dataset comes as
tensorpack ``LMDBSerializer`` databases, i.e. plain LMDB files, and neither
machine the port runs on has the ``lmdb`` C package, so the port always
reads them through this module. It implements the LMDB **on-disk format**
that liblmdb 0.9.x writes (format constant ``MDB_DATA_VERSION = 1``,
unchanged since 2011):

* meta pages 0 and 1, live one chosen by larger ``mm_txnid``; the page size
  lives in the FREE-db's ``md_pad`` field (``mm_psize`` alias in mdb.c);
* 16-byte page headers (64-bit pgno), ``mp_ptrs`` index arrays growing up
  from the header and even-aligned nodes growing down from the page end;
* 8-byte node headers ``(lo, hi, flags, ksize)``; leaf data size =
  ``lo | hi<<16``; branch child pgno = ``lo | hi<<16 | flags<<32``; the key
  of branch node 0 is ignored by search (mdb.c ``mdb_node_search`` starts the
  branch binary search at index 1);
* values with ``8 + klen + dlen > nodemax`` (2040 @ 4 KiB pages) go to
  contiguous ``P_OVERFLOW`` page runs (``F_BIGDATA`` node holds the pgno).

Scope: the read side covers everything a tensorpack database uses (single
main DB, no DUPSORT, no LEAF2); unsupported page/node kinds raise instead of
misreading. The write side is a bulk builder (sorted insert, one commit) that
packs leaves exactly like liblmdb's append-mode ``mdb_node_add`` so the
resulting file is readable by liblmdb itself; it writes the same bytes as
the JAX package's writer for the same items, and serves fixtures and
``rfnet_tpu_torch.data.convert``.

The public ``open()`` mirrors the subset of the ``lmdb`` package API that
``rfnet_tpu_torch.data.dataset._lmdb_items`` touches.

Caveat: files produced by this writer are self-made; byte-level
compatibility with liblmdb-written files follows from the format spec
above, not from a cross-check against the C library.
"""

from __future__ import annotations

import builtins
import io
import os
import struct

_open_file = builtins.open  # module-level `open` below shadows the builtin

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
PAGEHDRSZ = 16
NODESZ = 8
P_INVALID = 0xFFFFFFFFFFFFFFFF

# page flags (mdb.c)
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
P_SUBP = 0x40

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

# env/db flags we stamp on write (readers ignore them)
MDB_INTEGERKEY = 0x08
MDB_NOSUBDIR = 0x4000


def _even(x: int) -> int:
    return (x + 1) & ~1


def _nodemax(psize: int) -> int:
    # mdb.c: me_nodemax = ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2
    return ((psize - PAGEHDRSZ) // 2) & ~1


def _ovpages(dsize: int, psize: int) -> int:
    return (PAGEHDRSZ + dsize + psize - 1) // psize


def _data_path(path: str, subdir: bool) -> str:
    return os.path.join(path, "data.mdb") if subdir else path


class LmdbFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

_META = struct.Struct("<IIQQ" + "IHHQQQQQ" * 2 + "QQ")  # magic..txnid
_PGHDR = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")  # lo, hi, flags, ksize


class _Db:
    __slots__ = ("pad", "flags", "depth", "branch", "leaf", "overflow",
                 "entries", "root")

    def __init__(self, vals):
        (self.pad, self.flags, self.depth, self.branch, self.leaf,
         self.overflow, self.entries, self.root) = vals


class Transaction:
    """Read-only snapshot. Also a context manager (``with env.begin():``)."""

    def __init__(self, env: "Environment"):
        self._env = env

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # -- lmdb-package-compatible surface --

    def get(self, key: bytes, default=None):
        env = self._env
        pgno = env._main.root
        if pgno == P_INVALID:
            return default
        for _depth in range(64):  # liblmdb trees are <32 deep; cycles raise
            flags, nodes, page_off = env._page(pgno)
            if not nodes:
                if flags & P_BRANCH:  # valid branches have >= 2 children
                    raise LmdbFormatError("empty branch page (corrupt file?)")
                return default
            if flags & P_LEAF:
                lo, hi = 0, len(nodes) - 1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    k, _ = env._leaf_node(page_off, nodes[mid], want_data=False)
                    if k == key:
                        return env._leaf_node(page_off, nodes[mid])[1]
                    if k < key:
                        lo = mid + 1
                    else:
                        hi = mid - 1
                return default
            # branch: rightmost node (index >= 1) with node_key <= key,
            # else node 0 (whose key is ignored — mdb_node_search low=1)
            child_i = 0
            lo, hi = 1, len(nodes) - 1
            while lo <= hi:
                mid = (lo + hi) // 2
                k = env._branch_key(page_off, nodes[mid])
                if k <= key:
                    child_i = mid
                    lo = mid + 1
                else:
                    hi = mid - 1
            pgno = env._branch_pgno(page_off, nodes[child_i])
        raise LmdbFormatError("B-tree deeper than 64 levels (corrupt file?)")

    def cursor(self):
        """Iterate (key, value) in key order over the whole main DB."""
        return self._env._iter_tree(self._env._main.root)

    def stat(self):
        db = self._env._main
        return {
            "psize": self._env.psize, "depth": db.depth,
            "branch_pages": db.branch, "leaf_pages": db.leaf,
            "overflow_pages": db.overflow, "entries": db.entries,
        }


class Environment:
    def __init__(self, path: str, subdir: bool):
        self.path = path
        data = _data_path(path, subdir)
        self._f = _open_file(data, "rb")
        self._pick_meta()

    # -- lmdb-package-compatible surface --

    def begin(self) -> Transaction:
        return Transaction(self)

    def stat(self):
        return self.begin().stat()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- format internals --

    def _pick_meta(self):
        # psize is not knowable before parsing a meta; metas live at 0 and
        # psize, so read a generous prefix and locate the second meta using
        # the first one's recorded psize (liblmdb does the same dance with
        # its compiled-in default then trusts mm_psize).
        self._f.seek(0)
        head = self._f.read(1 << 16)
        metas = []
        m0 = self._parse_meta(head, 0)
        if m0:
            metas.append(m0)
            psize_hint = m0[0]
        else:
            psize_hint = 4096
        m1 = self._parse_meta(head, psize_hint)
        if m1:
            metas.append(m1)
        if not metas:
            raise LmdbFormatError(f"{self.path}: no valid LMDB meta page")
        psize, main, txnid, last_pg = max(metas, key=lambda m: m[2])
        self.psize = psize
        self._main = main
        self.txnid = txnid
        self.last_pg = last_pg

    @staticmethod
    def _parse_meta(buf: bytes, off: int):
        if len(buf) < off + PAGEHDRSZ + _META.size:
            return None
        pgno, _pad, flags, _lo, _up = _PGHDR.unpack_from(buf, off)
        if not flags & P_META:
            return None
        v = _META.unpack_from(buf, off + PAGEHDRSZ)
        magic, version = v[0], v[1]
        if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
            return None
        free_db = _Db(v[4:12])
        main_db = _Db(v[12:20])
        last_pg, txnid = v[20], v[21]
        psize = free_db.pad  # mm_psize lives in the FREE db's md_pad
        if psize < 512 or psize & (psize - 1):
            return None
        return psize, main_db, txnid, last_pg

    def _read_page(self, pgno: int) -> bytes:
        self._f.seek(pgno * self.psize)
        page = self._f.read(self.psize)
        if len(page) != self.psize:
            raise LmdbFormatError(f"short read at page {pgno}")
        return page

    def _page(self, pgno: int):
        """Return (flags, node_offsets, page_bytes) for a branch/leaf page."""
        page = self._read_page(pgno)
        _pg, _pad, flags, lower, _upper = _PGHDR.unpack_from(page, 0)
        if flags & (P_LEAF2 | P_SUBP) or flags & P_OVERFLOW:
            raise LmdbFormatError(
                f"page {pgno}: unsupported page flags {flags:#x} "
                "(DUPFIXED/DUPSORT databases are out of scope)"
            )
        if not flags & (P_LEAF | P_BRANCH):
            raise LmdbFormatError(f"page {pgno}: not a data page ({flags:#x})")
        nkeys = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ)
        return flags, ptrs, page

    def _leaf_node(self, page: bytes, off: int, want_data: bool = True):
        lo, hi, nflags, ksize = _NODEHDR.unpack_from(page, off)
        if nflags & (F_SUBDATA | F_DUPDATA):
            raise LmdbFormatError("DUPSORT node encountered (unsupported)")
        key = page[off + NODESZ : off + NODESZ + ksize]
        if not want_data:
            return key, None
        dsize = lo | (hi << 16)
        dstart = off + NODESZ + ksize
        if nflags & F_BIGDATA:
            (ovpgno,) = struct.unpack_from("<Q", page, dstart)
            return key, self._read_overflow(ovpgno, dsize)
        return key, page[dstart : dstart + dsize]

    def _branch_key(self, page: bytes, off: int) -> bytes:
        _lo, _hi, _fl, ksize = _NODEHDR.unpack_from(page, off)
        return page[off + NODESZ : off + NODESZ + ksize]

    @staticmethod
    def _branch_pgno(page: bytes, off: int) -> int:
        lo, hi, fl, _ks = _NODEHDR.unpack_from(page, off)
        return lo | (hi << 16) | (fl << 32)

    def _read_overflow(self, pgno: int, dsize: int) -> bytes:
        head = self._read_page(pgno)
        _pg, _pad, flags, _lo, _up = _PGHDR.unpack_from(head, 0)
        if not flags & P_OVERFLOW:
            raise LmdbFormatError(f"page {pgno}: expected overflow page")
        (npages,) = struct.unpack_from("<I", head, 12)
        need = _ovpages(dsize, self.psize)
        if npages < need:
            raise LmdbFormatError(
                f"overflow run at {pgno}: {npages} pages < required {need}"
            )
        # data is contiguous from byte PAGEHDRSZ of the first overflow page
        self._f.seek(pgno * self.psize + PAGEHDRSZ)
        data = self._f.read(dsize)
        if len(data) != dsize:
            raise LmdbFormatError(f"short overflow read at page {pgno}")
        return data

    def _iter_tree(self, pgno: int, _visited: set | None = None):
        if pgno == P_INVALID:
            return
        visited = _visited if _visited is not None else set()
        if pgno in visited:  # corrupt files must fail, not loop
            raise LmdbFormatError(f"B-tree cycle through page {pgno}")
        visited.add(pgno)
        flags, ptrs, page = self._page(pgno)
        if flags & P_LEAF:
            for off in ptrs:
                yield self._leaf_node(page, off)
            return
        children = [self._branch_pgno(page, off) for off in ptrs]
        for child in children:
            yield from self._iter_tree(child, visited)


def open(path: str, subdir: bool = True, readonly: bool = True,
         lock: bool = False, **_ignored) -> Environment:
    """`lmdb.open`-shaped constructor (read-only subset)."""
    if not readonly:
        raise NotImplementedError(
            "lmdb_pure opens read-only; use write_lmdb() for bulk creation"
        )
    del lock  # no lock file participation: single-writer files, done writing
    return Environment(path, subdir=subdir)


# ---------------------------------------------------------------------------
# Bulk writer
# ---------------------------------------------------------------------------


class _PageBuilder:
    """Packs one branch/leaf page exactly like mdb_node_add: ptr slots grow
    up from the header, even-aligned nodes grow down from psize."""

    def __init__(self, psize: int, is_leaf: bool):
        self.psize = psize
        self.is_leaf = is_leaf
        self.upper = psize
        self.nodes: list[bytes] = []  # node bytes, key order
        self.offs: list[int] = []
        self.first_key: bytes | None = None

    def space_left(self) -> int:
        lower = PAGEHDRSZ + 2 * len(self.nodes)
        return self.upper - lower

    def fits(self, node_size: int) -> bool:
        return node_size + 2 <= self.space_left()

    def add(self, node: bytes, key: bytes):
        size = _even(len(node))
        self.upper -= size
        self.offs.append(self.upper)
        self.nodes.append(node)
        if self.first_key is None:
            self.first_key = key

    def render(self, pgno: int) -> bytes:
        flags = P_LEAF if self.is_leaf else P_BRANCH
        lower = PAGEHDRSZ + 2 * len(self.nodes)
        page = bytearray(self.psize)
        _PGHDR.pack_into(page, 0, pgno, 0, flags, lower, self.upper)
        struct.pack_into(f"<{len(self.offs)}H", page, PAGEHDRSZ, *self.offs)
        for off, node in zip(self.offs, self.nodes):
            page[off : off + len(node)] = node
        return bytes(page)


def _leaf_node_bytes(key: bytes, value: bytes, psize: int):
    """Returns (node_bytes, overflow_payload_or_None)."""
    if NODESZ + len(key) + len(value) > _nodemax(psize):
        hdr = _NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16,
                            F_BIGDATA, len(key))
        # 8-byte overflow pgno is appended by the caller once known
        return hdr + key, value
    hdr = _NODEHDR.pack(len(value) & 0xFFFF, len(value) >> 16, 0, len(key))
    return hdr + key + value, None


def _branch_node_bytes(key: bytes, pgno: int) -> bytes:
    hdr = _NODEHDR.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                        (pgno >> 32) & 0xFFFF, len(key))
    return hdr + key


def write_lmdb(path: str, items, subdir: bool = False,
               psize: int = 4096) -> dict:
    """Create an LMDB file from (key, value) byte pairs (any order; sorted
    internally — LMDB's key order is plain memcmp). Keys must be unique:
    without MDB_DUPSORT (out of scope) duplicates would shadow each other,
    so they raise ValueError. One transaction, txnid 1. Returns the main-DB
    stat dict."""
    pairs = sorted(items)
    for i, (k, v) in enumerate(pairs):
        if not isinstance(k, bytes) or not isinstance(v, bytes):
            raise TypeError("keys and values must be bytes")
        if not 0 < len(k) <= 511:
            raise ValueError(f"key length {len(k)} outside LMDB's 1..511")
        if i and pairs[i - 1][0] == k:
            # without MDB_DUPSORT (out of scope) LMDB keys are unique; two
            # equal keys would silently shadow each other in search
            raise ValueError(f"duplicate key {k!r}")

    if subdir:
        os.makedirs(path, exist_ok=True)
    out = io.BytesIO()
    out.write(b"\0" * (2 * psize))  # meta pages, filled in last
    next_pg = 2
    counts = {"branch": 0, "leaf": 0, "overflow": 0}

    def emit(page_bytes: bytes) -> int:
        nonlocal next_pg
        pgno = next_pg
        next_pg += len(page_bytes) // psize
        out.write(page_bytes)
        return pgno

    # ---- leaf level (overflow runs interleaved, as append-mode would) ----
    level: list[tuple[bytes, int]] = []  # (first_key, pgno) per page
    builder = _PageBuilder(psize, is_leaf=True)

    def flush(b: _PageBuilder, lvl: list):
        if b.nodes:
            # reserve the pgno BEFORE rendering so overflow runs emitted
            # while filling later pages can't interleave mid-page
            pgno = emit(b.render(next_pg))
            counts["leaf" if b.is_leaf else "branch"] += 1
            lvl.append((b.first_key, pgno))

    for key, value in pairs:
        node, ovpayload = _leaf_node_bytes(key, value, psize)
        full_size = _even(len(node) + (8 if ovpayload is not None else 0))
        if not builder.fits(full_size):
            flush(builder, level)
            builder = _PageBuilder(psize, is_leaf=True)
        if ovpayload is not None:
            npages = _ovpages(len(ovpayload), psize)
            ovpage = bytearray(npages * psize)
            _PGHDR.pack_into(ovpage, 0, next_pg, 0, P_OVERFLOW, 0, 0)
            struct.pack_into("<I", ovpage, 12, npages)
            ovpage[PAGEHDRSZ : PAGEHDRSZ + len(ovpayload)] = ovpayload
            ovpgno = emit(bytes(ovpage))
            counts["overflow"] += npages
            node = node + struct.pack("<Q", ovpgno)
        builder.add(node, key)
    flush(builder, level)

    # ---- branch levels, bottom-up ----
    depth = 1 if level else 0
    while len(level) > 1:
        parent: list[tuple[bytes, int]] = []
        builder = _PageBuilder(psize, is_leaf=False)
        for i, (first_key, child) in enumerate(level):
            sep = b"" if not builder.nodes else first_key  # node 0 key omitted
            node = _branch_node_bytes(sep, child)
            if not builder.fits(_even(len(node))):
                flush(builder, parent)
                builder = _PageBuilder(psize, is_leaf=False)
                node = _branch_node_bytes(b"", child)
            builder.add(node, first_key)
        flush(builder, parent)
        level = parent
        depth += 1

    root = level[0][1] if level else P_INVALID
    last_pg = next_pg - 1

    # ---- meta pages: pristine txn 0 at page 0, our commit (txn 1) at 1 ----
    env_flags = 0 if subdir else MDB_NOSUBDIR
    for metapg, txnid in ((0, 0), (1, 1)):
        committed = txnid == 1
        page = bytearray(psize)
        _PGHDR.pack_into(page, 0, metapg, 0, P_META, 0, 0)
        _META.pack_into(
            page, PAGEHDRSZ,
            MDB_MAGIC, MDB_DATA_VERSION, 0, next_pg * psize,
            # FREE db: md_pad carries psize, md_flags carries env flags
            psize, (env_flags & 0xFFFF) | MDB_INTEGERKEY,
            0, 0, 0, 0, 0, P_INVALID,
            # MAIN db
            0, 0,
            depth if committed else 0,
            counts["branch"] if committed else 0,
            counts["leaf"] if committed else 0,
            counts["overflow"] if committed else 0,
            len(pairs) if committed else 0,
            root if committed else P_INVALID,
            last_pg if committed else 1,
            txnid,
        )
        out.seek(metapg * psize)
        out.write(page)

    with _open_file(_data_path(path, subdir), "wb") as f:
        f.write(out.getvalue())
    return {
        "psize": psize, "depth": depth, "branch_pages": counts["branch"],
        "leaf_pages": counts["leaf"], "overflow_pages": counts["overflow"],
        "entries": len(pairs),
    }


def main(argv=None) -> int:
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2 or argv[0] != "stat":
        print("usage: python -m rfnet_tpu_torch.data.lmdb_pure stat <path>")
        return 1
    path = argv[1]
    with open(path, subdir=os.path.isdir(path)) as env:
        st = env.stat()
        print({k: int(v) for k, v in st.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

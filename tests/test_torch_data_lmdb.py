"""The port's PCN data path against the JAX package's: the msgpack codec
against the ``msgpack`` package, the pure-Python LMDB engine written by one
package and read by the other, the tensorpack LMDB dataflow and converter,
the native .pcd codec and the trainer's LMDB flags. Numpy only on the port's
side; the JAX package's modules here import no JAX."""

import os
import struct
import sys

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax_codec import private_jax_codec  # noqa: F401 (a fixture)

from rfnet_tpu.data import convert as jconvert
from rfnet_tpu.data import dataset as jdataset
from rfnet_tpu.data import lmdb_pure as jlmdb
from rfnet_tpu.data import pcd_io as jpcd
from rfnet_tpu_torch import train as ttrain
from rfnet_tpu_torch.data import convert, dataset, lmdb_pure, msgpack_lite, native, pcd_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- msgpack


def _nd(arr):
    return {b"nd": True, b"type": arr.dtype.str, b"shape": list(arr.shape),
            b"data": arr.tobytes()}


_CORNERS = {
    "fixints": [0, 1, 127, -1, -32],
    "int8-64": [128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -33, -128, -129,
                -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "nil-bool-float": [None, True, False, 0.0, -1.5, 1e300, float("inf")],
    "str": ["", "a" * 31, "a" * 32, "é" * 100, "a" * 255, "a" * 256, "a" * 65535,
            "a" * 65536],
    "bin": [b"", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536, bytearray(b"yz")],
    "arrays": [[1] * 15, [1] * 16, [1] * 65535, [1] * 65536, (1, "a", b"b")],
    "maps": [{i: i for i in range(15)}, {i: i for i in range(16)},
             {str(i): None for i in range(65536)}, {b"k": 1, "k": 2, 3: [4]}],
    "tensorpack datapoint": [[b"02691156/abc", _nd(np.arange(12, dtype=np.float32).reshape(4, 3)),
                              _nd(np.zeros((0, 3), np.float64))]],
}


@pytest.mark.parametrize("case", sorted(_CORNERS))
def test_msgpack_corners_match_msgpack(case):
    for obj in _CORNERS[case]:
        want = msgpack.packb(obj, use_bin_type=True)
        assert msgpack_lite.packb(obj) == want
        assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False,
                                                              strict_map_key=False)


def test_msgpack_float32_and_old_raw_keys():
    """float32 (what ``use_single_float`` writes) decodes as msgpack does;
    an array dict with str keys, as an older writer packed it, decodes to the
    same array in both packages."""
    raw = msgpack.packb([1.25, -3.0e-7], use_single_float=True)
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw, raw=False)
    arr = np.arange(18, dtype=np.float32).reshape(6, 3)
    old = {"nd": True, "type": "<f4", "shape": [6, 3], "data": arr.tobytes()}
    dp = msgpack.packb(["0001/a", old, old], use_bin_type=True)
    ident, p, g = dataset.decode_datapoint(dp)
    jident, jp, jg = jdataset.decode_datapoint(dp)
    assert ident == jident == "0001/a"
    np.testing.assert_array_equal(p, arr)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(g, jg)


@pytest.mark.parametrize("raw", [b"\xc1", b"\xd4\x01\x02", b"\xc7\x01\x05x", b"\x92\x01",
                                 b"\xc4\x05ab", b"\x01\x02", b"\xd9\x02\xff\xfe", b""])
def test_msgpack_unpackb_refuses_what_it_does_not_cover(raw):
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(raw)


@pytest.mark.parametrize("obj", [object(), np.float32(1.0), {1, 2}, 2**64, -2**63 - 1])
def test_msgpack_packb_refuses_other_types(obj):
    with pytest.raises(ValueError):
        msgpack_lite.packb(obj)


_scalars = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
_trees = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8) | st.binary(max_size=8) | st.integers(-300, 300),
                      inner, max_size=20),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_trees)
def test_msgpack_fuzz_matches_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)


# ---------------------------------------------------------------- LMDB engine

_WRITERS = {"jax": jlmdb.write_lmdb, "port": lmdb_pure.write_lmdb}
_READERS = {"jax": jlmdb.open, "port": lmdb_pure.open}
_WAYS = ["jax->port", "port->jax"]


def _items_small(rng, n=40):
    return [(f"04530566/model_{i:04d}".encode(), rng.bytes(int(rng.randint(1, 400))))
            for i in range(n)]


def _item_sets(rng):
    return {
        "small": _items_small(rng),
        "overflow": [(f"k{i:02d}".encode(), rng.bytes(s))
                     for i, s in enumerate([2033, 2040, 2041, 5000, 16 * 4096, 232 * 1024])],
        "deep": [(b"prefix/%04d/" % i + bytes(110), b"v%06d" % i) for i in range(1200)],
        "empty": [],
    }


def _write_read(way, path, items, subdir=False):
    writer, reader = way.split("->")
    st_ = _WRITERS[writer](path, items, subdir=subdir)
    return st_, _READERS[reader](path, subdir=subdir)


@pytest.mark.parametrize("way", _WAYS)
@pytest.mark.parametrize("kind", ["small", "overflow", "deep", "empty"])
def test_lmdb_cross_written_roundtrip(rng, tmp_path, way, kind):
    """One package writes, the other reads: every value by cursor and by
    point lookup, absent keys missed cleanly, the same stat."""
    items = _item_sets(rng)[kind]
    st_, env = _write_read(way, str(tmp_path / "db.lmdb"), items)
    with env:
        assert env.stat() == st_
        assert st_["entries"] == len(items)
        with env.begin() as txn:
            assert list(txn.cursor()) == sorted(items)
            for k, v in items[::7]:
                assert txn.get(k) == v
            for absent in (b"no/such/key", b"prefix/0500", b"zzz", b"\x00"):
                assert txn.get(absent) is None
    if kind == "overflow":
        assert st_["overflow_pages"] > 0
    if kind == "deep":
        assert st_["depth"] >= 3 and st_["branch_pages"] > 1


@pytest.mark.parametrize("way", _WAYS)
def test_lmdb_cross_written_subdir(rng, tmp_path, way):
    path = str(tmp_path / "db_dir")
    items = _items_small(rng, n=8)
    _, env = _write_read(way, path, items, subdir=True)
    assert os.path.isfile(os.path.join(path, "data.mdb"))
    with env, env.begin() as txn:
        for k, v in items:
            assert txn.get(k) == v


@pytest.mark.parametrize("kind", ["small", "overflow", "deep", "empty", "subdir"])
def test_lmdb_writers_byte_identical(rng, tmp_path, kind):
    sets = _item_sets(rng)
    items = sets["small"][:8] if kind == "subdir" else sets[kind]
    subdir = kind == "subdir"
    files = []
    for name, writer in _WRITERS.items():
        path = str(tmp_path / name)
        assert writer(path, items, subdir=subdir) == _WRITERS["jax"](
            str(tmp_path / "again"), items, subdir=subdir)
        with open(os.path.join(path, "data.mdb") if subdir else path, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]


def test_lmdb_meta_selection_and_format(rng, tmp_path):
    """The live meta is the larger-txnid one (page 1 after the single
    commit), psize comes from the FREE-db pad, a corrupt magic is refused."""
    path = str(tmp_path / "meta.lmdb")
    lmdb_pure.write_lmdb(path, _items_small(rng, n=4))
    raw = bytearray(open(path, "rb").read())
    for off in (16, 4096 + 16):
        assert struct.unpack_from("<I", raw, off)[0] == lmdb_pure.MDB_MAGIC
    assert struct.unpack_from("<Q", raw, 16 + 128)[0] == 0
    assert struct.unpack_from("<Q", raw, 4096 + 16 + 128)[0] == 1
    assert struct.unpack_from("<Q", raw, 16 + 112)[0] == lmdb_pure.P_INVALID
    env = lmdb_pure.open(path, subdir=False)
    assert env.txnid == 1 and env.psize == 4096
    env.close()
    struct.pack_into("<I", raw, 16, 0xDEADBEEF)
    struct.pack_into("<I", raw, 4096 + 16, 0xDEADBEEF)
    bad = tmp_path / "bad.lmdb"
    bad.write_bytes(bytes(raw))
    with pytest.raises(lmdb_pure.LmdbFormatError):
        lmdb_pure.open(str(bad), subdir=False)
    with pytest.raises(NotImplementedError):
        lmdb_pure.open(path, subdir=False, readonly=False)


def test_lmdb_corruption_fails_cleanly(rng, tmp_path):
    """Byte-flipped databases raise a typed error or return data: never a
    hang (cycle guard), unbounded recursion (depth cap) or another type."""
    base = str(tmp_path / "fuzz.lmdb")
    items = [(b"k%04d" % i, bytes([i % 251]) * (i % 97 + 1)) for i in range(300)]
    items += [(b"big%d" % i, bytes(5000 + i)) for i in range(3)]
    lmdb_pure.write_lmdb(base, items)
    raw = bytearray(open(base, "rb").read())
    allowed = (lmdb_pure.LmdbFormatError, ValueError, struct.error, NotImplementedError)
    victim = str(tmp_path / "victim.lmdb")
    for _ in range(200):
        buf = bytearray(raw)
        for _ in range(int(rng.randint(1, 4))):
            buf[int(rng.randint(0, len(buf)))] ^= 1 << int(rng.randint(0, 8))
        with open(victim, "wb") as f:
            f.write(bytes(buf))
        try:
            with lmdb_pure.open(victim, subdir=False) as env, env.begin() as txn:
                for _k, _v in txn.cursor():
                    pass
                txn.get(b"k0100")
        except allowed:
            pass


@pytest.mark.parametrize("items, error", [
    ([(b"", b"v")], ValueError), ([(b"k" * 512, b"v")], ValueError),
    ([("str", b"v")], TypeError), ([(b"k", b"1"), (b"k", b"2")], ValueError)])
def test_lmdb_writer_rejects_bad_keys(tmp_path, items, error):
    with pytest.raises(error):
        lmdb_pure.write_lmdb(str(tmp_path / "x.lmdb"), items)


def test_lmdb_stat_cli(rng, tmp_path, capsys):
    path = str(tmp_path / "s.lmdb")
    st_ = lmdb_pure.write_lmdb(path, _items_small(rng, n=5))
    assert lmdb_pure.main(["stat", path]) == 0
    assert capsys.readouterr().out.strip() == str(st_)
    assert lmdb_pure.main([]) == 1


# ---------------------------------------------------------------- dataflow


def _triples(rng, n=7):
    """Datapoints of ragged sizes around the tiny model's 32 / 64 points, so
    resampling both truncates and pads (the padding draws from the RNG)."""
    return [(f"0{i % 3}/m{i:03d}", rng.rand(int(rng.randint(20, 50)), 3).astype(np.float32),
             rng.rand(int(rng.randint(50, 80)), 3).astype(np.float32)) for i in range(n)]


def _write_db(path, triples, with_keys):
    if with_keys:
        jconvert.write_tensorpack_lmdb(path, triples)
    else:  # cursor order: the datapoints alone
        jlmdb.write_lmdb(path, [(m.encode(), jconvert.encode_datapoint(m, p, g))
                                for m, p, g in triples])


def _first_batches(df, n=3):
    it = iter(df)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _assert_batches_equal(ours, theirs):
    for (i1, p1, n1, g1), (i2, p2, n2, g2) in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(i1, i2)
        assert i1.dtype == i2.dtype
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(g1, g2)
        assert p1.dtype == p2.dtype == g1.dtype == np.float32 and n1 == n2


@pytest.mark.parametrize("with_keys", [True, False])
@pytest.mark.parametrize("is_training", [True, False])
def test_lmdb_dataflow_matches_jax(rng, tmp_path, is_training, with_keys):
    path = str(tmp_path / "train.lmdb")
    _write_db(path, _triples(rng), with_keys)
    df, size = dataset.lmdb_dataflow(path, 3, 32, 64, is_training)
    jdf, jsize = jdataset.lmdb_dataflow(path, 3, 32, 64, is_training)
    assert size == jsize == 7
    _assert_batches_equal(_first_batches(df), _first_batches(jdf))


@pytest.mark.parametrize("is_training", [True, False])
def test_lmdb_dataflow_matches_jax_across_epochs(rng, tmp_path, is_training):
    """7 items at batch 2: the 5 batches cross two epoch boundaries, where
    the index stream draws a new order and the resampling RNG runs on."""
    path = str(tmp_path / "train.lmdb")
    _write_db(path, _triples(rng), True)
    df, _ = dataset.lmdb_dataflow(path, 2, 32, 64, is_training)
    jdf, _ = jdataset.lmdb_dataflow(path, 2, 32, 64, is_training)
    _assert_batches_equal(_first_batches(df, 5), _first_batches(jdf, 5))


def test_lmdb_dataflow_subdir_and_dir_source(rng, tmp_path):
    triples = _triples(rng, n=4)
    path = str(tmp_path / "db_dir")
    convert.write_tensorpack_lmdb(path, triples, subdir=True)
    size, load = dataset._lmdb_items(path)
    assert size == 4
    for i, (m, p, g) in enumerate(triples):
        mid, lp, lg = load(i)
        assert mid == m and type(mid) is str
        np.testing.assert_array_equal(lp, p)
        np.testing.assert_array_equal(lg, g)
    npz = tmp_path / "npz"
    npz.mkdir()
    for m, p, g in triples:
        np.savez(npz / (m.replace("/", "__") + ".npz"), partial=p, gt=g)
    ids, load = dataset.dir_source(str(npz))
    jids, jload = jdataset.dir_source(str(npz))
    assert ids == jids
    for i in range(len(ids)):
        a, b = load(i), jload(i)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_decode_key_list_matches_jax():
    keys = [b"a/1", b"b/2"]
    raw = msgpack.packb(keys, use_bin_type=True)
    assert dataset.decode_key_list(raw) == jdataset.decode_key_list(raw) == keys
    cursor = [b"a", b"__keys__", b"b"]
    assert dataset.decode_key_list(None, cursor) == jdataset.decode_key_list(None, cursor)
    assert dataset.decode_key_list(None) == []


def test_converters_write_the_jax_bytes(rng, tmp_path):
    """write_tensorpack_lmdb and convert_npz_to_lmdb: the same file as the
    JAX converter's; then convert_lmdb round-trips the arrays bit for bit."""
    triples = _triples(rng, n=5)
    for mod, name in ((convert, "port"), (jconvert, "jax")):
        assert mod.write_tensorpack_lmdb(str(tmp_path / f"{name}.lmdb"), triples) == 5
    assert (tmp_path / "port.lmdb").read_bytes() == (tmp_path / "jax.lmdb").read_bytes()
    for m, p, g in triples:
        assert convert.encode_datapoint(m, p, g) == jconvert.encode_datapoint(m, p, g)

    src = tmp_path / "npz_in"
    src.mkdir()
    for m, p, g in triples:
        np.savez_compressed(src / (m.replace("/", "__") + ".npz"), partial=p, gt=g)
    assert convert.convert_npz_to_lmdb(str(src), str(tmp_path / "round.lmdb")) == 5
    jconvert.convert_npz_to_lmdb(str(src), str(tmp_path / "jround.lmdb"))
    assert (tmp_path / "round.lmdb").read_bytes() == (tmp_path / "jround.lmdb").read_bytes()
    dst = tmp_path / "npz_out"
    assert convert.convert_lmdb(str(tmp_path / "round.lmdb"), str(dst)) == 5
    for m, p, g in triples:
        with np.load(dst / (m.replace("/", "__") + ".npz")) as z:
            np.testing.assert_array_equal(z["partial"], p)
            np.testing.assert_array_equal(z["gt"], g)


def test_convert_pcds_pcn_layout(tmp_path, capsys):
    """The PCN dress-rehearsal layout (8 synset dirs, synset/model ids):
    .pcd → npz like the JAX converter, → LMDB, and back out of the dataflow
    with the ids intact."""
    sys.path.insert(0, REPO)
    import tools.make_synthetic_evalset as mk

    out = str(tmp_path / "evalset")
    mk.main(["--out", out, "--num", "16", "--input_size", "40", "--gt_size", "128",
             "--pcn_layout"])
    lst, data = os.path.join(out, "test.list"), os.path.join(out, "data")
    assert convert.main(["pcds", lst, data, str(tmp_path / "npz")]) == 0
    jconvert.convert_pcds(lst, data, str(tmp_path / "jnpz"))
    assert sorted(os.listdir(tmp_path / "npz")) == sorted(os.listdir(tmp_path / "jnpz"))
    for f in os.listdir(tmp_path / "npz"):
        with np.load(tmp_path / "npz" / f) as a, np.load(tmp_path / "jnpz" / f) as b:
            np.testing.assert_array_equal(a["partial"], b["partial"])
            np.testing.assert_array_equal(a["gt"], b["gt"])
    db = str(tmp_path / "pcn.lmdb")
    assert convert.main(["to_lmdb", str(tmp_path / "npz"), db]) == 0
    assert "converted 16 models" in capsys.readouterr().out
    df, size = dataset.lmdb_dataflow(db, 4, 40, 128, False)
    ids = [i for b in _first_batches(df, 4) for i in b[0]]
    with open(lst) as f:
        assert sorted(ids) == sorted(f.read().split())
    assert {i.split("/")[0] for i in ids} == set(mk.PCN_SYNSETS)
    assert convert.main([]) == 1


# ---------------------------------------------------------------- native codec


def _binary_pcd(path, pts, extra=None):
    fields = "x y z" + (" intensity" if extra is not None else "")
    k = len(fields.split())
    header = (f"VERSION 0.7\nFIELDS {fields}\nSIZE {' '.join(['4'] * k)}\n"
              f"TYPE {' '.join(['F'] * k)}\nCOUNT {' '.join(['1'] * k)}\nWIDTH {len(pts)}\n"
              f"HEIGHT 1\nPOINTS {len(pts)}\nDATA binary\n")
    rec = pts if extra is None else np.concatenate([pts, extra[:, None]], 1)
    with open(path, "wb") as f:
        f.write(header.encode() + np.ascontiguousarray(rec, np.float32).tobytes())


@pytest.mark.usefixtures("private_jax_codec")
@pytest.mark.parametrize("fmt", ["ascii", "binary", "binary extra field"])
def test_native_read_pcd_matches_jax(tmp_path, rng, fmt):
    pts = (rng.randn(257, 3) * 10).astype(np.float32)
    path = str(tmp_path / "x.pcd")
    if fmt == "ascii":
        pcd_io.save_pcd(path, pts)
    else:
        _binary_pcd(path, pts, rng.rand(257).astype(np.float32) if "extra" in fmt else None)
    before = native.reads
    ours = pcd_io.read_pcd(path)
    assert native.get_lib() is not None and native.reads == before + 1
    np.testing.assert_array_equal(ours, native.read_pcd_native(path))
    np.testing.assert_array_equal(ours, jpcd.read_pcd(path))
    assert ours.dtype == np.float64
    np.testing.assert_array_equal(ours.astype(np.float32), pts)
    assert os.path.dirname(native._build()) == native.BUILD_DIR


def test_native_rejects_garbage(tmp_path):
    path = str(tmp_path / "junk.pcd")
    with open(path, "wb") as f:
        f.write(b"not a pcd file at all\n")
    assert native.read_pcd_native(path) is None
    with pytest.raises(ValueError):
        pcd_io.read_pcd(path)  # the numpy parser refuses it too


def test_native_failed_build_is_reported_once(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "absent.cpp"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib() is None and native.get_lib() is None
    err = capsys.readouterr().err
    assert err.count("native .pcd codec is unavailable") == 1 and "absent.cpp" in err
    pts = np.ones((3, 3), np.float32)
    pcd_io.save_pcd(str(tmp_path / "a.pcd"), pts)
    np.testing.assert_array_equal(pcd_io.read_pcd(str(tmp_path / "a.pcd")), pts)


# ---------------------------------------------------------------- trainer


_TINY = ["--device", "cpu", "--innum", "32", "--ptnum", "128", "--n_seed", "4",
         "--up_ratio", "4", "--batch_size", "2"]


def test_train_cli_from_lmdb(tmp_path):
    """--train_path/--val_path: 2 steps, a checkpoint, an eval and the best
    record written; the LMDB batches equal the synthetic dataflow's over the
    same items (the path the other trainer tests check)."""
    db = str(tmp_path / "train.lmdb")
    convert.write_tensorpack_lmdb(db, dataset.synthetic_pairs(8, 64, 128, seed=0))
    workdir = tmp_path / "run" / "modelvv_recon"
    ttrain.main([*_TINY, "--steps", "2", "--ckpt_every", "2", "--train_path", db,
                 "--val_path", db, "--workdir", str(workdir)])
    assert os.listdir(workdir) == ["ckpt_2.pt"]
    assert sorted(os.listdir(tmp_path / "run" / "bestrecord")) == ["best.json", "model.pt"]
    for is_training, bs in ((True, 2), (False, 4)):
        df, _ = dataset.lmdb_dataflow(db, bs, 32, 128, is_training)
        sdf, _ = dataset.synthetic_dataflow(8, bs, 32, 128, is_training)
        _assert_batches_equal(_first_batches(df), _first_batches(sdf))


# the JAX trainer's flags beyond the data path and the sizes
_JAX_CLI_FLAGS = ("--debug_nans", "--distributed", "--mesh", "--preload_device",
                  "--profile_dir", "--synthetic_online", "--tb_histograms")


@pytest.mark.parametrize("flag", _JAX_CLI_FLAGS)
def test_train_cli_refuses_flags_not_ported(flag, capsys):
    """No flag of the JAX trainer is refused as not ported: each is one the
    port's parser offers (``--mesh`` and ``--distributed`` with the data
    parallelism), and none is in a list of unported flags."""
    assert not hasattr(ttrain, "_NOT_PORTED")
    args = [flag, "trace"] if flag == "--profile_dir" else [flag]
    with pytest.raises(SystemExit) as exc:
        ttrain.main([*_TINY, "--synthetic", *args, "--help"])
    out = capsys.readouterr()
    assert exc.value.code == 0 and flag in out.out and "not ported" not in out.err


def test_train_cli_refuses_a_missing_lmdb(tmp_path, capsys):
    with pytest.raises(SystemExit):
        ttrain.main([*_TINY, "--train_path", str(tmp_path / "absent.lmdb"),
                     "--workdir", str(tmp_path / "m")])
    assert "absent.lmdb: no such LMDB file or directory" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "m")

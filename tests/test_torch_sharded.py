"""The port's ``ops/sharded.py`` and ``parallel/mesh.py`` on a gloo group of
CPU ranks against the JAX package's ``rfnet_tpu.ops.sharded`` on the
virtual CPU mesh (tests/conftest.py), and the dataflow's shards against
the JAX package's, batch for batch."""

import jax
import numpy as np
import pytest
import torch
import torch_dist
from rfnet_tpu.data.dataset import synthetic_dataflow as j_synthetic_dataflow
from rfnet_tpu.ops import sharded as jsharded
from rfnet_tpu.ops.chamfer import nn_distance as j_nn_distance
from rfnet_tpu.ops.emd import approx_match_cost as j_approx_match_cost
from rfnet_tpu.parallel import make_mesh as j_make_mesh

from rfnet_tpu_torch import parallel
from rfnet_tpu_torch.data.dataset import synthetic_dataflow
from rfnet_tpu_torch.ops.chamfer import nearest_neighbor, nn_distance
from rfnet_tpu_torch.ops.emd import approx_match_cost


def _clouds(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s).astype(np.float32) for s in shapes]


def _tied_pair():
    """Queries each exactly as far from a target in each half of the targets:
    target j and its mirror j + m/2 through a plane lie at the same squared
    distance, bit for bit, from every query on that plane."""
    rng = np.random.RandomState(3)
    half = rng.rand(1, 32, 3).astype(np.float32)
    targets = np.concatenate([half, half * np.float32([1, 1, -1])], axis=1)  # z -> -z
    queries = rng.rand(1, 48, 3).astype(np.float32)
    queries[..., 2] = 0.0
    return queries, targets


X1, X2 = _clouds(0, (2, 96, 3), (2, 128, 3))
E1, E2 = _clouds(1, (2, 64, 3), (2, 128, 3))
TQ, TT = _tied_pair()
CASES = {
    "nn": ("nn_distance_sharded", X1, X2),
    "nn_w3": ("nn_distance_sharded", X1[:, :93], X2[:, :126]),
    "emd": ("approx_match_cost_sharded", E1, E2),
    "emd_w3": ("approx_match_cost_sharded", E1[:, :63], E2[:, :126]),
    "ties": ("nearest_neighbor_sharded", TQ, TT),
    "indivisible": ("nearest_neighbor_sharded", X1[:, :16], X2[:, :17]),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 2 gloo ranks, and the 3-rank cases on 3: {world: the
    ranks' results}."""
    root = tmp_path_factory.mktemp("sharded")
    w3 = {k: v for k, v in CASES.items() if k.endswith("_w3")}
    return {2: torch_dist.run(torch_dist.sharded_ops, 2, root / "w2",
                              {k: v for k, v in CASES.items() if k not in w3}),
            3: torch_dist.run(torch_dist.sharded_ops, 3, root / "w3", w3)}


def _near_ties(q, t, rtol=1e-5):
    """(b, n) True where the second-nearest target is within ``rtol`` of the
    nearest (float64 distances): there the two packages' roundings may pick
    either."""
    d = ((q[:, :, None, :].astype(np.float64) - t[:, None, :, :]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] <= rtol * two[..., 0] + 1e-12


def _jax_sharded(fn, x1, x2, n):
    mesh = j_make_mesh(n)
    out = jax.jit(lambda a, b: getattr(jsharded, fn)(a, b, mesh))(x1, x2)
    return [np.asarray(t) for t in out] if isinstance(out, tuple) else np.asarray(out)


def test_every_rank_returns_the_same_result(ranks):
    for results in ranks.values():
        for name, first in results[0].items():
            for other in results[1:]:
                if isinstance(first, list):
                    for a, b in zip(first, other[name], strict=True):
                        np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    np.testing.assert_array_equal(first, other[name], err_msg=name)


@pytest.mark.parametrize("case,world", [("nn", 2), ("nn_w3", 3)])
def test_nn_distance_sharded_matches_jax(ranks, case, world):
    """Distances at JAX's own tolerances (tests/test_sharded.py), indices
    equal away from near ties (the JAX scan expands |t|² − 2q·t in its own
    order)."""
    got = ranks[world][0][case]
    _, x1, x2 = CASES[case]
    want = _jax_sharded("nn_distance_sharded", x1, x2, world)
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for ig, iw, q, t in ((got[1], want[1], x1, x2), (got[3], want[3], x2, x1)):
        sure = ~_near_ties(q, t)  # a near tie may go either way
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(ig[sure], iw[sure])


@pytest.mark.parametrize("case,world", [("nn", 2), ("nn_w3", 3)])
def test_nn_distance_sharded_equals_the_unsplit_scan(ranks, case, world):
    """The per-pair arithmetic does not depend on the split and the combine
    keeps the first index: the port's unsplit scan, bit for bit."""
    got = ranks[world][0][case]
    _, x1, x2 = CASES[case]
    want = nn_distance(torch.from_numpy(x1), torch.from_numpy(x2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_ties_across_the_shard_boundary_go_to_the_lowest_index(ranks):
    """Every query is equally near target j (rank 0's half) and its mirror
    j + 32 (rank 1's): the sharded scan, the unsplit one and JAX's pick j."""
    d, i = ranks[2][0]["ties"]
    ud, ui = nearest_neighbor(torch.from_numpy(TQ), torch.from_numpy(TT))
    jd, ji = _jax_sharded("nearest_neighbor_sharded", TQ, TT, 2)
    assert (i < 32).all()
    pick, mirror = (((TQ[0] - TT[0, j]) ** 2).sum(-1) for j in (i[0], i[0] + 32))
    np.testing.assert_array_equal(pick, mirror)  # a tie, bit for bit
    np.testing.assert_allclose(d[0], pick, rtol=1e-5)
    np.testing.assert_array_equal(i, ui.numpy())
    np.testing.assert_array_equal(d, ud.numpy())
    np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("case,world", [("emd", 2), ("emd_w3", 3)])
def test_approx_match_cost_sharded_matches_jax_and_unsplit(ranks, case, world):
    """Unequal sizes (m > n) take the capacity logic; JAX's tolerance."""
    got = ranks[world][0][case]
    _, x1, x2 = CASES[case]
    np.testing.assert_allclose(got, _jax_sharded("approx_match_cost_sharded", x1, x2, world),
                               rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(j_approx_match_cost(x1, x2)), rtol=1e-4)
    np.testing.assert_allclose(
        got, approx_match_cost(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(), rtol=1e-4)


def test_indivisible_targets_are_refused_with_jax_message(ranks):
    with pytest.raises(ValueError) as jexc:
        jsharded.nearest_neighbor_sharded(X1[:, :16], X2[:, :17], j_make_mesh(2))
    assert ranks[2][0]["indivisible"] == ranks[2][1]["indivisible"] == str(jexc.value)


def test_sharded_nn_matches_jax_single_device_too(ranks):
    d1, i1, d2, i2 = ranks[2][0]["nn"]
    w = [np.asarray(t) for t in j_nn_distance(X1, X2)]
    np.testing.assert_allclose(d1, w[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d2, w[2], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ mesh


def test_mesh_of_one_without_a_group(monkeypatch):
    """Outside torchrun and without a group: a world of 1 whose collectives
    are the identity, and the bootstrap a no-op, as the JAX package's."""
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.torchrun_world() is None
    assert parallel.maybe_initialize_distributed("cpu") is False
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    t = torch.arange(4.0)
    assert torch.equal(mesh.all_reduce_(t.clone(), "max"), t)
    assert torch.equal(mesh.mean(t), t) and mesh.rows(4) == slice(0, 4)
    x = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    assert torch.equal(parallel.shard_batch(x, mesh), torch.from_numpy(x))


@pytest.mark.parametrize("n", [2, 8])
def test_make_mesh_refuses_more_ranks_than_the_world(n):
    with pytest.raises(ValueError, match=f"requested {n}-device mesh but only 1 present"):
        parallel.make_mesh(n, "cpu")
    with pytest.raises(ValueError):  # the JAX package refuses the same request
        j_make_mesh(len(jax.devices()) + n)


def test_cuda_without_a_card_fails_with_a_message():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        parallel.make_mesh(device="cuda")


def test_mesh_rows_split_a_batch_in_rank_order():
    meshes = [parallel.Mesh(None, r, 4, torch.device("cpu")) for r in range(4)]
    assert [m.rows(8) for m in meshes] == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        meshes[0].rows(6)


# ------------------------------------------------------------- dataflows


def _batches(df, n):
    it = iter(df)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("num_shards", [2, 3])
def test_dataflow_shards_are_bit_equal_to_jax(is_training, num_shards):
    """Shard k of n: the same ids, partials and ground truths as the JAX
    package's shard, batch for batch (index stream every n-th from k,
    resampling seeded 1 + 997·k)."""
    for k in range(num_shards):
        kw = dict(is_training=is_training, shard_id=k, num_shards=num_shards)
        ours = _batches(synthetic_dataflow(12, 2, 64, 128, **kw)[0], 4)
        theirs = _batches(j_synthetic_dataflow(12, 2, 64, 128, **kw)[0], 4)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
            np.testing.assert_array_equal(a[3], b[3])


def test_per_process_shards_compose_to_global_batch():
    """k shards at batch B/k yield, step by step, the rows of the one-shard
    dataflow's batch at B (tests/test_sharded.py's property, for the port)."""
    B, k, steps = 8, 2, 3
    full = _batches(synthetic_dataflow(32, B, 64, 128)[0], steps)
    shards = [_batches(synthetic_dataflow(32, B // k, 64, 128, shard_id=i, num_shards=k)[0],
                       steps) for i in range(k)]
    for s in range(steps):
        ids_full, inputs_full = full[s][0], full[s][1]
        ids = np.concatenate([sh[s][0] for sh in shards])
        assert sorted(ids.tolist()) == sorted(ids_full.tolist())
        by_id = {i: inputs_full[j] for j, i in enumerate(ids_full.tolist())}
        for ident, row in zip(ids.tolist(), np.concatenate([sh[s][1] for sh in shards])):
            np.testing.assert_array_equal(row, by_id[ident])


def test_dataflow_refuses_a_shard_outside_the_count():
    with pytest.raises(ValueError, match="shard_id 2 is not one of 2 shards"):
        synthetic_dataflow(4, 2, 64, 128, shard_id=2, num_shards=2)

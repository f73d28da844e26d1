"""The port's data parallelism (``train --mesh`` / ``--distributed``, eval
``--mesh``) on gloo groups of CPU ranks at a tiny size, held to the port's
one-process runs on the same global batches (tests/test_torch_parallel_jax.py
holds the mesh step to the JAX package's).

The W=2 and W=3 checks each run in one spawn (``torch_dist.suite``): a
module fixture starts the ranks once and the tests read their results."""

import json
import os

import numpy as np
import pytest
import torch
import torch_dist

from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch import losses, parallel, train
from rfnet_tpu_torch.data import pcd_io
from rfnet_tpu_torch.data.dataset import synthetic_dataflow

TINY = torch_dist.TINY
B = 4  # the global batch of the W=2 checks
RUN = dict(batch_size=4, eval_size=4, iters=2, ckpt_every=2, log_every=1, seed=7)
DATA = {"train": (16, 4), "valid": (8, 4)}
EVAL_IDS = ["0001/a", "0001/b", "0002/c", "0002/d", "0001/e"]  # 5: the last batch padded


def _batch(seed: int, b: int = B):
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, 128, 3).astype(np.float32)
    partial = (gt[:, :64] + 0.01 * rng.randn(b, 64, 3)).astype(np.float32)
    return partial, gt


def _hinge_batch():
    """Rows 2-3 a hundred times denser than rows 0-1: under the weights of
    the ``hinge_weights`` fixtures the second half's first ``zero_groupnear`` hinge
    is positive, the first half's and the whole batch's negative."""
    rng = np.random.RandomState(5)
    gt = rng.rand(B, 128, 3).astype(np.float32)
    gt[2:] = gt[2:] * 1e-2 + 0.5
    partial = (gt[:, :64] + 1e-4 * rng.randn(B, 64, 3)).astype(np.float32)
    return partial, gt


def _hinge_tensors():
    """Unit-level hinge inputs: rank 0's ground truth sparse (hinge < 0),
    rank 1's dense (hinge > 0), the whole batch's hinge > 0."""
    rng = np.random.RandomState(9)
    cens = rng.rand(B, 8, 3).astype(np.float32)
    spread = np.float32([0.25, 0.25, 0.003, 0.003])[:, None, None]
    raw = (cens.repeat(4, axis=1) + spread * rng.randn(B, 32, 3)).astype(np.float32)
    outmat = (0.1 * rng.randn(B, 8, 4, 3)).astype(np.float32)
    return cens, raw, outmat


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _flat(tensors: dict, names) -> np.ndarray:
    return np.concatenate([tensors[n].numpy().ravel() for n in names])


def _eval_fixtures(root):
    rng = np.random.RandomState(11)
    for mid in EVAL_IDS:
        for kind, n in (("partial", 40), ("complete", 128)):
            path = os.path.join(root, "data", kind, mid + ".pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            pcd_io.save_pcd(path, rng.rand(n, 3).astype(np.float32))
    with open(os.path.join(root, "test.list"), "w") as f:
        f.write("\n".join(EVAL_IDS))
    torch.save(teval.RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(3))
               .state_dict(), os.path.join(root, "model.pt"))


def _eval_argv(root, tag, *extra):
    return ["--list_path", os.path.join(root, "test.list"), "--data_dir",
            os.path.join(root, "data"), "--checkpoint", os.path.join(root, "model.pt"),
            "--num_gt_points", "128", "--plot_freq", "1000", "--batch_size", "4", "--save_pcd",
            "--device", "cpu", "--results_dir", os.path.join(root, "results_" + tag), *extra]


def _tiny_argv(workdir, *extra):
    return ["--device", "cpu", "--innum", "64", "--ptnum", "128", "--n_seed", "4",
            "--up_ratio", "4", "--synthetic", "--synthetic_size", "8", "--batch_size", "4",
            "--steps", "1", "--ckpt_every", "1", "--workdir", str(workdir), *extra]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process on one thread for the module, as each rank is: the CPU
    GEMMs split their sums over threads, which adds its own rounding, and
    tiny steps on many threads crawl when other test processes load the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    """The port's seeded init."""
    return train.create_state(train.TrainConfig(batch_size=B, **TINY), "cpu").model.state_dict()


@pytest.fixture(scope="module")
def hinge_weights(weights):
    """The init with the decoder's offset layer 10 times larger, so that the
    offsets at init are large enough for the hinge term to move the
    gradient well beyond the rounding of a split batch."""
    return {k: v * 10 if k.startswith("decode_cell.points_out.") else v
            for k, v in weights.items()}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    _eval_fixtures(str(root))
    return root


@pytest.fixture(scope="module")
def w2(root, weights, hinge_weights):
    """Every W=2 check in one spawn: {name: [rank 0's result, rank 1's]}."""
    tasks = {
        "step": (torch_dist.train_step, (weights, *_batch(0), B)),
        "hinge_step": (torch_dist.train_step, (hinge_weights, *_hinge_batch(), B)),
        "hinge": (torch_dist.hinge, _hinge_tensors()),
        **{mode: (torch_dist.train_run, (str(root / f"w2_{mode}"), RUN,
                                         {**DATA, "train": None} if mode == "online" else DATA,
                                         {} if mode == "host" else {mode: True}))
           for mode in ("host", "preload_device", "synthetic_online")},
        "distributed": (torch_dist.cli, ("train", _tiny_argv(
            root / "w2_dist" / "model", "--distributed", "--profile_dir",
            str(root / "w2_prof")))),
        "eval": (torch_dist.cli, ("eval", _eval_argv(str(root), "mesh", "--mesh", "2"))),
        "eval_pipe": (torch_dist.cli, ("eval", _eval_argv(str(root), "mesh_pipe", "--mesh", "2",
                                                          "--pipeline"))),
        "nan": (torch_dist.nan_step, (*_batch(1), B)),
    }
    ranks = torch_dist.run(torch_dist.suite, 2, root / "spawn_w2", list(tasks.values()))
    return {name: [r[k] for r in ranks] for k, name in enumerate(tasks)}


@pytest.fixture(scope="module")
def w3(root):
    """The host path on 3 ranks at global batch 6 with an eval batch of 4,
    which ``_tile_for_devices`` repeats 3 times to split it."""
    run = dict(RUN, batch_size=6)
    return torch_dist.run(torch_dist.train_run, 3, root / "spawn_w3", str(root / "w3"), run,
                          {"train": (18, 6), "valid": (8, 4)}, {})


def _one_process(root, tag, monkeypatch, run=RUN, data=DATA, **kw):
    monkeypatch.setattr(train, "_tb_writer", lambda logdir: None)
    return torch_dist.train_run(None, str(root / tag), run, data, kw)


# ------------------------------------------------------------------ step


def _ranks_here(weights, rows):
    """What 2 ranks compute, done in this process a rank's rows at a time
    (on one thread, as each rank runs): each half's one-process step, then the
    mean of the loss terms and of the gradients in float32 as the
    all_reduce forms them, the Adam update from that mean, and rank 0's
    diagnostics (its rows start the global batch)."""
    outs = [torch_dist.train_step(None, weights, p, g, p.shape[0]) for p, g in rows]
    assert len(outs) == 2
    lb = {k: float((np.float32(outs[0]["lb"][k]) + np.float32(outs[1]["lb"][k]))
                   / np.float32(2)) for k in outs[0]["lb"]}
    grads = {n: (outs[0]["grads"][n] + outs[1]["grads"][n]) / 2 for n in outs[0]["grads"]}
    state = train.create_state(train.TrainConfig(**TINY), "cpu")
    state.model.load_state_dict(weights)
    for n, p in state.model.named_parameters():
        p.grad = grads.get(n)
    train.apply_gradients(state)
    return {"lb": lb, "grads": grads, "diag": outs[0]["diag"], "halves": outs,
            "params": {k: v.clone() for k, v in state.model.state_dict().items()}}


def test_mesh_step_is_the_mean_of_its_ranks_steps(w2, weights):
    """Each rank's step is one process's step on its rows, and the mesh adds
    exactly the mean: loss terms, gradients and the parameters after the
    Adam update bit-equal to two one-process steps on the halves, averaged
    here (no hinge of this batch is on, in either half or the whole), on
    both ranks."""
    partial, gt = _batch(0)
    here = _ranks_here(weights, [(partial[s], gt[s]) for s in (slice(0, 2), slice(2, 4))])
    assert all(h["lb"][k] == 0.0 for h in here["halves"] for k in ("loss_d1", "loss_d2"))
    for r in w2["step"]:
        assert r["lb"] == here["lb"] and r["diag"] == here["diag"]
        assert r["grads"].keys() == here["grads"].keys()
        assert all(torch.equal(r["grads"][n], here["grads"][n]) for n in r["grads"])
        assert all(torch.equal(r["params"][k], here["params"][k]) for k in r["params"])


def test_mesh_step_matches_the_one_process_global_batch_step(w2, weights):
    """The mesh step against one process's step on the whole batch: losses
    at rtol 2e-5, the gradient and the parameters after the update at
    relative L2 1e-4, the tolerance the port holds against JAX for the same
    cause (tests/test_torch_train.py): a batch of 2 rounds the CPU GEMMs
    otherwise than a batch of 4, which flips a few near-tie argmins of the
    chamfer terms (measured 1.5e-6 to 6.6e-5 on the gradient), and Adam's
    first update, about −lr·sign(g), carries them into the parameters."""
    ref = torch_dist.train_step(None, weights, *_batch(0), B)
    for r in w2["step"]:
        for k, v in ref["lb"].items():
            np.testing.assert_allclose(r["lb"][k], v, rtol=2e-5, atol=1e-9, err_msg=k)
        assert r["diag"].keys() == ref["diag"].keys()
        for k, v in ref["diag"].items():
            np.testing.assert_allclose(r["diag"][k], v, rtol=1e-5, err_msg=k)
        assert set(r["grads"]) == set(ref["grads"])
        assert _rel(_flat(r["grads"], ref["grads"]), _flat(ref["grads"], ref["grads"])) < 1e-4
        assert _rel(_flat(r["params"], ref["params"]), _flat(ref["params"], ref["params"])) < 1e-4


def test_hinge_batch_straddles_and_mesh_takes_the_global_hinge(w2, hinge_weights):
    """On the batch whose halves fall on opposite sides of
    ``zero_groupnear``'s first hinge, the W=2 gradient is the one-process
    global step's (relative L2 1e-4: with the dense half at a scale of 1e-2,
    splitting the batch alone moves a gradient by up to 4e-5), while a relu
    of each rank's own means, the mean of the two halves' one-process
    gradients, is off by over 10x that."""
    partial, gt = _hinge_batch()
    ref = torch_dist.train_step(None, hinge_weights, partial, gt, B)
    halves = [torch_dist.train_step(None, hinge_weights, partial[s], gt[s], 2)
              for s in (slice(0, 2), slice(2, 4))]
    assert ref["lb"]["loss_d1"] == halves[0]["lb"]["loss_d1"] == 0.0
    assert halves[1]["lb"]["loss_d1"] > 0
    names = sorted(ref["grads"])
    want = _flat(ref["grads"], names)
    for r in w2["hinge_step"]:
        assert r["lb"]["loss_d1"] == 0.0
        np.testing.assert_allclose(r["lb"]["loss_d2"], ref["lb"]["loss_d2"], rtol=2e-5)
        assert _rel(_flat(r["grads"], names), want) < 1e-4
    per_rank = (_flat(halves[0]["grads"], names) + _flat(halves[1]["grads"], names)) / 2
    assert _rel(per_rank, want) > 1e-3


def test_zero_groupnear_takes_the_hinge_on_the_global_means(w2):
    """``losses.zero_groupnear`` with the mesh where rank 0's hinge is off and
    rank 1's and the whole batch's on: both ranks return the whole batch's
    value, and the ranks' gradients (each of a mean over B/W rows) are W
    times the whole batch's, rank 0's rows included, where a relu of rank
    0's own means would give them none."""
    cens, raw, outmat = (torch.from_numpy(x) for x in _hinge_tensors())
    out = outmat.clone().requires_grad_()
    value = losses.zero_groupnear(cens, raw, out)
    value.backward()
    own = [losses.zero_groupnear(cens[s], raw[s], outmat[s]) for s in (slice(0, 2), slice(2, 4))]
    hinge0 = losses.groupin_near(outmat[:2]) - 0.4 * losses.nearest_neighbor(raw[:2], cens[:2])[
        0].mean()
    assert float(hinge0) < 0 < float(own[1]) and float(value) > 0 and float(own[0]) == 0.0
    for r in w2["hinge"]:
        np.testing.assert_allclose(r["value"], float(value), rtol=1e-6)
    got = torch.cat([r["grad"] for r in w2["hinge"]]) / 2
    torch.testing.assert_close(got, out.grad, rtol=1e-6, atol=0)
    assert float(got[:2].abs().min()) > 0


# ------------------------------------------------------------ train runs


@pytest.mark.parametrize("mode", ["host", "preload_device", "synthetic_online"])
def test_mesh_train_run_matches_one_process(w2, root, monkeypatch, mode):
    """``train()`` with the mesh on each batch source: each rank steps on its
    rows of the one-process run's batches, bit for bit; the first step's
    loss terms match (rtol 2e-5), and after Adam's first update, about
    −lr·sign(g), the trajectory as tests/test_fastpaths_mesh.py allows
    (loss lines and eval means at rtol 2e-3, the parameters at relative L2
    1e-3; measured 6e-6 and 3e-5); the parameters bit-equal on both ranks
    and rank 0 the one writer."""
    kw = {} if mode == "host" else {mode: True}
    ref = _one_process(root, "one_" + mode, monkeypatch,
                       data={**DATA, "train": None} if mode == "synthetic_online" else DATA,
                       **kw)
    ranks = w2[mode]
    assert len(ref["seen"]) == 2
    for r, res in enumerate(ranks):
        assert len(res["seen"]) == 2
        for (p, g, lb), (rp, rg, rlb) in zip(res["seen"], ref["seen"]):
            assert torch.equal(p, rp[2 * r:2 * r + 2]) and torch.equal(g, rg[2 * r:2 * r + 2])
        for k, v in ref["seen"][0][2].items():
            np.testing.assert_allclose(res["seen"][0][2][k], v, rtol=2e-5, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(res["evals"], ref["evals"], rtol=2e-3)
        assert res["evals"] == ranks[0]["evals"]
    lines = [json.loads(x) for x in ranks[0]["metrics"].splitlines()]
    want = [json.loads(x) for x in ref["metrics"].splitlines()]
    assert [sorted(x) for x in lines] == [sorted(x) for x in want]
    for x, y in zip(lines, want):
        for k in y:
            np.testing.assert_allclose(x[k], y[k], rtol=2e-3, atol=1e-9, err_msg=k)
    assert ranks[0]["files"] == ref["files"] == ["ckpt_2.pt"]
    assert "metrics" not in ranks[1]
    names = sorted(ref["params"])
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in names)
    assert _rel(_flat(ranks[0]["params"], names), _flat(ref["params"], names)) < 1e-3


def test_three_ranks_tile_the_eval_batch(w3, root, monkeypatch):
    """W=3, global batch 6, eval batch 4: the eval batch is repeated 3 times
    (12 rows, 4 a rank), which leaves its means unchanged; every rank has
    the same means, those of the one-process run (rtol 2e-3, after two Adam
    updates), and stepped on its rows of its batches."""
    run = dict(RUN, batch_size=6)
    ref = _one_process(root, "one_w3", monkeypatch, run=run,
                       data={"train": (18, 6), "valid": (8, 4)})
    for r, res in enumerate(w3):
        for (p, _, _), (rp, _, _) in zip(res["seen"], ref["seen"], strict=True):
            assert torch.equal(p, rp[2 * r:2 * r + 2])
        np.testing.assert_allclose(res["evals"], ref["evals"], rtol=2e-3)
        assert res["evals"] == w3[0]["evals"]
    assert train._tile_for_devices(np.zeros((4, 1)), 3).shape == (12, 1)
    assert train._tile_for_devices(np.zeros((6, 1)), 3).shape == (6, 1)
    assert train._tile_for_devices(np.zeros((4, 1)), 8).shape == (8, 1)
    assert train._tile_for_devices(np.zeros((4, 1)), 1).shape == (4, 1)


def test_distributed_ranks_train_on_disjoint_shards(w2, root):
    """``--distributed`` through the CLI: each rank reads its own shard of
    the dataflow at batch 2; the rows are disjoint, the step's loss terms
    equal a one-process step's on their concatenation (rtol 2e-5), and the
    checkpointed parameters are, bit for bit, the Adam update from the mean
    of the two shards' one-process gradients; ``--profile_dir`` wrote one
    trace and its counters a rank."""
    steps = [res["seen"] for res in w2["distributed"]]
    assert [len(s) for s in steps] == [1, 1] and all(s[0][0].shape[0] == 2 for s in steps)
    rows = [(s[0][0].numpy(), s[0][1].numpy()) for s in steps]
    gt = np.concatenate([g for _, g in rows])
    assert len({row.tobytes() for row in gt}) == 4
    init = train.create_state(train.TrainConfig(batch_size=4, **TINY), "cpu").model.state_dict()
    ref = torch_dist.train_step(None, init, np.concatenate([p for p, _ in rows]), gt, 4)
    for s in steps:
        for k, v in ref["lb"].items():
            np.testing.assert_allclose(s[0][2][k], v, rtol=2e-5, atol=1e-9, err_msg=k)
    model_dir = root / "w2_dist" / "model"
    assert os.listdir(model_dir) == ["ckpt_1.pt"]
    saved = torch.load(model_dir / "ckpt_1.pt", weights_only=True)["model"]
    here = _ranks_here(init, rows)
    assert all(torch.equal(saved[k], here["params"][k]) for k in saved)
    assert "dataflow shard 1 of 2" in w2["distributed"][1]["stdout"]
    assert sorted(os.listdir(root / "w2_prof")) == ["counters_rank0.json", "counters_rank1.json",
                                                    "trace_rank0.json", "trace_rank1.json"]


def test_debug_nans_stops_every_rank_at_the_same_step(w2):
    """A NaN in rank 1's rows only: both ranks raise FloatingPointError at
    that step (the global loss terms are NaN on both), none waits alone."""
    assert [r["step"] for r in w2["nan"]] == [1, 1]
    assert all("non-finite loss terms" in r["error"] for r in w2["nan"])


# ------------------------------------------------------------------ eval


def test_eval_mesh_writes_the_one_process_csv(w2, root):
    """``eval --mesh 2``: rank 0's CSV matches one process's row for row
    (rtol 1e-5, ``tests/test_data_eval.py::test_eval_cli_mesh_matches_single``)
    and with ``--pipeline`` the same CSV again, the two ranks' .pcd files
    are one process's, and only rank 0 prints the results."""
    np.random.seed(0)
    teval.main(_eval_argv(str(root), "single"))
    rows = {t: open(root / f"results_{t}" / "results.csv").read().splitlines()
            for t in ("single", "mesh", "mesh_pipe")}
    assert rows["mesh_pipe"] == rows["mesh"]  # --pipeline composes with --mesh
    assert len(rows["mesh"]) == len(EVAL_IDS) + 1 and rows["mesh"][0] == "id,cd,emd"
    for a, b in zip(rows["mesh"][1:], rows["single"][1:], strict=True):
        ia, *va = a.split(",")
        ib, *vb = b.split(",")
        assert ia == ib
        np.testing.assert_allclose([float(v) for v in va], [float(v) for v in vb], rtol=1e-5)
    tree = {t: sorted(os.listdir(root / f"results_{t}" / "pcds" / "0001"))
            for t in ("single", "mesh")}
    assert tree["mesh"] == tree["single"] == ["a.pcd", "b.pcd", "e.pcd"]
    assert "Average time" in w2["eval"][0]["stdout"]
    assert "Average time" not in w2["eval"][1]["stdout"]
    assert "trainable parameters" not in w2["eval"][1]["stdout"]


# ---------------------------------------------------------- refusals


def test_world_of_one_mesh_run_equals_the_plain_run(tmp_path, monkeypatch):
    """``--mesh`` outside torchrun is a world of 1: the same eval line and
    parameters, bit for bit, as the run without it."""
    monkeypatch.setattr(train, "_tb_writer", lambda logdir: None)
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    out = {}
    for tag, extra in (("plain", ()), ("mesh", ("--mesh",))):
        train.main(_tiny_argv(tmp_path / tag / "model", *extra))
        with open(tmp_path / tag / "logs" / "metrics.jsonl") as f:
            out[tag] = (f.read(), torch.load(tmp_path / tag / "model" / "ckpt_1.pt",
                                             weights_only=True)["model"])
    assert out["plain"][0] == out["mesh"][0]
    assert all(torch.equal(out["plain"][1][k], out["mesh"][1][k]) for k in out["plain"][1])


def _torchrun_env(monkeypatch, world, rank=0):
    for k, v in dict(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank, MASTER_ADDR="localhost",
                     MASTER_PORT=1).items():
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize("argv,world,message", [
    (["--distributed"], None, "--distributed needs torchrun's environment"),
    (["--mesh", "--batch_size", "3"], 2, "--batch_size 3 does not split over the mesh's 2"),
    (["--distributed"], 3, "batch_size 6 / eval_size 4 must divide by process_count 3"),
])
def test_train_cli_checks_the_world_before_forming_a_group(tmp_path, monkeypatch, capsys,
                                                           argv, world, message):
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    if world is not None:
        _torchrun_env(monkeypatch, world)
    base = _tiny_argv(tmp_path / "m")
    base[base.index("--batch_size") + 1] = "6"
    with pytest.raises(SystemExit):
        train.main(base + argv)
    assert message in capsys.readouterr().err
    assert not torch.distributed.is_initialized() and not os.path.exists(tmp_path / "m")


@pytest.mark.parametrize("extra,world,message", [
    (["--mesh", "2"], None, "--mesh 2 needs 2 ranks, and this world has 1"),
    (["--mesh", "2", "--batch_size", "3"], 2, "--batch_size 3 must be a multiple of the mesh "
                                              "size 2"),
])
def test_eval_cli_checks_the_mesh_before_forming_a_group(root, monkeypatch, extra, world,
                                                         message):
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    if world is not None:
        _torchrun_env(monkeypatch, world)
    with pytest.raises(SystemExit, match=message):
        teval.main(_eval_argv(str(root), "refused", *extra))
    assert not torch.distributed.is_initialized()


def test_preload_device_refuses_dataflow_shards():
    """As the JAX trainer refuses ``--preload_device`` across processes:
    a dataflow shard has its own index stream, which the gather cannot
    replay; refused on every rank before any collective."""
    mesh = parallel.Mesh(None, 0, 2, torch.device("cpu"))
    df, _ = synthetic_dataflow(8, 2, 64, 128, shard_id=0, num_shards=2)
    vdf, vn = synthetic_dataflow(4, 2, 64, 128, is_training=False, shard_id=0, num_shards=2)
    with pytest.raises(ValueError, match="--preload_device takes the one global stream"):
        train.train(train.TrainConfig(**TINY), df, vdf, vn, "cpu", preload_device=True,
                    mesh=mesh)
    with pytest.raises(ValueError, match="dataflow is shard 0 of 2; this process has no mesh"):
        train.train(train.TrainConfig(**TINY), df, vdf, vn, "cpu")


def test_nccl_needs_a_card_a_rank(monkeypatch):
    """torchrun with more local ranks than cards: the rank without a card
    stops with a message naming the way to share one (a gloo group)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    _torchrun_env(monkeypatch, 2, rank=1)
    with pytest.raises(SystemExit, match="card cuda:1 does not exist .*gloo group"):
        parallel.maybe_initialize_distributed("cuda")
    assert not torch.distributed.is_initialized()

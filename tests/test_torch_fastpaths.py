"""The trainer's fast paths and diagnostics on the CPU at a tiny size: the
on-device synthetic stream (``data/online.py``, ``--synthetic_online``),
the device-resident training set (``--preload_device``), ``--debug_nans``,
``--profile_dir``, the TensorBoard scalars and histograms, and the flags
the port refuses, against the JAX package's where it has a counterpart."""

import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from rfnet_tpu import losses as jlosses
from rfnet_tpu import train as jtrain
from rfnet_tpu.data.online import synthetic_batch as j_synthetic_batch
from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch import losses, train
from rfnet_tpu_torch.data import online
from rfnet_tpu_torch.data.dataset import PREFETCH_THREAD, BatchedDataflow, synthetic_dataflow
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point

TINY = dict(batch_size=2, eval_size=2, innum=64, ptnum=128, n_seed=4, up_ratio=4)
B, INNUM, PTNUM = 2, 16, 64


def _tiny_argv(workdir, steps, *extra):
    return ["--device", "cpu", "--innum", "64", "--ptnum", "128", "--n_seed", "4",
            "--up_ratio", "4", "--batch_size", "2", "--steps", str(steps), "--ckpt_every", "2",
            "--workdir", str(workdir), *extra]


def _metrics(root):
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------------ online stream


def test_online_batch_shapes_and_determinism():
    """Shapes and dtypes as the JAX stream's; a batch is a function of
    (seed, step) alone: the same pair gives the same batch bit for bit,
    another step or another seed another batch."""
    p, g = online.synthetic_batch(7, 3, B, INNUM, PTNUM, "cpu")
    jp, jg = j_synthetic_batch(jax.random.PRNGKey(7), B, INNUM, PTNUM)
    assert p.shape == tuple(jp.shape) == (B, INNUM, 3) and g.shape == tuple(jg.shape)
    assert p.dtype == g.dtype == torch.float32
    assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(g).all())
    p2, g2 = online.synthetic_batch(7, 3, B, INNUM, PTNUM, "cpu")
    assert torch.equal(p, p2) and torch.equal(g, g2)
    for seed, step in ((7, 4), (8, 3)):
        _, other = online.synthetic_batch(seed, step, B, INNUM, PTNUM, "cpu")
        assert not torch.equal(g, other)


def test_online_partial_is_a_uniform_subset_of_the_top_half():
    """Every partial point is a gt row, bit for bit, no row twice (drawn
    without replacement), and every one lies in the half of gt with the
    largest projection onto the batch's view (the generator's draws
    replayed: centers, blob choice, noise, view)."""
    p, g = online.synthetic_batch(3, 0, B, INNUM, PTNUM, "cpu")
    gen = torch.Generator().manual_seed(online._stream_seed(3, 0))
    torch.randn((B, online.NUM_BLOBS, 3), generator=gen)
    torch.randint(0, online.NUM_BLOBS, (B, PTNUM), generator=gen)
    torch.randn((B, PTNUM, 3), generator=gen)
    view = torch.randn((B, 1, 3), generator=gen)
    proj = (g * view).sum(-1)
    for b in range(B):
        eq = (p[b][:, None, :] == g[b][None, :, :]).all(-1)  # (innum, ptnum)
        assert bool(eq.any(1).all()), "a partial row is not a gt row"
        idx = eq.int().argmax(1)
        assert len(set(idx.tolist())) == INNUM, "a gt row was drawn twice"
        cut = torch.sort(proj[b], descending=True).values[PTNUM // 2 - 1]
        assert bool((proj[b, idx] >= cut).all()), "a partial point is outside the crop"


def test_online_stream_resume_replays_identical_batches():
    full = online.batch_stream(1, 0, B, INNUM, PTNUM, "cpu")
    batches = [next(full) for _ in range(5)]
    resumed = online.batch_stream(1, 3, B, INNUM, PTNUM, "cpu")
    for step in (3, 4):
        p, g = next(resumed)
        assert torch.equal(p, batches[step][0]) and torch.equal(g, batches[step][1])


def test_online_rejects_oversized_innum():
    """Mirrors ``tests/test_train_robustness.py::test_synthetic_batch_rejects_oversized_innum``."""
    with pytest.raises(ValueError, match="innum <= ptnum//2"):
        online.synthetic_batch(0, 0, 2, 65, 128, "cpu")


def test_online_cloud_statistics_match_jax():
    """The two streams draw from one distribution: over 4 batches of 64
    clouds each, the gt's coordinate std and the mean distance from the
    partial's centroid to the gt's agree with JAX's to 5 % (one batch of 64
    estimates them to ~2 %; the values differ by design)."""
    def stats(pairs):
        p = np.concatenate([np.asarray(x, np.float64) for x, _ in pairs])
        g = np.concatenate([np.asarray(y, np.float64) for _, y in pairs])
        return g.std(), np.linalg.norm(p.mean(1) - g.mean(1), axis=-1).mean()

    ours = stats([online.synthetic_batch(1, s, 64, 512, 2048, "cpu") for s in range(4)])
    key = jax.random.PRNGKey(1)
    ref = stats([j_synthetic_batch(jax.random.fold_in(key, s), 64, 512, 2048) for s in range(4)])
    np.testing.assert_allclose(ours, ref, rtol=0.05)


def test_train_cli_synthetic_online_and_resume(tmp_path, monkeypatch):
    """``--synthetic_online``: each step's batch is ``synthetic_batch(seed,
    step)``; the held-out eval runs at each checkpoint; a run resumed from
    step 4 trains on the batch a straight-through run sees at step 4."""
    seen = []
    make = online.synthetic_batch

    def recording(seed, step, *args):
        batch = make(seed, step, *args)
        seen.append((seed, step, batch))
        return batch

    monkeypatch.setattr(online, "synthetic_batch", recording)
    workdir = tmp_path / "run" / "model"
    argv = ["--synthetic_online", "--synthetic_val_size", "4"]
    train.main(_tiny_argv(workdir, 4, *argv))
    assert [(s, t) for s, t, _ in seen] == [(1, 0), (1, 1), (1, 2), (1, 3)]
    assert sorted(os.listdir(workdir)) == ["ckpt_2.pt", "ckpt_4.pt"]
    assert [x["step"] for x in _metrics(tmp_path / "run") if "eval_cd" in x] == [2, 4]
    assert (tmp_path / "run" / "bestrecord" / "best.json").exists()
    seen.clear()
    train.main(_tiny_argv(workdir, 5, *argv))
    assert [(s, t) for s, t, _ in seen] == [(1, 4)]
    straight = online.batch_stream(1, 0, 2, 64, 128, "cpu")
    want = [next(straight) for _ in range(5)][4]
    assert all(torch.equal(a, b) for a, b in zip(seen[0][2], want))


# ------------------------------------------------------------ preload


def test_precompute_pyramids_equal_step_fps_and_jax(rng):
    """The pyramids of a resident set, in chunks with a ragged tail, equal
    the on-step FPS of each row bit for bit, and JAX's
    ``_precompute_pyramids`` by coordinates."""
    gts = rng.rand(5, 128, 3).astype(np.float32)
    g1, g2 = train._precompute_pyramids(torch.from_numpy(gts), 8, 32, chunk=2)
    for i in range(5):
        row = torch.from_numpy(gts[i:i + 1])
        assert torch.equal(g1[i:i + 1], gather_point(row, farthest_point_sample(8, row)))
        assert torch.equal(g2[i:i + 1], gather_point(row, farthest_point_sample(32, row)))
    j1, j2 = jtrain._precompute_pyramids(jax.numpy.asarray(gts), 8, 32, chunk=2)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(j2))


def test_preload_run_equals_host_path(tmp_path):
    """Three steps with the training set on the device give the host path's
    loss trajectory and final weights bit for bit (the same batches from
    the same index stream, the same pyramids)."""
    runs = {}
    for tag, preload in (("host", False), ("preload", True)):
        config = train.TrainConfig(**TINY, iters=3, log_every=1, ckpt_every=100,
                                   workdir=str(tmp_path / tag / "m"))
        df, _ = synthetic_dataflow(6, 2, 64, 128)
        vdf, vn = synthetic_dataflow(2, 2, 64, 128, is_training=False)
        state = train.train(config, df, vdf, vn, device="cpu", preload_device=preload)
        runs[tag] = (_metrics(tmp_path / tag), state.model.state_dict())
    (mh, wh), (mp, wp) = runs["host"], runs["preload"]
    assert [x["step"] for x in mp] == [0, 1, 2]
    assert mh == mp
    assert all(torch.equal(wh[k], wp[k]) for k in wh)


def test_preload_rejects_partials_smaller_than_innum():
    pairs = [(f"s/{i}", np.zeros((40, 3), np.float32), np.zeros((128, 3), np.float32))
             for i in range(4)]
    df = BatchedDataflow(4, pairs.__getitem__, 2, 64, 128)
    with pytest.raises(ValueError, match="preload_device requires partials with >= innum"):
        train.preload_device_data(df, train.TrainConfig(**TINY), torch.device("cpu"))


def test_train_cli_preload_device(tmp_path, capsys):
    train.main(_tiny_argv(tmp_path / "m", 2, "--synthetic", "--synthetic_size", "6",
                          "--preload_device"))
    assert "trained 2 steps" in capsys.readouterr().out
    assert os.listdir(tmp_path / "m") == ["ckpt_2.pt"]


# ------------------------------------------------------------ diagnostics


def test_debug_nans_raises_and_stops_the_prefetch_threads(tmp_path):
    """A NaN weight under ``--debug_nans`` stops the run at its first step
    with ``FloatingPointError`` naming the step, and the dataflows' prefetch
    threads stop on that path (as ``tests/test_train_robustness.py`` pins for
    the JAX trainer's stager)."""
    workdir = tmp_path / "m"
    state = train.create_state(train.TrainConfig(**TINY), "cpu")
    with torch.no_grad():
        state.model.cell.state_mlp.l0.weight[0, 0] = float("nan")
    train.save_checkpoint(state, str(workdir), 1)
    with pytest.raises(FloatingPointError, match="step 0"):
        train.main(_tiny_argv(workdir, 2, "--synthetic", "--synthetic_size", "4",
                              "--debug_nans"))
    deadline = time.time() + 5.0
    while any(t.name == PREFETCH_THREAD for t in threading.enumerate()):
        assert time.time() < deadline, "a prefetch thread outlived the failed run"
        time.sleep(0.05)


def test_debug_nans_names_a_nan_gradient():
    """A NaN that appears only in the backward (0 · d√x at x = 0) is caught
    by the anomaly mode and raised as ``FloatingPointError``."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="step 7: .*nan"):
        with train._nan_guard(7):
            (torch.sqrt(x - 1.0) * 0.0).sum().backward()


def test_train_profile_dir_writes_a_parseable_trace(tmp_path):
    trace = tmp_path / "prof" / "trace.json"
    train.main(_tiny_argv(tmp_path / "m", 1, "--synthetic", "--synthetic_size", "4",
                          "--profile_dir", str(tmp_path / "prof")))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_tensorboard_scalars_and_histograms(tmp_path):
    """The event file holds the JAX trainer's scalar tags (``loss/<term>``
    for each ``LossBreakdown`` field, ``throughput/clouds_per_sec``) at each
    log step, with ``metrics.jsonl``'s values (TensorBoard keeps float32),
    and one histogram per parameter only under ``tb_histograms``."""
    want_tags = {f"loss/{k}" for k in jlosses.LossBreakdown._fields}
    want_tags.add("throughput/clouds_per_sec")
    assert want_tags == {f"loss/{k}" for k in losses.LossBreakdown._fields} | {
        "throughput/clouds_per_sec"}
    for hist in (False, True):
        root = tmp_path / str(hist)
        config = train.TrainConfig(**TINY, iters=2, log_every=1, ckpt_every=100,
                                   workdir=str(root / "m"), tb_histograms=hist)
        df, _ = synthetic_dataflow(4, 2, 64, 128)
        vdf, vn = synthetic_dataflow(2, 2, 64, 128, is_training=False)
        state = train.train(config, df, vdf, vn, device="cpu")
        acc = EventAccumulator(str(root / "logs"), size_guidance={"scalars": 0,
                                                                  "histograms": 0})
        acc.Reload()
        tags = acc.Tags()
        assert set(tags["scalars"]) == want_tags
        for line in _metrics(root):
            for k in losses.LossBreakdown._fields:
                (event,) = [e for e in acc.Scalars(f"loss/{k}") if e.step == line["step"]]
                assert event.value == np.float32(line[k]), (k, line["step"])
        names = set(state.model.state_dict())
        assert set(tags["histograms"]) == (names if hist else set())


# ------------------------------------------------------------ refusals


def test_unported_flags_are_refused_by_name(tmp_path, capsys):
    assert train._NOT_PORTED == ("--mesh", "--distributed")
    for flag in train._NOT_PORTED:
        with pytest.raises(SystemExit):
            train.main(_tiny_argv(tmp_path / "m", 1, "--synthetic", flag))
        assert f"{flag} is not ported" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        teval.main(["--list_path", "absent.list", "--mesh", "2", "--device", "cpu"])
    assert "--mesh is not ported" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "m")


def test_debug_nans_flag_leaves_a_finite_run_alone(tmp_path):
    """``--debug_nans`` on finite weights trains exactly as without it."""
    runs = []
    for extra in ((), ("--debug_nans",)):
        root = tmp_path / str(len(runs))
        train.main(_tiny_argv(root / "m", 2, "--synthetic", "--synthetic_size", "4", *extra))
        runs.append(torch.load(root / "m" / "ckpt_2.pt", weights_only=True)["model"])
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


def test_compute_dtype_is_a_config_field_only():
    """As in the JAX package, the trainer's CLI has no flag for the compute
    dtype; the config carries it."""
    fields = {f.name for f in dataclasses.fields(train.TrainConfig)}
    assert "compute_dtype" in fields and "tb_histograms" in fields
    assert {f.name for f in dataclasses.fields(jtrain.TrainConfig)} == fields

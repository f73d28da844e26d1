"""The port's trainer (``rfnet_tpu_torch/train.py``) against the JAX package's,
and its loop end to end on the CPU at a tiny size."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rfnet_tpu import losses as jlosses
from rfnet_tpu.data.dataset import synthetic_dataflow as j_synthetic_dataflow
from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu.ops.fps import farthest_point_sample as jfps
from rfnet_tpu.ops.fps import gather_point as jgather
from rfnet_tpu_torch import losses, train
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.data.dataset import synthetic_dataflow
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point

TINY = dict(batch_size=2, eval_size=2, innum=64, ptnum=128, n_seed=4, up_ratio=4)
N1, N2 = 8, 32  # the tiny config's pyramid sizes: 2·n_seed, 2·n_seed·up_ratio


def _batch(rng, b=2):
    gt = rng.rand(b, 128, 3).astype(np.float32)
    partial = (gt[:, :64] + 0.01 * rng.randn(b, 64, 3)).astype(np.float32)
    return partial, gt


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_train_step_matches_jax_loss_breakdown_and_grads(rng):
    """One port train_step from the JAX model's flax parameters: every
    LossBreakdown term to rtol 1e-5; the whole gradient to 1e-4 relative
    L2 and each parameter's to 2e-3 (leaves whose JAX gradient is 0 — the
    final step's unused feature head — get none in the port). The per-leaf
    bound is loose because the random-init output has near ties: 3 % of the
    ground-truth points have a second output point within 1e-6 relative of
    the nearest distance, and the port's sums of squares and the JAX
    expansion may pick different ones, which moves the small gradients of
    the initial state's head by up to 1e-3. Updated parameters are not
    compared: Adam's first step is about −lr·sign(g), which a gradient of
    ~1e-9 can flip between two correct implementations."""
    partial, gt = _batch(rng)
    model = JRFNet(n_seed=4, up_ratio=4)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 3), jnp.float32))

    @jax.jit
    def loss_and_grads(params, partial, gt):
        def loss_fn(p):
            g1 = jgather(gt, jfps(N1, gt))
            g2 = jgather(gt, jfps(N2, gt))
            lb = jlosses.total_loss(model.apply(p, partial), gt, g1, g2, 0)
            return lb.total, lb

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, jlb), jgrads = loss_and_grads(params, jnp.asarray(partial), jnp.asarray(gt))
    state = train.create_state(train.TrainConfig(**TINY), "cpu")
    state.model.load_state_dict(flax_to_state_dict(flatten_params(params["params"])), strict=True)
    lb, diag = train.train_step(state, torch.from_numpy(partial), torch.from_numpy(gt),
                                n1=N1, n2=N2)
    assert state.step == 1
    for name in lb._fields:
        np.testing.assert_allclose(float(getattr(lb, name)), float(getattr(jlb, name)),
                                   rtol=1e-5, atol=1e-9, err_msg=name)
    assert set(diag) == {"code1_first", "code1_nonzero", "code2_nonzero", "code3_nonzero",
                         "code1_max", "code2_max", "code3_max"}
    jg = flax_to_state_dict(flatten_params(jgrads["params"]))
    ours, refs = [], []
    for name, p in state.model.named_parameters():
        ref = jg[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        assert p.grad is not None or not np.any(ref), name
        assert _rel(got, ref) < 2e-3, name
        ours.append(got.ravel())
        refs.append(ref.ravel())
    assert _rel(np.concatenate(ours), np.concatenate(refs)) < 1e-4


def test_train_step_pyr_equals_train_step(rng):
    """The step with the FPS pyramids passed in computes the same step."""
    partial, gt = (torch.from_numpy(a) for a in _batch(rng))
    config = train.TrainConfig(**TINY)
    a, b = train.create_state(config, "cpu"), train.create_state(config, "cpu")
    lb_a, _ = train.train_step(a, partial, gt, n1=N1, n2=N2)
    g1 = gather_point(gt, farthest_point_sample(N1, gt))
    g2 = gather_point(gt, farthest_point_sample(N2, gt))
    lb_b, _ = train.train_step_pyr(b, partial, gt, g1, g2)
    for x, y in zip(lb_a, lb_b):
        assert torch.equal(x, y)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_adam_matches_optax_across_a_schedule_boundary():
    """Identical gradients into the port's optimizer and ``optax.adam`` with
    the schedule: 3 updates, the learning rate dropping at the third (the
    boundary scaled to step 1, strict >). Parameters to rtol 1e-6."""
    scale = 1.0 / 50_000
    rng = np.random.RandomState(3)
    p0 = {"w": rng.randn(4, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10.0**-s for k, v in p0.items()}
             for s in range(3)]
    tx = optax.adam(learning_rate=functools.partial(jlosses.learning_rate, scale=scale))
    jp, opt = dict(p0), None
    opt = tx.init(jp)
    lin = torch.nn.Linear(4, 5)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0["w"].T))
        lin.bias.copy_(torch.from_numpy(p0["b"]))
    state = train.TrainState(lin, torch.optim.Adam(lin.parameters(), lr=0.0, betas=(0.9, 0.999),
                                                   eps=1e-8))
    lrs = []
    for g in grads:
        upd, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, upd)
        lin.weight.grad = torch.from_numpy(g["w"].T.copy())
        lin.bias.grad = torch.from_numpy(g["b"].copy())
        train.apply_gradients(state, scale)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        np.testing.assert_allclose(lin.weight.detach().numpy().T, np.asarray(jp["w"]), rtol=1e-6)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(jp["b"]), rtol=1e-6)
    assert lrs == [5e-4, 5e-4, 2e-4] and state.step == 3


def test_synthetic_dataflow_matches_jax():
    """The same batches in the same order from the same seeds."""
    ours, n = synthetic_dataflow(6, 2, 64, 128, seed=0)
    ref, jn = j_synthetic_dataflow(6, 2, 64, 128, seed=0)
    assert n == jn == 6
    it, jit_ = iter(ours), iter(ref)
    for _ in range(4):  # past the first epoch's end
        got, want = next(it), next(jit_)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == 64
        np.testing.assert_array_equal(got[3], want[3])
    it.close()
    jit_.close()


def test_checkpoints_keep_the_newest_and_restore(tmp_path):
    config = train.TrainConfig(**TINY)
    state = train.create_state(config, "cpu")
    for step in (2, 4, 6):
        state.step = step
        train.save_checkpoint(state, str(tmp_path), max_to_keep=2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_4.pt", "ckpt_6.pt"]
    other = train.create_state(dataclasses.replace(config, seed=9), "cpu")
    assert train.restore_if_available(other, str(tmp_path))
    assert other.step == 6
    for p, q in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(p, q)
    assert not train.restore_if_available(other, str(tmp_path / "empty"))


def _tiny_argv(workdir, steps):
    return ["--synthetic", "--synthetic_size", "8", "--device", "cpu", "--innum", "64",
            "--ptnum", "128", "--n_seed", "4", "--up_ratio", "4", "--batch_size", "2",
            "--steps", str(steps), "--ckpt_every", "2", "--workdir", workdir]


def test_main_synthetic_cpu_checkpoints_eval_best_and_resume(tmp_path, capsys):
    workdir = str(tmp_path / "run" / "model")
    train.main(_tiny_argv(workdir, 4))
    text = capsys.readouterr().out
    assert "eval @ 2:" in text and "eval @ 4:" in text and "trained 4 steps" in text
    assert sorted(os.listdir(workdir)) == ["ckpt_2.pt", "ckpt_4.pt"]
    best_dir = tmp_path / "run" / "bestrecord"
    best = json.loads((best_dir / "best.json").read_text())
    assert best["step"] in (2, 4) and np.isfinite(best["cd"]) and best["cd"] > 0
    assert (best_dir / "model.pt").exists()
    metrics = tmp_path / "run" / "logs" / "metrics.jsonl"
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    evals = [x for x in lines if "eval_cd" in x]
    assert [x["step"] for x in evals] == [2, 4]
    assert all(np.isfinite(x["eval_cd"]) and np.isfinite(x["eval_emd"]) for x in evals)
    # resume: the latest checkpoint and the best record are read back
    train.main(_tiny_argv(workdir, 5))
    text = capsys.readouterr().out
    assert "restored checkpoint at step 4" in text
    assert f"best-so-far cd {best['cd']:.6f}" in text
    assert "trained 1 steps (now at step 5)" in text


def test_main_rejects_unported_data_and_bad_pyramid(tmp_path, monkeypatch):
    argv = _tiny_argv(str(tmp_path / "m"), 1)
    with pytest.raises(SystemExit):  # an LMDB that is not there
        train.main([a for a in argv if a != "--synthetic"]
                   + ["--train_path", str(tmp_path / "absent.lmdb"),
                      "--val_path", str(tmp_path / "absent_val.lmdb")])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit):  # --distributed outside torchrun
        train.main(argv + ["--distributed"])
    bad = list(argv)
    bad[bad.index("--ptnum") + 1] = "100"
    with pytest.raises(SystemExit):
        train.main(bad)
    assert not os.path.exists(tmp_path / "m")


def test_train_loop_logs_every_step(tmp_path, capsys):
    """``log_every`` 1 prints the reference's two lines and appends the
    scalars of every step to logs/metrics.jsonl."""
    config = train.TrainConfig(**TINY, iters=2, log_every=1, ckpt_every=100,
                               workdir=str(tmp_path / "m"))
    df, _ = synthetic_dataflow(4, 2, 64, 128)
    vdf, vn = synthetic_dataflow(2, 2, 64, 128, is_training=False)
    state = train.train(config, df, vdf, vn, device="cpu")
    assert state.step == 2
    text = capsys.readouterr().out
    assert text.count("clouds/s") == 2 and text.count("max of code1 first") == 2
    lines = [json.loads(x) for x in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert set(lines[0]) == {"step", *losses.LossBreakdown._fields}


def test_main_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the trainer asks for CUDA, and where there is
    none it stops with an error instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _tiny_argv(str(tmp_path / "m"), 1) if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(argv)


def test_create_state_defaults_to_the_card(monkeypatch):
    """``create_state`` without a device builds on CUDA, and where there is
    none it stops with an error instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.create_state(train.TrainConfig(**TINY))

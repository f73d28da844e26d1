"""Gloo process groups on the CPU for the port's data-parallel tests.

:func:`run` starts ``world`` processes (spawned, so each starts from a
fresh import of torch and the port, never JAX), forms a gloo group over a
``file://`` rendezvous in the test's own directory (no port to race for
under pytest-xdist), calls ``fn(mesh, *args)`` in each with the rank's
:class:`~rfnet_tpu_torch.parallel.Mesh`, and returns the ranks' results in
rank order. A rank that raises fails the call with its traceback at once
(the others are killed, not left waiting in a collective), and the whole
call is bounded by a timeout.

The worker functions live here, not in the test files, so that a spawned
rank imports this module (torch and the port) and not the test files,
which import JAX.
"""

from __future__ import annotations

import contextlib
import io
import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = 240  # seconds for a whole call
TINY = dict(innum=64, ptnum=128, n_seed=4, up_ratio=4)


def _entry(fn, rank: int, world: int, out_dir: str, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                                world_size=world, timeout=timedelta(seconds=60))
        from rfnet_tpu_torch import train
        from rfnet_tpu_torch.parallel import make_mesh

        # no TensorBoard writer in a rank: importing tensorboard may pull in
        # TensorFlow, seconds a process
        train._tb_writer = lambda logdir: None
        result = fn(make_mesh(world, "cpu"), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)  # no cleanup that could wait on the other ranks


def run(fn, world: int, out_dir, *args, timeout: float = TIMEOUT) -> list:
    """``fn(mesh, *args)`` on ``world`` gloo ranks; their results in rank
    order. ``out_dir`` is a fresh directory for the rendezvous and results."""
    out_dir = str(out_dir)
    os.makedirs(out_dir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, out_dir, args), daemon=True)
             for r in range(world)]
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # each rank one thread: the ranks share the cores
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{fn.__name__} on {world} ranks: no result in {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{fn.__name__} on {world} ranks failed (exit codes "
                             f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- workers


def sharded_ops(mesh, cases: dict) -> dict:
    """Each case through ``ops.sharded``; a ValueError is returned as its
    message."""
    from rfnet_tpu_torch.ops import sharded

    out = {}
    for name, (fn, x1, x2) in cases.items():
        try:
            res = getattr(sharded, fn)(torch.from_numpy(x1), torch.from_numpy(x2), mesh)
        except ValueError as exc:
            out[name] = str(exc)
            continue
        out[name] = [t.numpy() for t in res] if isinstance(res, tuple) else res.numpy()
    return out


@contextlib.contextmanager
def _recording_steps(train, seen: list):
    """Record each ``train_step_pyr`` call's (partial, gt, loss terms) in
    ``seen`` while the block runs."""
    step_pyr = train.train_step_pyr

    def recording(state, partial, gt, *rest, **step_kw):
        lb, diag = step_pyr(state, partial, gt, *rest, **step_kw)
        seen.append((partial.clone(), gt.clone(), {k: float(v) for k, v in lb._asdict().items()}))
        return lb, diag

    train.train_step_pyr = recording
    try:
        yield
    finally:
        train.train_step_pyr = step_pyr


def train_step(mesh, weights: dict, partial: np.ndarray, gt: np.ndarray, batch: int) -> dict:
    """One ``train_step`` of this rank's rows of the global batch from
    ``weights``: the global loss terms and diagnostics, the all-reduced
    gradients and the parameters after the update (mesh None: one process
    on the whole batch)."""
    from rfnet_tpu_torch import train

    config = train.TrainConfig(batch_size=batch, **TINY)
    state = train.create_state(config, "cpu")
    state.model.load_state_dict(weights)
    rows = slice(None) if mesh is None else mesh.rows(batch)
    lb, diag = train.train_step(state, torch.from_numpy(partial[rows]),
                                torch.from_numpy(gt[rows]), n1=8, n2=32, mesh=mesh)
    return {"lb": {k: float(v) for k, v in lb._asdict().items()},
            "diag": {k: float(v) for k, v in diag.items()},
            "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()
                      if p.grad is not None},
            "params": {k: v.clone() for k, v in state.model.state_dict().items()}}


def nan_step(mesh, partial: np.ndarray, gt: np.ndarray, batch: int) -> dict:
    """Two ``--debug_nans`` steps where rank 1's rows of the second batch
    hold a NaN: the step and message at which this rank raised."""
    from rfnet_tpu_torch import train

    state = train.create_state(train.TrainConfig(batch_size=batch, **TINY), "cpu")
    rows = mesh.rows(batch)
    for step in range(2):
        p = torch.from_numpy(partial[rows]).clone()
        if step == 1 and mesh.rank == 1:
            p[0, 0, 0] = float("nan")
        try:
            train.train_step(state, p, torch.from_numpy(gt[rows]), n1=8, n2=32,
                             debug_nans=True, mesh=mesh)
        except FloatingPointError as exc:
            return {"step": step, "error": str(exc)}
    return {"step": None, "error": None}


def train_run(mesh, root: str, config_kw: dict, data: dict, kw: dict) -> dict:
    """``train.train`` on this rank with the mesh (None: one process): the
    steps it took (:func:`_recording_steps`), the eval means, the parameters
    at the end and, on rank 0, the lines of metrics.jsonl and the files
    written."""
    from rfnet_tpu_torch import train
    from rfnet_tpu_torch.data.dataset import synthetic_dataflow

    config = train.TrainConfig(workdir=os.path.join(root, "model"), **TINY, **config_kw)
    df = None
    if data.get("train") is not None:
        df, _ = synthetic_dataflow(*data["train"], config.innum, config.ptnum,
                                   **data.get("shard", {}))
    vdf, vn = synthetic_dataflow(*data["valid"], config.innum, config.ptnum, is_training=False,
                                 seed=1234, **data.get("shard", {}))
    seen, evals = [], []
    evaluate = train.evaluate

    def recording_eval(*args, **eval_kw):
        evals.append(evaluate(*args, **eval_kw))
        return evals[-1]

    train.evaluate = recording_eval
    buf = io.StringIO()
    try:
        with _recording_steps(train, seen), contextlib.redirect_stdout(buf):
            state = train.train(config, df, vdf, vn, "cpu", mesh=mesh, **kw)
    finally:
        train.evaluate = evaluate
    out = {"seen": seen, "evals": evals, "stdout": buf.getvalue(),
           "params": {k: v.clone() for k, v in state.model.state_dict().items()}}
    if mesh is None or mesh.is_lead:
        with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
            out["metrics"] = f.read()
        out["files"] = sorted(os.listdir(config.workdir))
    return out


def hinge(mesh, ptcens: np.ndarray, rawpts: np.ndarray, outmat: np.ndarray) -> dict:
    """``losses.zero_groupnear`` of this rank's rows with the mesh: its value
    and its gradient with respect to this rank's rows of ``outmat``."""
    from rfnet_tpu_torch import losses

    rows = mesh.rows(outmat.shape[0])
    out = torch.from_numpy(outmat[rows]).requires_grad_()
    value = losses.zero_groupnear(torch.from_numpy(ptcens[rows]),
                                  torch.from_numpy(rawpts[rows]), out, mesh)
    value.backward()
    return {"value": float(value), "grad": out.grad}


def cli(mesh, module: str, argv: list) -> dict:
    """``main(argv)`` of ``rfnet_tpu_torch.<module>`` in this rank (the
    global numpy RNG seeded 0 first, as the eval loader pads from it): its
    standard output and the steps the trainer took (:func:`_recording_steps`)."""
    import importlib

    from rfnet_tpu_torch import train

    seen = []
    np.random.seed(0)
    buf = io.StringIO()
    with (_recording_steps(train, seen) if module == "train" else
          contextlib.nullcontext()), contextlib.redirect_stdout(buf):
        importlib.import_module(f"rfnet_tpu_torch.{module}").main(argv)
    return {"stdout": buf.getvalue(), "seen": seen}


def suite(mesh, tasks: list) -> list:
    """Several workers in one group, in order: ``[fn(mesh, *args) for fn,
    args in tasks]`` (one spawn for many checks)."""
    out = []
    for fn, args in tasks:
        mesh.barrier()
        out.append(fn(mesh, *args))
    return out

"""Shared measurement protocol of the port's tools (the counterpart of
``tools/_common.py``), for PyTorch on one CUDA card.

One ``timeit`` implements the timing rule of every number these tools
print: one first call (which builds the kernels it reaches), ``warmups``
more, then ``iters`` calls between two ``torch.cuda.Event``s and one
``synchronize()``, so the window holds many launches and the host's
enqueue overlaps the card's work. On the CPU (the tests) the window is the
host clock around the same calls. Changing the protocol here changes every
tool at once.

Importing this module also puts the repo root on ``sys.path``. It imports
no JAX.
"""

from __future__ import annotations

import json
import os as _os
import subprocess
import sys as _sys
import time

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO not in _sys.path:
    _sys.path.insert(0, _REPO)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch.checkpoints import load_state, weights_file  # noqa: E402
from rfnet_tpu_torch.parallel import resolve_device  # noqa: E402,F401  (refuses a missing card)
from rfnet_tpu_torch.models import RFNet  # noqa: E402

# the converged weights (step 105000 of run_r4, held-out cd 0.023168)
WEIGHTS = _os.path.join(_REPO, "weights", "rfnet_r4_105000.npz")
# the tools' --tiny widths: TrainConfig fields
TINY = dict(innum=64, ptnum=128, n_seed=4, up_ratio=4)


def tool_model(config, device: torch.device, checkpoint: str | None = None,
               dtype: torch.dtype | None = None) -> RFNet:
    """The model a tool measures, on ``device``, its feature MLPs in
    ``dtype`` (None = float32): the weights of ``checkpoint`` (any form
    ``checkpoints.load_state`` takes; a path that holds none is an error), or for
    None the random init ``train.create_state`` draws for ``config``."""
    if checkpoint is None:
        model = RFNet(n_seed=config.n_seed, up_ratio=config.up_ratio, dtype=dtype,
                      generator=torch.Generator().manual_seed(config.seed))
    elif weights_file(checkpoint) is None:
        raise SystemExit(f"{checkpoint}: no weights there")
    else:
        with contextlib.redirect_stdout(_sys.stderr):
            model = load_state(checkpoint, dtype=dtype)
    return model.to(device).eval()


def rand_clouds(rng: np.random.RandomState, b: int, sizes, device) -> list[torch.Tensor]:
    """(b, n, 3) uniform clouds on ``device``, one for each n of ``sizes``,
    drawn from ``rng`` in that order."""
    return [torch.from_numpy(rng.rand(b, n, 3).astype(np.float32)).to(device) for n in sizes]


def fabricated_outputs(config, b: int, device):
    """The loss tools' inputs as the JAX tools draw them: ``RandomState(0)``
    clouds partial (b, innum), gt (b, ptnum), gt1 and gt2 (b, the pyramid
    sizes), and the outputs of the model's seeded random init for that
    partial, detached: fabricated outputs with the model's real shapes.
    Returns (outputs, gt, gt1, gt2)."""
    from bench_torch import pyramid_sizes

    partial, gt, gt1, gt2 = rand_clouds(np.random.RandomState(0), b,
                                        (config.innum, config.ptnum, *pyramid_sizes(config)),
                                        device)
    with torch.no_grad():
        outputs = tool_model(config, torch.device(device))(partial)
    return outputs, gt, gt1, gt2


def loss_grads(loss, outputs, *args):
    """(value, {field: gradient}) of ``loss(outputs, *args)`` in every field
    of the model's ``outputs`` (None where a field takes none), as
    ``jax.value_and_grad`` in the outputs gives them."""
    leaves = {f.name: getattr(outputs, f.name).detach().requires_grad_()
              for f in dataclasses.fields(outputs)}
    val = loss(type(outputs)(**leaves), *args)
    g = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
    return val.detach(), dict(zip(leaves, g))


def grads(f, *xs):
    """Gradients of ``f(*xs)`` in ``xs``."""
    xs = [x.detach().requires_grad_() for x in xs]
    return torch.autograd.grad(f(*xs), xs)


def emit(result: dict) -> dict:
    """Print ``result`` as the tool's last line, one JSON object."""
    print(json.dumps(result), flush=True)
    return result


def require(cond: bool, msg: str) -> None:
    """Stop the tool with a non-zero exit where a check of its results
    fails."""
    if not cond:
        raise SystemExit(f"check failed: {msg}")


def timeit(name, fn, *args, iters: int = 10, warmups: int = 2,
           device: torch.device | str = "cuda", width: int = 32) -> float:
    """ms a call of ``fn(*args)``: the mean over ``iters`` calls after one
    first call and ``warmups`` more. Prints ``name: ms`` unless ``name`` is
    empty."""
    cuda = torch.device(device).type == "cuda"
    fn(*args)
    for _ in range(warmups):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        ms = (time.perf_counter() - t0) / iters * 1e3
    if name:
        print(f"{name:{width}s}: {ms:8.3f} ms", flush=True)
    return ms


def device_info(device: torch.device | str) -> dict:
    """``{"name", "power_limit_w", "count", "smi"}`` of the device the numbers
    come from: for the card, ``torch.cuda.get_device_name`` and the name and
    power limit ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints (``smi``, its line as printed); for the
    CPU, the name ``cpu`` and no power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 1, "smi": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[index]
    limit = smi.rsplit(",", 1)[1].strip()
    return {"name": torch.cuda.get_device_name(index),
            "power_limit_w": float(limit.split()[0]) if limit[:1].isdigit() else None,
            "count": torch.cuda.device_count(), "smi": smi}

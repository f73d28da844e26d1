"""The port's weight files: the trainer's checkpoints and what a served
``--checkpoint`` path holds.

The trainer writes ``<workdir>/ckpt_<step>.pt`` (``torch.save`` of
``{"model", "optimizer", "step"}``, the newest ``max_to_keep`` kept) and a
best record ``<workdir>/../bestrecord/``: ``model.pt`` (the ``state_dict``
of the best eval CD so far) and ``best.json`` (``{"step", "cd"}``).

A served path is a ``bestrecord/`` (its ``model.pt``), a workdir (the
``"model"`` of its newest ``ckpt_<step>.pt``), one ``ckpt_<step>.pt``, a
``torch.save``d ``state_dict`` or an ``.npz`` of flat flax params
(``{"a/b/leaf": array}``, the step under ``__step__``) such as
``weights/rfnet_r4_105000.npz``, whose legacy shared step biases are
upgraded on the way (``compat.ckpt_compat``). The network is the one whose
weights the file holds (``models.network_of``), built to their sizes.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

from rfnet_tpu_torch.compat import ckpt_compat
from rfnet_tpu_torch.compat.convert import flax_to_state_dict

CHECKPOINT_NAME = re.compile(r"ckpt_(\d+)\.pt")  # the trainer's checkpoint files
BEST_WEIGHTS, BEST_META = "model.pt", "best.json"  # the files of a bestrecord/
RANDOM_INIT_SEED = 1  # the JAX TrainConfig's default seed


def list_checkpoints(workdir: str) -> list[tuple[int, str]]:
    """(step, path) of every ``ckpt_<step>.pt`` in ``workdir``, oldest first."""
    found = []
    for path in glob.glob(os.path.join(workdir, "ckpt_*.pt")):
        m = CHECKPOINT_NAME.fullmatch(os.path.basename(path))
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(state, workdir: str, max_to_keep: int) -> str:
    """Write ``state``'s model, optimizer and step as ``ckpt_<step>.pt`` and
    drop all but the newest ``max_to_keep``."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"ckpt_{state.step}.pt")
    _save_atomic({"model": state.model.state_dict(),
                  "optimizer": state.optimizer.state_dict(), "step": state.step}, path)
    for _, old in list_checkpoints(workdir)[:-max_to_keep]:
        os.remove(old)
    return path


def restore_if_available(state, workdir: str) -> bool:
    """Load the latest checkpoint of ``workdir`` into ``state``, if any."""
    found = list_checkpoints(workdir)
    if not found:
        return False
    step, path = found[-1]
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    print(f"restored checkpoint at step {state.step} ({path})")
    return True


def read_state_dict(path: str) -> tuple[dict, int | None]:
    """(state_dict, step) of a ``.pt``: a trainer checkpoint's model and
    step, or a saved ``state_dict`` and None."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if CHECKPOINT_NAME.fullmatch(os.path.basename(path)):
        return obj["model"], obj["step"]
    return obj, None


def best_record(workdir: str) -> str:
    """The trainer's best record of the run in ``workdir``."""
    return os.path.join(workdir, "..", "bestrecord")


def read_best(record: str) -> tuple[float, str]:
    """(the best eval CD that ``record`` holds, inf where none; the file
    that holds it)."""
    meta = os.path.join(record, BEST_META)
    try:
        with open(meta) as f:
            return float(json.load(f)["cd"]), meta
    except FileNotFoundError:
        return float("inf"), meta


def save_best(record: str, model: torch.nn.Module, step: int, cd: float) -> None:
    """Write ``model``'s weights and their (step, cd) as the best record."""
    os.makedirs(record, exist_ok=True)
    _save_atomic(model.state_dict(), os.path.join(record, BEST_WEIGHTS))
    with open(os.path.join(record, BEST_META), "w") as f:
        json.dump({"step": step, "cd": cd}, f)


def is_best_record(path: str) -> bool:
    return os.path.isfile(os.path.join(path, BEST_WEIGHTS))


def _npz_step(z) -> int | None:
    return int(z["__step__"]) if "__step__" in z.files else None


def stored_step(path: str) -> int | None:
    """The training step of the weights at ``path``, as a ``ckpt_<step>.pt``
    name, an ``.npz``'s ``__step__`` or a best record's ``best.json`` gives
    it; None where none does."""
    if m := CHECKPOINT_NAME.fullmatch(os.path.basename(path)):
        return int(m.group(1))
    if path.endswith(".npz"):
        with np.load(path) as z:
            return _npz_step(z)
    if os.path.isfile(meta := os.path.join(path, BEST_META)):
        with open(meta) as f:
            return int(json.load(f)["step"])
    return None


def weights_file(checkpoint: str) -> str | None:
    """The file that holds ``checkpoint``'s weights: the file itself; for a
    directory its ``model.pt`` (the trainer's ``bestrecord/``), else its
    newest ``ckpt_<step>.pt`` (a workdir); None where there is neither."""
    if os.path.isfile(checkpoint):
        return checkpoint
    if not os.path.isdir(checkpoint):
        return None
    if is_best_record(checkpoint):
        return os.path.join(checkpoint, BEST_WEIGHTS)
    found = list_checkpoints(checkpoint)
    return found[-1][1] if found else None


def load_state(checkpoint: str | None, dtype: torch.dtype | None = None,
               model: str | None = None, sizes: dict | None = None) -> torch.nn.Module:
    """The network with weights from ``checkpoint`` (a directory or a file,
    as the module docstring lists); its feature MLPs compute in ``dtype``
    (None = float32; SnowflakeNet only float32). ``model`` (a name of
    ``models.MODELS``) names the network; None: the checkpoint's keys tell,
    and ``models.DEFAULT`` (RFNet) where there are none. ``sizes``: the sizes its weights do not
    hold (SnowflakeNet's ``num_p0``, ``radius``, ``sa_points``,
    ``input_points``), as published where None.

    Where ``checkpoint`` is None or holds no weights, warns and returns the
    full-size network's random init, drawn from a generator seeded
    ``RANDOM_INIT_SEED``."""
    # imported here: a process that only reads the layout (such as
    # tools/protocol_drive_torch.py) then imports no kernel module, and adds
    # no line to a kernels.LAUNCH_LOG_ENV log
    from rfnet_tpu_torch.models import DEFAULT, MODELS, network_of

    if model not in (None, *MODELS):
        raise SystemExit(f"--model {model}: one of {', '.join(MODELS)}")
    path = None if checkpoint is None else weights_file(checkpoint)
    if path is None:
        print(f"WARNING: no checkpoint under {checkpoint}; evaluating random init")
        g = torch.Generator().manual_seed(RANDOM_INIT_SEED)
        return MODELS[model or DEFAULT](generator=g, dtype=dtype, **(sizes or {}))
    flat = None
    if path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files if not k.startswith("__")}
            step = _npz_step(z)
        print(f"checkpoint {path}: step {step}")
        state_dict = flax_to_state_dict(flat)
    else:
        state_dict, step = read_state_dict(path)
        if step is not None:
            print(f"checkpoint {path}: step {step}")
    name = network_of(state_dict)
    if model not in (None, name):
        raise SystemExit(f"{path} holds {MODELS[name].__name__} weights, not --model {model}'s")
    net = MODELS[name].for_weights(state_dict, sizes, dtype)
    if flat is not None:
        flat, upgraded = ckpt_compat.upgrade(flat, ckpt_compat.expected_shapes(net.state_dict()))
        if upgraded:
            print("checkpoint upgraded from legacy shared-bias layout")
        state_dict = flax_to_state_dict(flat)
    net.load_state_dict(state_dict, strict=True)
    return net

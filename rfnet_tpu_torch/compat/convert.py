"""Carry flax parameters of the JAX ``RFNet`` across to the port's model.

The input is the flax parameter tree flattened to ``{"path/to/leaf":
ndarray}`` (npz-compatible; a leading ``params/`` is accepted). The port
names its modules after the flax tree, so the mapping is a rename:

* ``…/kernel`` (flax ``(in, out)``) → ``….weight`` transposed to torch's
  ``(out, in)``; this covers ``Dense`` and ``StepDense`` alike;
* ``…/bias`` → ``….bias`` unchanged: ``(ch,)``, or ``(n_steps, ch)`` for a
  per-step bias table;
* the decline factors (shape ``(1,)``) keep their names.

The result loads into :class:`~rfnet_tpu_torch.models.RFNet` with
``strict=True``. :func:`state_dict_to_flax` is the inverse, and
:func:`save_npz` writes its result as an ``.npz`` in the layout of
``weights/rfnet_r4_105000.npz`` (flax leaf paths, float32, the training step
under ``__step__``), which the eval CLI serves and the JAX package reads as
``{"params": unflattened}``: weights trained by the port reach the JAX
package.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested mapping of arrays (a flax params dict) -> ``{"a/b/leaf": array}``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_to_state_dict(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax params -> a torch ``state_dict`` for the port's ``RFNet``."""
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{path}: expected a 2-D kernel, got shape {arr.shape}")
            parts[-1], arr = "weight", arr.T
        out[".".join(parts)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A port ``state_dict`` -> flat flax params ``{"a/b/leaf": ndarray}``
    (float32): the inverse of :func:`flax_to_state_dict`."""
    flat: dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        arr = tensor.detach().cpu().numpy().astype(np.float32)
        if parts[-1] == "weight":
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D weight, got shape {arr.shape}")
            parts[-1], arr = "kernel", arr.T
        flat["/".join(parts)] = np.ascontiguousarray(arr)
    return flat


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor], step: int) -> None:
    """Write ``state_dict`` as flat flax params with ``__step__``, uncompressed."""
    np.savez(path, __step__=np.int64(step), **state_dict_to_flax(state_dict))

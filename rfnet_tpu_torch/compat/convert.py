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
``strict=True``.
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

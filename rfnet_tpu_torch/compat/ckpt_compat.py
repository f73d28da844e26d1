"""Upgrade flax parameters saved before the per-step-bias layout.

The JAX package's ``rfnet_tpu/compat/ckpt_compat.py`` rule, on flat
``{"a/b/leaf": ndarray}`` params (the input of
:func:`rfnet_tpu_torch.compat.convert.flax_to_state_dict`): the ``cell`` and
``decode_cell`` biases were once one shared ``(ch,)`` vector a layer and are
now a ``(n_steps, ch)`` table, one row for each recurrent step. A legacy
``(ch,)`` bias where the model expects ``(n_steps, ch)`` is broadcast into
every step row, which is the state the old model was in (every step used
the one bias), so the upgraded weights give the legacy model's forward.
Any other shape mismatch raises, naming the leaf.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def expected_shapes(state_dict: Mapping[str, torch.Tensor]) -> dict[str, tuple[int, ...]]:
    """The flax leaf path and shape of each entry of a port ``state_dict``
    (the inverse of ``flax_to_state_dict``'s rename: ``….weight`` of shape
    ``(out, in)`` is the flax ``…/kernel`` of shape ``(in, out)``)."""
    shapes = {}
    for name, tensor in state_dict.items():
        parts, shape = name.split("."), tuple(tensor.shape)
        if parts[-1] == "weight":
            parts[-1], shape = "kernel", shape[::-1]
        shapes["/".join(parts)] = shape
    return shapes


def _is_step_bias(path: str) -> bool:
    keys = path.split("/")
    return keys[-1] == "bias" and ("cell" in keys or "decode_cell" in keys)


def upgrade(flat: Mapping[str, np.ndarray],
            expected: Mapping[str, tuple[int, ...]]) -> tuple[dict[str, np.ndarray], bool]:
    """``flat`` with every legacy shared step bias broadcast to the shape
    ``expected`` gives its path (a leading ``params/`` is ignored); returns
    (the params, whether any leaf was upgraded). A leaf whose shape differs
    from ``expected`` in any other way raises ValueError; leaves missing
    from either side are left to ``load_state_dict(strict=True)``."""
    out: dict[str, np.ndarray] = {}
    upgraded = False
    for path, value in flat.items():
        key = path[len("params/"):] if path.startswith("params/") else path
        arr = np.asarray(value)
        want = expected.get(key)
        if want is not None and arr.shape != want:
            if _is_step_bias(key) and len(want) == 2 and arr.shape == want[1:]:
                arr = np.ascontiguousarray(np.broadcast_to(arr[None], want))
                upgraded = True
            else:
                raise ValueError(f"checkpoint leaf {path}: shape {arr.shape}, the model "
                                 f"expects {want}")
        out[path] = arr
    return out, upgraded

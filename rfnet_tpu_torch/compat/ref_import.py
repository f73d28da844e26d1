"""Reference TF checkpoints ↔ the port's ``RFNet`` weights, both ways.

Port of ``rfnet_tpu/compat/ref_import.py``. The reference trains
`vv_recon.py`'s graph with TF1 and saves TensorBundle checkpoints
(`vv_recon.py:461-550`, `bestrecord/`). :func:`reference_variable_map` maps
every trainable variable of that graph, shape-checked and 1:1, onto an entry
of the port's ``state_dict``, so users can

* **import** a trained reference checkpoint (:func:`import_reference_checkpoint`)
  and serve or fine-tune it on the card;
* **export** the port's weights as a reference-named TF bundle
  (:func:`export_reference_checkpoint`) that ``tf.train.load_checkpoint`` /
  ``init_from_checkpoint`` read.

Name mapping facts (fixed by the trained artifact
`bestrecord/model-229999.index`):

* TF 1×1-conv kernels ``[1, 1, in, out]`` are the port's ``….weight``
  ``(out, in)``: squeezed and transposed, as ``compat.convert`` transposes
  a flax kernel;
* conv biases are named ``<scope>/Variable`` (``get_bias_variable``,
  `vv_recon.py:40-43`);
* the recurrent scopes share KERNELS only: ``tf.Variable`` biases ignore
  ``reuse=True``, so invocations 2 and 3 of `encode_cell` and invocation 2
  of `decode_cell` create fresh bias variables under uniquified scopes
  (``cell_1/ cell_2/ decode_cell_1/``, bias-only in the checkpoint). The
  port keeps them as rows of one ``(n_steps, ch)`` bias table
  (:class:`rfnet_tpu_torch.nn.StepDense`);
* entries that are not model weights (``Variable`` = global step,
  ``beta?_power`` and ``*/Adam*`` = Adam state, ``subvar*`` = untrained
  [b,16384,1] buffers absent from the current reference source) are
  ignored.

CLI, with the flags of the JAX package's ``tools/import_ref_ckpt.py``::

    # TF bundle -> <workdir>/ckpt_<step>.pt (the trainer's format, a fresh
    # Adam state): the eval CLI serves it, the trainer resumes from it
    python -m rfnet_tpu_torch.compat.ref_import \\
        --ref_prefix /path/to/bestrecord/model-229999 --workdir ./modelvv_recon
    # the newest ckpt_<step>.pt of --workdir (or --step's) -> TF bundle
    python -m rfnet_tpu_torch.compat.ref_import --export \\
        --workdir ./modelvv_recon --ref_prefix /path/out/model-0

Import needs the whole bundle (``.index`` and ``.data-*``); the reference
checkout ships only the ``.index``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from collections.abc import Mapping

import numpy as np
import torch

from rfnet_tpu_torch.compat import tf_bundle

#: checkpoint entries that are not model weights
IGNORED_PREFIXES = ("Variable", "beta1_power", "beta2_power", "subvar")


def _key(path: tuple[str, ...]) -> str:
    """The port's ``state_dict`` key of a flax leaf path."""
    *modules, leaf = path
    return ".".join([*modules, "weight" if leaf == "kernel" else leaf])


def reference_variable_map() -> dict[str, tuple[str, str, int | None]]:
    """{ref_name: (kind, state_dict key, bias_row)} over every trainable
    variable of the reference graph.

    ``kind`` is 'kernel', 'bias' or 'raw'; ``bias_row`` selects the row of a
    per-step bias table (None for a plain ``(ch,)`` bias)."""
    m = {}

    def conv(ref_scope, path, row=None, bias_only=False):
        if not bias_only:
            m[ref_scope + "/weights"] = ("kernel", _key(path + ("kernel",)), None)
        m[ref_scope + "/Variable"] = ("bias", _key(path + ("bias",)), row)

    # encode cell: kernels live in cell/, biases per step (cell, cell_1, cell_2)
    cellmap = {
        "codemlp0": ("cell", "code_mlp", "l0"),
        "codemlp1": ("cell", "code_mlp", "l1"),
        "state0": ("cell", "state_mlp", "l0"),
        "state1": ("cell", "state_mlp", "l1"),
        "state_end": ("cell", "state_end"),
    }
    for step, scope in enumerate(("cell", "cell_1", "cell_2")):
        for ref_key, path in cellmap.items():
            conv(f"{scope}/{ref_key}", path, row=step, bias_only=step > 0)

    # decode cell: kernels in decode_cell/, biases per step (…, decode_cell_1)
    decmap = {
        "basic_state0": ("mlp", "l0"),
        "basic_state1": ("mlp", "l1"),
        "input_trans": ("input_trans",),
        "mask_tensor": ("mask_out",),
        "mlp_mask0": ("mask_mlp", "l0"),
        "mlp_mask1": ("mask_mlp", "l1"),
        "points0": ("points_mlp", "l0"),
        "points1": ("points_mlp", "l1"),
        "points_out": ("points_out",),
        "state0": ("state_mlp", "l0"),
        "state1": ("state_mlp", "l1"),
        "state_trans": ("state_trans",),
    }
    for i in range(16):
        decmap[f"state_expand{i}"] = (f"expand{i}",)
        decmap[f"state_expand{i}_0"] = (f"expand{i}_pre", "l0")
    for step, scope in enumerate(("decode_cell", "decode_cell_1")):
        for ref_key, path in decmap.items():
            conv(f"{scope}/{ref_key}", ("decode_cell",) + path, row=step,
                 bias_only=step > 0)

    # init_move_layer builds its convs OUTSIDE any variable scope
    # (`vv_recon.py:140-159`), so its layers sit at the checkpoint top level
    for i in range(3):
        conv(f"ini_layer{i}", ("init_move", "mlp", f"l{i}"))
    for i in range(2):
        conv(f"ini_featout{i}", ("init_move", "featmlp", f"l{i}"))
    conv("inimove_featout", ("init_move", "featout"))
    for i in range(3):
        conv(f"ini_ptsout{i}", ("init_move", "ptsmlp", f"l{i}"))
    conv("inimove_ptsout", ("init_move", "ptsout"))
    for i in range(2):  # feat_trans (`vv_recon.py:208`) — also top level
        conv(f"partfeat{i}", ("feat_trans", f"l{i}"))

    for scope in ("init_mlp", "part_mlp"):  # global_mlp instances
        for i in range(3):
            conv(f"{scope}/ini_layer{i}", (scope, "mlp", f"l{i}"))

    for n in (1, 2, 3):  # recover_cell per step
        conv(f"recover{n}/recover20", (f"recover{n}", "mlp", "l0"))
        conv(f"recover{n}/recover21", (f"recover{n}", "mlp", "l1"))
        conv(f"recover{n}/recover2out1", (f"recover{n}", "out"))

    icmap = {
        "basic_state0": ("mlp", "l0"),
        "basic_state1": ("mlp", "l1"),
        "input_trans": ("input_trans",),
        "points_out": ("points_out",),
        "state0": ("state_mlp", "l0"),
        "state1": ("state_mlp", "l1"),
        "state_out": ("state_out",),
        "state_outo": ("state_outo",),
    }
    for ref_key, path in icmap.items():
        conv(f"init_cell/{ref_key}", ("init_cell",) + path)

    for scope in ("refine_layer1", "refine_layer2", "refine_layer_final"):
        for i in range(3):
            conv(f"{scope}/refine_layers{i}", (scope, "mlp", f"l{i}"))
        conv(f"{scope}/refine_layer_final", (scope, "out"))
        for i in range(2):
            conv(f"{scope}/ini_layer{i}", (scope, "self_mlp", f"l{i}"))
        for i in range(2):
            conv(f"{scope}/feat_refine{i}", (scope, "feat_mlp", f"l{i}"))
        conv(f"{scope}/feat_refine_final", (scope, "feat_out"))

    for name in ("decline_factor", "decline_factor0", "decline_factor1"):
        m[name] = ("raw", name, None)
    return m


def _state_dict(model_or_state_dict) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_state_dict, torch.nn.Module):
        return model_or_state_dict.state_dict()
    return model_or_state_dict


def import_reference_checkpoint(prefix: str, model_or_state_dict) -> dict[str, torch.Tensor]:
    """A ``state_dict`` of the weights in the reference TF checkpoint
    ``prefix`` (the path without extension: ``<prefix>.index`` and its
    ``.data-*`` shard), for ``model_or_state_dict``'s model, which it loads
    into with ``strict=True``; only its shapes are read. Every trainable
    reference variable is consumed and every entry fully assigned: a partial
    or shape-mismatched checkpoint raises ValueError."""
    target = _state_dict(model_or_state_dict)
    mapping = reference_variable_map()
    tensors = tf_bundle.read_bundle(prefix, names=set(mapping))
    missing = sorted(set(mapping) - set(tensors))
    if missing:
        raise ValueError(
            f"reference checkpoint is missing {len(missing)} expected "
            f"variables, e.g. {missing[:5]} — wrong model or truncated save?"
        )

    out: dict[str, np.ndarray] = {}
    for ref_name, (kind, key, row) in mapping.items():
        arr = np.asarray(tensors[ref_name], dtype=np.float32)
        tshape = tuple(target[key].shape)
        if kind == "kernel":
            if arr.shape[:2] != (1, 1) or arr.shape[2:] != tshape[::-1]:
                raise ValueError(f"{ref_name}: shape {arr.shape} does not map to {key} {tshape}")
            out[key] = arr.reshape(tshape[::-1]).T
        elif kind == "bias" and row is not None:
            if arr.shape != tshape[1:]:
                raise ValueError(f"{ref_name}: bias shape {arr.shape} vs row shape "
                                 f"{tshape[1:]} at {key}")
            out.setdefault(key, np.zeros(tshape, np.float32))[row] = arr
        else:  # plain bias or raw scalar
            if arr.shape != tshape:
                raise ValueError(f"{ref_name}: shape {arr.shape} vs {tshape} at {key}")
            out[key] = arr
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in out.items()}


def export_reference_checkpoint(prefix: str, model_or_state_dict, step: int = 0) -> None:
    """Write the port's weights as a reference-named TF checkpoint bundle.

    Produces ``<prefix>.index`` + ``<prefix>.data-00000-of-00001`` and the
    Saver's ``checkpoint`` state file beside them, as the JAX package's
    writer does, byte for byte: every trainable variable under its reference
    graph name (the per-step bias scopes included) and the global step as
    int32 ``Variable``. The ``.meta`` graph is TF-side state and is not
    produced."""
    source = _state_dict(model_or_state_dict)
    tensors = {}
    for ref_name, (kind, key, row) in reference_variable_map().items():
        arr = source[key].detach().cpu().numpy().astype(np.float32)
        if kind == "kernel":
            tensors[ref_name] = arr.T.reshape((1, 1) + arr.T.shape)
        elif kind == "bias" and row is not None:
            tensors[ref_name] = np.ascontiguousarray(arr[row])
        else:
            tensors[ref_name] = arr
    tensors["Variable"] = np.asarray(step, dtype=np.int32)
    tf_bundle.write_bundle(prefix, tensors)
    ckpt_file = os.path.join(os.path.dirname(os.path.abspath(prefix)), "checkpoint")
    base = os.path.basename(prefix)
    with open(ckpt_file, "w") as f:
        f.write(f'model_checkpoint_path: "{base}"\n')
        f.write(f'all_model_checkpoint_paths: "{base}"\n')


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="convert trained weights between the reference TF format and the port's "
        "trainer checkpoints (<workdir>/ckpt_<step>.pt)")
    ap.add_argument("--ref_prefix", required=True, help="TF checkpoint path without extension")
    ap.add_argument("--workdir", required=True,
                    help="trainer checkpoint dir (import target / export source)")
    ap.add_argument("--export", action="store_true",
                    help="export the port's weights to TF format instead")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: parse from ref_prefix on import, latest on "
                    "export)")
    args = ap.parse_args(argv)

    from rfnet_tpu_torch import checkpoints
    from rfnet_tpu_torch.train import TrainConfig, create_state

    if args.export:
        found = dict(checkpoints.list_checkpoints(args.workdir))
        step = args.step if args.step is not None else max(found, default=None)
        if step not in found:
            sys.exit(f"no checkpoint {'' if step is None else f'at step {step} '}under "
                     f"{args.workdir}")
        state_dict, _ = checkpoints.read_state_dict(found[step])
        export_reference_checkpoint(args.ref_prefix, state_dict, step=step)
        print(f"wrote {args.ref_prefix}.index / .data-00000-of-00001 (step {step})")
        return

    step = args.step
    if step is None:
        m = re.search(r"-(\d+)$", args.ref_prefix)
        step = int(m.group(1)) if m else 0
    config = TrainConfig()
    # conversion is host-side: the full-size model and a fresh Adam state
    state = create_state(config, device="cpu")
    state.model.load_state_dict(import_reference_checkpoint(args.ref_prefix, state.model),
                                strict=True)
    state.step = step
    path = checkpoints.save_checkpoint(state, args.workdir, config.max_to_keep)
    print(f"imported {args.ref_prefix} -> {path} step {step} "
          f"({sum(p.numel() for p in state.model.parameters())} params)")


if __name__ == "__main__":
    main()

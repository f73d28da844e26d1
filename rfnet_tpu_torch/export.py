"""Serving export: the completion forward as one ``torch.export`` artifact.

Port of ``rfnet_tpu/export.py``. The reference has no deployable artifact:
serving means rebuilding the TF1 graph and restoring a checkpoint into the
live session (`recon_test.py:19-39`). Here the trained forward, weights
included, is traced by ``torch.export`` into an ``ExportedProgram`` and
saved with ``torch.export.save``; :func:`load_forward` gives it back as a
callable ``partial (b, 3000, 3) -> completion (b, 16384, 3)``.

Which artifact loads without this package:
  * an artifact traced for the CPU (``--platforms cpu``) holds only ATen
    operators (the kernels' plain versions, traced as such) and loads and
    runs with ``torch`` alone;
  * an artifact traced for the card (``--platforms cuda``, the default)
    holds the hand-written kernels K1 (FPS) and K2 (the merge layer's NN
    scan) as the custom operators ``rfnet::fps`` and ``rfnet::nn_coords``.
    Loading it needs ``rfnet_tpu_torch`` importable (:func:`load_forward`
    imports it): the package defines the two operators and builds their
    kernels at first call. A process without it cannot load the artifact.
    This is the counterpart of the JAX package's TPU artifacts, whose
    Pallas kernels are ``tpu_custom_call``s that need the same release.

A ``torch.export`` program is traced for one device, so an artifact serves
one platform. The batch is static (one artifact a serving batch size) or,
with ``batch_size`` None (``--batch_size 0``), symbolic: one artifact serves
any batch size; on the card the kernels' launch plans are then chosen at run
time, inside the operators, from the batch they are given.

CLI:
    python -m rfnet_tpu_torch.export --checkpoint ./bestrecord --out rfnet.pt2 \\
        --batch_size 32 [--bf16] [--platforms cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from rfnet_tpu_torch.eval import INPUT_POINTS, count_params, load_state, resolve_device

# the batch an export with a symbolic batch is traced at: a size of 1 would
# be specialised on (torch's 0/1 rule), so the trace takes 2 and the Dim
# allows 1 and up
_TRACE_BATCH = 2


class _Forward(torch.nn.Module):
    """``partial -> out4`` of an RFNet, the function an artifact holds."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, partial: torch.Tensor) -> torch.Tensor:
        return self.model(partial).out4


def export_forward(model: torch.nn.Module, batch_size: int | None,
                   innum: int = INPUT_POINTS) -> torch.export.ExportedProgram:
    """Export ``partial (b, innum, 3) -> completion`` of ``model``, traced
    for the device its parameters lie on, with the weights in the program.
    ``batch_size`` None exports a symbolic batch of at least 1."""
    device = next(model.parameters()).device
    b = _TRACE_BATCH if batch_size is None else batch_size
    example = torch.zeros((b, innum, 3), dtype=torch.float32, device=device)
    dynamic = None
    if batch_size is None:
        dynamic = {"partial": {0: torch.export.Dim("b", min=1)}}
    with torch.no_grad():
        return torch.export.export(_Forward(model.eval()), (example,), dynamic_shapes=dynamic)


def io_shapes(exported: torch.export.ExportedProgram) -> tuple[tuple, tuple]:
    """The shapes of the program's input and output (a symbolic batch as its
    symbol)."""
    nodes = list(exported.graph.nodes)
    partial = [n for n in nodes if n.op == "placeholder"][-1]
    (out,) = nodes[-1].args[0]
    return tuple(partial.meta["val"].shape), tuple(out.meta["val"].shape)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> int:
    """Save to ``path``; returns the byte size."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_forward(path: str):
    """Load an artifact; returns a callable ``partial -> completion`` that
    runs without autograd. Defines the package's custom operators first, so
    a card artifact finds its kernels; a missing operator fails the load."""
    import rfnet_tpu_torch.ops  # noqa: F401  (defines rfnet::fps and rfnet::nn_coords)

    module = torch.export.load(path).module()

    @torch.inference_mode()
    def forward(partial: torch.Tensor) -> torch.Tensor:
        return module(partial)

    return forward


def main(argv=None):
    p = argparse.ArgumentParser(description="export the completion forward")
    p.add_argument("--checkpoint", default="./bestrecord")
    p.add_argument("--out", default="rfnet_forward.pt2")
    p.add_argument(
        "--batch_size", type=int, default=1,
        help="serving batch size; 0 = symbolic (one artifact serves any batch size)",
    )
    p.add_argument(
        "--num_gt_points", type=int, default=16384,
        help="points of a completion; must be the checkpoint's model's",
    )
    p.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 feature MLPs (parameters and coordinates stay float32)",
    )
    p.add_argument(
        "--platforms", default="cuda",
        help="the one device the program is traced for: cuda (the default; the artifact "
        "holds the kernels and needs rfnet_tpu_torch to load) or cpu (loads with torch alone)",
    )
    args = p.parse_args(argv)
    if "," in args.platforms:
        raise SystemExit(f"--platforms {args.platforms}: a torch.export program is traced for "
                         "one device; export once for each of cuda and cpu")
    device = resolve_device(args.platforms)

    model = load_state(args.checkpoint, torch.bfloat16 if args.bf16 else None).to(device)
    print("trainable parameters:", count_params(model))
    points = 2 * model.n_seed * model.decode_cell.up_ratio**2  # out4: two ×up steps
    if points != args.num_gt_points:
        raise SystemExit(f"--num_gt_points {args.num_gt_points}: the checkpoint's model "
                         f"completes {points} points")
    exported = export_forward(model, args.batch_size or None)
    shape_in, shape_out = io_shapes(exported)
    size = save_exported(exported, args.out)
    print(f"wrote {args.out}: {size / 1e6:.1f} MB, in {shape_in} -> out {shape_out}, "
          f"platform {device.type}")


if __name__ == "__main__":
    main()

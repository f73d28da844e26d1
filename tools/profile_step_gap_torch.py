"""The train step's pieces outside the model, each timed alone on one CUDA
card (the counterpart of ``tools/profile_step_gap.py``).

    python3 tools/profile_step_gap_torch.py [--iters 10]
    python3 tools/profile_step_gap_torch.py --device cpu --tiny   # plain versions

At batch 32 on fabricated outputs with the model's real shapes
(``_common_torch.fabricated_outputs``):

  losses f+b   value and gradients of ``losses.total_loss`` (step 0) in
               every model output: the whole loss stack as the step
               composes it
  zgn pair f   the two ``zero_groupnear`` hinges alone (their dense K4
               scans 16384 -> 1024 and 1024 -> 64)
  adam         ``train.apply_gradients`` on gradients of ones (3.8 M
               parameters)
  diag         the step's diagnostics block (``train._report``)

Times are ``_common_torch.timeit``'s; the last line is one JSON object.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rfnet_tpu_torch import losses, train  # noqa: E402
from tools._common_torch import TINY, device_info, emit, fabricated_outputs  # noqa: E402
from tools._common_torch import loss_grads, resolve_device, timeit  # noqa: E402

B = 32
TINY_B = 4


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a piece")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = train.TrainConfig(**TINY) if args.tiny else train.TrainConfig()
    b = TINY_B if args.tiny else B
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; batch {b}", flush=True)
    outputs, gt, gt1, gt2 = fabricated_outputs(config, b, dev)
    ms = {}

    def piece(name, fn, *fn_args):
        ms[name] = timeit(name, fn, *fn_args, iters=args.iters, device=dev, width=12)

    piece("losses f+b", loss_grads, lambda o, *a: losses.total_loss(o, *a, 0).total, outputs,
          gt, gt1, gt2)
    with torch.no_grad():
        piece("zgn pair f", lambda: losses.zero_groupnear(gt1, gt2, outputs.moves1)
              + losses.zero_groupnear(gt2, gt, outputs.moves2))
        lb = losses.total_loss(outputs, gt, gt1, gt2, 0)
    state = train.create_state(config, dev)
    for prm in state.model.parameters():
        prm.grad = torch.ones_like(prm)
    piece("adam", train.apply_gradients, state)
    piece("diag", train._report, lb, outputs, None)
    return emit({"tool": "profile_step_gap", "device": info, "batch": b, "ms": ms,
                 "params": sum(prm.numel() for prm in state.model.parameters())})


if __name__ == "__main__":
    main()

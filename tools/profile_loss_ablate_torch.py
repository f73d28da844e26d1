"""The loss stack with one term dropped at a time, value and gradients, on
one CUDA card (the counterpart of ``tools/profile_loss_ablate.py``).

    python3 tools/profile_loss_ablate_torch.py [--iters 10]
    python3 tools/profile_loss_ablate_torch.py --device cpu --tiny   # plain versions

``make_loss(drop)`` is the JAX tool's term for term: the pyramid EMDs
(0.2), cd3 and cd4 as the halves of their pairs, ``re_chamfer`` (0.2, 8
slices), the final move (0.1), the two ``zero_groupnear`` hinges (0.05
each) and the decline factors (0.01); with nothing dropped it is
``losses.total_loss`` at a step whose schedule weights are these (step 0).
Each drop of ``DROPS`` is timed as value and gradients in every model
output (``_common_torch.loss_grads``) at batch 32 on fabricated outputs with
the model's real shapes (``_common_torch.fabricated_outputs``). Times are
``_common_torch.timeit``'s; the last line is one JSON object. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rfnet_tpu_torch import losses  # noqa: E402
from rfnet_tpu_torch.ops.chamfer import chamfer_means_pair  # noqa: E402
from rfnet_tpu_torch.train import TrainConfig  # noqa: E402
from tools._common_torch import TINY, device_info, emit, fabricated_outputs  # noqa: E402
from tools._common_torch import loss_grads, resolve_device, timeit  # noqa: E402

B = 32
TINY_B = 4
# the JAX tool's drops (profile_loss_ablate.py:175)
DROPS = ((), ("zgn",), ("emd",), ("recd",), ("move", "dec"))


def make_loss(drop):
    """The total loss without the terms named in ``drop`` (emd, cd34, recd,
    move, zgn, dec), summed in the JAX tool's order."""

    def f(outputs, gt, gt1, gt2):
        total = 0.0
        if "emd" not in drop:
            total += 0.2 * (losses.earth_mover(gt1, outputs.points1_pre)
                            + losses.earth_mover(gt2, outputs.points2_pre))
        if "cd34" not in drop:
            m3a, m3b, m4a, m4b = chamfer_means_pair(gt, outputs.out3, outputs.out4)
            total += (m3a + m3b) / 2.0 + (m4a + m4b) / 2.0
        if "recd" not in drop:
            total += 0.2 * losses.re_chamfer(gt, outputs.out3, part=8)
        if "move" not in drop:
            total += 0.1 * torch.mean(torch.sum(outputs.final_move**2, dim=-1))
        if "zgn" not in drop:
            total += 0.05 * losses.zero_groupnear(gt1, gt2, outputs.moves1)
            total += 0.05 * losses.zero_groupnear(gt2, gt, outputs.moves2)
        if "dec" not in drop:
            total += 0.01 * torch.sum(outputs.decfactor_sq)
        return total

    return f


def drop_name(drop) -> str:
    return f"full-{'-'.join(drop) or 'none'}"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a drop")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = TrainConfig(**TINY) if args.tiny else TrainConfig()
    b = TINY_B if args.tiny else B
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; batch {b}", flush=True)
    inputs = fabricated_outputs(config, b, dev)
    ms, value = {}, {}
    for drop in DROPS:
        loss = make_loss(set(drop))
        ms[drop_name(drop)] = timeit(drop_name(drop), loss_grads, loss, *inputs,
                                     iters=args.iters, device=dev, width=16)
        value[drop_name(drop)] = float(loss(*inputs))
    full = ms[drop_name(())]
    print("saved by each drop: " + ", ".join(f"{k} {full - v:.3f} ms" for k, v in ms.items()
                                             if k != drop_name(())), flush=True)
    return emit({"tool": "profile_loss_ablate", "device": info, "batch": b, "ms": ms,
                 "value": value})


if __name__ == "__main__":
    main()

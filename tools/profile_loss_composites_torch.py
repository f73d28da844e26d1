"""Composites of the loss stack's terms, value and gradients, on one CUDA
card (the counterpart of ``tools/profile_loss_composites.py``).

    python3 tools/profile_loss_composites_torch.py [--iters 10]
    python3 tools/profile_loss_composites_torch.py --device cpu --tiny   # plain versions

At batch 32 on ``RandomState(0)`` clouds drawn in the JAX tool's order (gt,
gt1, gt2, out3, out4, p1, p2): the JAX tool's four composites, cd34 (cd3 +
cd4 as halves of their pairs), cd34 + ``re_chamfer`` (0.2), cd34 + the two
pyramid EMDs (0.2 each), ``re_chamfer`` + the EMDs, each as value and
gradients in its clouds; beside them the parts alone (``re_chamfer``, the
EMDs), and each composite's time less its parts' sum: what composing costs.
Times are ``_common_torch.timeit``'s; the last line is one JSON object.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rfnet_tpu_torch import losses  # noqa: E402
from rfnet_tpu_torch.ops.chamfer import chamfer_means_pair  # noqa: E402
from rfnet_tpu_torch.train import TrainConfig  # noqa: E402
from bench_torch import pyramid_sizes  # noqa: E402
from tools._common_torch import TINY, device_info, emit, grads  # noqa: E402
from tools._common_torch import rand_clouds, resolve_device, timeit  # noqa: E402

B = 32
TINY_B = 4
# the composites and their parts
COMPOSITES = {"cd34+recd": ("cd34", "recd"), "cd34+emd": ("cd34", "emd"),
              "recd+emd": ("recd", "emd")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a composite")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = TrainConfig(**TINY) if args.tiny else TrainConfig()
    b = TINY_B if args.tiny else B
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; batch {b}", flush=True)
    n, (n1, n2) = config.ptnum, pyramid_sizes(config)
    gt, gt1, gt2, out3, out4, p1, p2 = rand_clouds(np.random.RandomState(0), b,
                                                   (n, n1, n2, n, n, n1, n2), dev)

    def cd34(o3, o4):
        a, b_, c, d = chamfer_means_pair(gt, o3, o4)
        return (a + b_) / 2.0 + (c + d) / 2.0

    def recd(o3):
        return 0.2 * losses.re_chamfer(gt, o3, part=8)

    def emd(q1, q2):
        return 0.2 * losses.earth_mover(gt1, q1) + 0.2 * losses.earth_mover(gt2, q2)

    cases = {  # name: (loss of its clouds, the clouds)
        "cd34": (cd34, (out3, out4)),
        "recd": (recd, (out3,)),
        "emd": (emd, (p1, p2)),
        "cd34+recd": (lambda o3, o4: cd34(o3, o4) + recd(o3), (out3, out4)),
        "cd34+emd": (lambda o3, o4, q1, q2: cd34(o3, o4) + emd(q1, q2), (out3, out4, p1, p2)),
        "recd+emd": (lambda o3, q1, q2: recd(o3) + emd(q1, q2), (out3, p1, p2)),
    }
    ms = {name: timeit(f"{name} f+b", lambda *xs, f=f: grads(f, *xs), *clouds,
                       iters=args.iters, device=dev, width=14)
          for name, (f, clouds) in cases.items()}
    extra = {k: ms[k] - sum(ms[p] for p in parts) for k, parts in COMPOSITES.items()}
    print("composite less its parts: " + ", ".join(f"{k} {v:+.3f} ms" for k, v in extra.items()),
          flush=True)
    return emit({"tool": "profile_loss_composites", "device": info, "batch": b, "ms": ms,
                 "composite_less_parts_ms": extra})


if __name__ == "__main__":
    main()

"""The losses' whole chamfer pair, value and gradient, under each
sorted-space backend on one CUDA card (the counterpart of
``tools/bench_chamfer_backend.py``).

    python3 tools/bench_chamfer_backend_torch.py [--checkpoint weights/rfnet_r4_105000.npz]
    python3 tools/bench_chamfer_backend_torch.py --device cpu --tiny   # plain versions

Times ``ops.chamfer.chamfer_means_pair`` (cd3 + cd4: the sorts, the scans
both ways, the backward's K5 scatters and unsorts) with
``ops.chamfer._NN_SORTED_BACKEND`` set to "dyn" (z sort + K3), then "tile"
(Morton sort + K8), then restored: its forward and its gradients in out3,
out4 (``torch.autograd.grad``) on the model's outputs for one synthetic
batch (``data.online.synthetic_batch(7, 0, ...)``), and its gradients on
``RandomState(0)`` clouds. The model is the seeded random init, or the
weights of ``--checkpoint`` (any form ``eval.load_state`` takes): the
default backend's question on the converged weights. The two backends' values
must agree to 1e-5 relative (both exact; they sum in another order). Times
are ``_common_torch.timeit``'s; the last line is one JSON object. Imports
no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch.data.online import synthetic_batch  # noqa: E402
from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from rfnet_tpu_torch.train import TrainConfig  # noqa: E402
from tools._common_torch import TINY, device_info, emit, grads, rand_clouds  # noqa: E402
from tools._common_torch import require, resolve_device, timeit, tool_model  # noqa: E402

B = 32
TINY_B = 4
BACKENDS = ("dyn", "tile")
VALUE_RTOL = 1e-5


def cd34(gt, a, c):
    """cd3 + cd4's four means, as the train step takes them."""
    return sum(chamfer.chamfer_means_pair(gt, a, c))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--checkpoint", default=None, help="weights (default: the random init)")
    p.add_argument("--iters", type=int, default=10, help="timed calls a case")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = TrainConfig(**TINY) if args.tiny else TrainConfig()
    b = TINY_B if args.tiny else B
    info = device_info(dev)
    weights = args.checkpoint or "random-init"
    print(f"device: {info['smi'] or info['name']}; batch {b}; weights {weights}", flush=True)
    model = tool_model(config, dev, args.checkpoint)
    partial, gt = synthetic_batch(7, 0, b, config.innum, config.ptnum, dev)
    with torch.no_grad():
        out = model(partial)
    o3, o4 = out.out3, out.out4
    r3, r4 = rand_clouds(np.random.RandomState(0), b, (config.ptnum, config.ptnum), dev)

    def timed(name, fn, *fn_args):
        return timeit(name, fn, *fn_args, iters=args.iters, device=dev, width=44)

    ms, value = {}, {}
    saved = chamfer._NN_SORTED_BACKEND
    try:
        for backend in BACKENDS:
            chamfer._NN_SORTED_BACKEND = backend
            with torch.no_grad():
                fwd = timed(f"[{backend}] cd34 fwd   model out3/out4", cd34, gt, o3, o4)
                value[backend] = float(cd34(gt, o3, o4))
            fb = timed(f"[{backend}] cd34 f+b   model out3/out4",
                       lambda a, c: grads(lambda x, y: cd34(gt, x, y), a, c), o3, o4)
            rnd = timed(f"[{backend}] cd34 f+b   random clouds",
                        lambda a, c: grads(lambda x, y: cd34(gt, x, y), a, c), r3, r4)
            ms[backend] = {"fwd_model": fwd, "fb_model": fb, "fb_random": rnd}
            print(f"[{backend}] value model = {value[backend]:.6f}", flush=True)
    finally:
        chamfer._NN_SORTED_BACKEND = saved
    rel = abs(value["dyn"] - value["tile"]) / abs(value["dyn"])
    require(rel <= VALUE_RTOL, f"the backends' values differ by {rel:.3g} relative")
    return emit({"tool": "bench_chamfer_backend", "device": info, "batch": b,
                 "weights": weights, "ms": ms, "value": value, "value_rel_diff": rel})


if __name__ == "__main__":
    main()

"""The chamfer backward's building blocks, each timed alone on one CUDA
card (the counterpart of ``tools/bench_bwd_pieces.py``).

    python3 tools/bench_bwd_pieces_torch.py [--iters 10]
    python3 tools/bench_bwd_pieces_torch.py --device cpu --tiny   # plain versions

At (32, 16384) on ``RandomState(0)`` clouds, indices drawn at random and
near the diagonal (±64: what sorted-space argmins look like): the z sort
with its order; the row gather ``ops.chamfer._gather_rows``; the scatter K5
(``ops.nn_grad.nn_grad_scatter``, S_p and S_w) and the plain scatter-add
``ops.nn_grad.index_add_rows`` (``index_add_``) of the same rows; the
unsort ``ops.chamfer._unsort_rows``; ``chamfer_means`` forward and forward
with gradients. At ``re_chamfer``'s folded (256, 2048): ``nn_distance``
(K4 both ways) forward, forward with its backward (the gathers and
scatter-adds of ``_NNDistance.backward``), the scatter of that shape, and
``losses.re_chamfer`` with its gradient at (32, 16384). Times are
``_common_torch.timeit``'s; the last line is one JSON object. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch import losses  # noqa: E402
from rfnet_tpu_torch.ops import chamfer  # noqa: E402
from rfnet_tpu_torch.ops.nn_grad import index_add_rows, nn_grad_scatter  # noqa: E402
from tools._common_torch import device_info, emit, grads, resolve_device, timeit  # noqa: E402

B, N = 32, 16384
TINY_B, TINY_N = 2, 512
FOLD = 8  # re_chamfer's slices: (32, 16384) folds to (256, 2048)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=10, help="timed calls a block")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="small clouds (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    b, n = (TINY_B, TINY_N) if args.tiny else (B, N)
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; ({b},{n}), folded ({b * FOLD},{n // FOLD})",
          flush=True)
    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    x1, x2 = t(rng.rand(b, n, 3)), t(rng.rand(b, n, 3))
    idx = t(rng.randint(0, n, size=(b, n)), torch.int32)
    band = t(np.clip(np.arange(n)[None, :] + rng.randint(-64, 64, size=(b, n)), 0, n - 1),
             torch.int32)
    upd, g = t(rng.rand(b, n, 3)), t(rng.rand(b, n))
    order = torch.argsort(x1[..., 2], dim=1).to(torch.int32)
    ms = {}

    def block(name, fn, *fn_args):
        ms[name] = timeit(name, fn, *fn_args, iters=args.iters, device=dev, width=30)

    block("sort_by_z_with_order", chamfer.sort_by_z_with_order, x1)
    block("gather (b,n,3) rand", chamfer._gather_rows, x2, idx)
    block("gather (b,n,3) banded", chamfer._gather_rows, x2, band)
    block("K5 scatter rand", nn_grad_scatter, upd, g, idx, n)
    block("K5 scatter banded", nn_grad_scatter, upd, g, band, n)
    block("index_add_ rand", index_add_rows, (b, n, 3), idx, upd)
    block("index_add_ banded", index_add_rows, (b, n, 3), band, upd)
    block("unsort_rows", chamfer._unsort_rows, order, upd)
    block("chamfer_means fwd", lambda a, c: sum(chamfer.chamfer_means(a, c)), x1, x2)
    block("chamfer_means f+b",
          lambda a, c: grads(lambda u, v: sum(chamfer.chamfer_means(u, v)), a, c), x1, x2)

    bf, nf = b * FOLD, n // FOLD
    y1, y2 = x1.reshape(bf, nf, 3), x2.reshape(bf, nf, 3)
    idx_f = t(rng.randint(0, nf, size=(bf, nf)), torch.int32)
    upd_f, g_f = upd.reshape(bf, nf, 3), g.reshape(bf, nf)

    def nn_distance_sum(u, v):
        d1, _, d2, _ = chamfer.nn_distance(u, v)
        return d1.sum() + d2.sum()

    block(f"recd nn_distance fwd ({bf},{nf})", lambda u, v: chamfer.nn_distance(u, v)[0], y1, y2)
    block(f"recd nn_distance f+b ({bf},{nf})", lambda u, v: grads(nn_distance_sum, u, v), y1, y2)
    block(f"recd K5 scatter ({bf},{nf})", nn_grad_scatter, upd_f, g_f, idx_f, nf)
    block(f"recd index_add_ ({bf},{nf})", index_add_rows, (bf, nf, 3), idx_f, upd_f)
    block(f"re_chamfer f+b ({b},{n})",
          lambda a: grads(lambda u: losses.re_chamfer(x2, u, part=FOLD), a), x1)
    return emit({"tool": "bench_bwd_pieces", "device": info, "shape": [b, n], "ms": ms})


if __name__ == "__main__":
    main()

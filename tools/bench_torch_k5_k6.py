#!/usr/bin/env python3
"""K5 (chamfer-backward scatter) and K6 (approx-EMD cost) alone, on one card.

    python3 tools/bench_torch_k5_k6.py [--skip-k6]

Builds the kernels, then runs ``chip_smoke.py``'s own checks of the two
kernels (each result held to its plain version before it is timed) at the
trainer's shapes: K5 with real argmins of the pair loss and of re_chamfer on
completion-like outputs (the ground truth jittered by 0.005), with every
query on one target, with the argmins of a random-init model's outputs, and
with ragged n != m; K6 at the eval batch of 4 on completion-like and on
random-init outputs and on a ragged pair. Each K5 line also times a stable
``torch.sort`` of the indices and ``index_add_`` on the same inputs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rfnet_tpu_torch import kernels  # noqa: E402
from rfnet_tpu_torch.models import RFNet  # noqa: E402
from rfnet_tpu_torch.ops import chamfer  # noqa: E402


def scatter_inputs(q, t):
    """(sorted queries, cotangent scale g, argmins) of the chamfer mean q -> t."""
    qs, _ = chamfer.sort_by_z_with_order(q)
    ts, _ = chamfer.sort_by_z_with_order(t)
    d, i = chamfer.nn_dyn(qs, ts)
    g = 1.0 / (q.shape[0] * q.shape[1] * 2.0 * torch.clamp(torch.sqrt(d), min=1e-7))
    return qs, g, i


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-k6", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    kernels.build()
    with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip()[:160])
    partial, gt = (x.to(dev) for x in chip_smoke.train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    out_a = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    out_b = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.inference_mode():
        res = model(partial)
    rnd_a, rnd_b = res.out3.clone(), res.out4.clone()
    gt2 = torch.cat([gt, gt], 0)

    x1, g, idx = scatter_inputs(gt2, torch.cat([out_a, out_b], 0))
    chip_smoke.check_k5("pair, completion-like", x1, g, idx)
    chip_smoke.check_k5("pair all-to-one", x1, g, torch.full_like(idx, 16383))
    chip_smoke.check_k5("re_chamfer, completion-like",
                        *scatter_inputs(gt.reshape(256, 2048, 3), out_a.reshape(256, 2048, 3)))
    chip_smoke.check_k5("pair, random-init", *scatter_inputs(gt2, torch.cat([rnd_a, rnd_b], 0)))
    chip_smoke.check_k5("ragged partial->out", *scatter_inputs(partial, out_a), m=16384)
    chip_smoke.check_k5("ragged out->partial", *scatter_inputs(out_a, partial), m=3000)
    if not args.skip_k6:
        chip_smoke.check_k6("completion-like", gt[:4].contiguous(), out_a[:4].contiguous())
        chip_smoke.check_k6("random-init", gt[:4].contiguous(), rnd_b[:4].contiguous())
        chip_smoke.check_k6("ragged", partial[:4].contiguous(), out_a[:4].contiguous())
    return 0


if __name__ == "__main__":
    sys.exit(main())

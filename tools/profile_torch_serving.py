#!/usr/bin/env python3
"""Where the port's serving or training time goes on one CUDA card.

    python3 tools/profile_torch_serving.py [--batch 4] [--iters 5]
    python3 tools/profile_torch_serving.py --mode train --batch 32 [--iters 3]
    python3 tools/profile_torch_serving.py --mode train --batch 32 --backend tile

Runs one step under ``torch.profiler``: in ``serve`` mode the serving step of
``rfnet_tpu_torch.eval`` (full-width random-init RFNet forward + CD/fidelity
metrics on synthetic clouds), in ``train`` mode ``rfnet_tpu_torch.train``'s
train step (forward, ``losses.total_loss``, backward and the Adam update of
the full-width random-init RFNet on synthetic clouds). ``--backend`` sets the
losses' and metrics' sorted-space scan for the run (the module constant
``rfnet_tpu_torch.ops.chamfer._NN_SORTED_BACKEND``): ``dyn`` = z sort + K3,
the default, ``tile`` = Morton sort + K8, so the two backends' device time
can be read side by side. It prints:

* host wall time per step (to ``synchronize()``), summed device kernel time
  per step, and the device's idle share = 1 - kernel time / wall time;
* device time by kernel group (the port's kernels, matrix products, sort,
  index gathers and scatters, the optimizer, everything else) and the top
  kernels by device time.

Imports no JAX. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (
    ("K1 fps", ("fps_kernel",)),
    ("K2 nn_coords", ("nn_scan_kernel<true",)),
    ("K3 nn_dyn", ("nn_dyn_kernel",)),
    ("K4 nn_dense", ("nn_scan_kernel<false",)),
    ("K5 nn_grad", ("nn_grad_kernel",)),
    ("K6 emd_cost", ("emd_fill_kernel", "emd_row_kernel", "emd_col_kernel",
                     "emd_reduce_kernel")),
    ("K7 nn_pruned", ("nn_pruned_kernel",)),
    ("K8 nn_tile", ("nn_tile_kernel",)),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_xmma", "ampere")),
    ("sort", ("sort", "radix")),
    ("index/scatter", ("index", "scatter", "gather")),
    ("adam", ("adam", "multi_tensor")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--mode", choices=("serve", "train"), default="serve")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--backend", choices=("dyn", "tile"), default="dyn")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device available", file=sys.stderr)
        return 1
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.eval import make_complete_fn
    from rfnet_tpu_torch.models import RFNet
    from rfnet_tpu_torch.ops import chamfer

    chamfer._NN_SORTED_BACKEND = args.backend
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    pairs = list(synthetic_pairs(args.batch, seed=1234))
    partial = torch.from_numpy(np.stack([q for _, q, _ in pairs])).to(dev)
    gt = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)
    if args.mode == "train":
        from rfnet_tpu_torch import train

        config = train.TrainConfig(batch_size=args.batch)
        state = train.create_state(config, dev)
        n1 = 2 * config.n_seed

        def step():
            return train.train_step(state, partial, gt, n1=n1, n2=n1 * config.up_ratio)
    else:
        model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
        complete, metrics = make_complete_fn(model)

        def step():
            out = complete(partial)
            cd, emd = metrics(partial, out, gt)
            return cd

    for _ in range(3):
        step()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize(dev)
        wall = (time.time() - t0) / args.iters
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # device_time_total is in microseconds, summed over the profiled steps
    dev_ms = {e.key: e.device_time_total / 1e3 / args.iters for e in events}
    busy = sum(dev_ms.values())
    print(f"{args.mode} batch {args.batch}, backend {args.backend}: wall {wall * 1e3:.3f} "
          f"ms/step, device kernels {busy:.3f} ms/step, idle share "
          f"{1 - busy / (wall * 1e3):.3f}")
    if busy == 0:
        raise SystemExit("profiler recorded no device time")
    by_group: dict[str, float] = {}
    for name, ms in dev_ms.items():
        by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + ms
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:14s} {ms:9.3f} ms/step  {ms / busy:6.1%}")
    print("top kernels by device time:")
    for name, ms in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f} ms/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the port's serving or training time goes on one CUDA card.

    python3 tools/profile_torch_serving.py [--batch 4] [--iters 5]
    python3 tools/profile_torch_serving.py --mode train --batch 32 [--iters 3]
    python3 tools/profile_torch_serving.py --mode train --batch 32 --backend tile
    python3 tools/profile_torch_serving.py --checkpoint weights/rfnet_r4_105000.npz
    python3 tools/profile_torch_serving.py --pipeline [--bf16]
    python3 tools/profile_torch_serving.py --mode train --batch 32 --data preload [--bf16]
    python3 tools/profile_torch_serving.py --mode train --batch 32 --data online

Runs one step under ``torch.profiler``: in ``serve`` mode the serving step of
``rfnet_tpu_torch.eval`` (full-width RFNet forward + CD/fidelity metrics on
synthetic clouds), in ``train`` mode ``rfnet_tpu_torch.train``'s train step
(forward, ``losses.total_loss``, backward and the Adam update of the
full-width RFNet on synthetic clouds). The model is the seeded random init,
or the weights of ``--checkpoint`` (``eval.load_state``: an ``.npz`` of flax
params such as the converged ``weights/rfnet_r4_105000.npz``, or a ``.pt``
state_dict); the clouds are the first of the held-out synthetic set
``synthetic_pairs(64, seed=1234)``. ``--backend`` sets the
losses' and metrics' sorted-space scan for the run (the module constant
``rfnet_tpu_torch.ops.chamfer._NN_SORTED_BACKEND``): ``dyn`` = z sort + K3,
the default, ``tile`` = Morton sort + K8, so the two backends' device time
can be read side by side. ``--bf16`` computes the feature MLPs in bfloat16
(the eval CLI's ``--bf16``, the trainer's ``compute_dtype``). In ``serve``
mode ``--pipeline`` keeps the eval CLI's ``DEPTH`` batches in flight (its
``dispatch`` and ``collect``: host batches copied in through pinned
buffers, metrics and completion read back), so the wall is the amortized
time a batch. In ``train`` mode ``--data`` picks where the batch comes
from: ``host`` (already on the card, the pyramids made in the step),
``preload`` (the trainer's ``--preload_device``: the batch gathered on the
card from a resident set, its pyramids precomputed before the window) or
``online`` (``--synthetic_online``: generated on the card in the step).
It prints:

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
    ("K7 nn_pruned", ("nn_tiles_kernel<false",)),
    ("K8 nn_tile", ("nn_tiles_kernel<true",)),
    ("boxes K6-K8", ("run_boxes_kernel",)),
    ("matmul", ("gemm", "gemv", "cutlass", "cublas", "sm90_xmma", "ampere", "nvjet",
                "splitk")),
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
    p.add_argument("--checkpoint", default=None,
                   help="weights (.npz of flax params or .pt); default the seeded random init")
    p.add_argument("--bf16", action="store_true", help="bfloat16 feature MLPs")
    p.add_argument("--pipeline", action="store_true",
                   help="serve mode: keep the eval CLI's DEPTH batches in flight")
    p.add_argument("--data", choices=("host", "preload", "online"), default="host",
                   help="train mode: the batch's source")
    args = p.parse_args(argv)
    if args.pipeline and args.mode != "serve" or args.data != "host" and args.mode != "train":
        p.error("--pipeline is a serve option and --data a train option")

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device available", file=sys.stderr)
        return 1
    from rfnet_tpu_torch import eval as eval_mod
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.models import RFNet
    from rfnet_tpu_torch.ops import chamfer

    chamfer._NN_SORTED_BACKEND = args.backend
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    pairs = list(synthetic_pairs(args.batch, seed=1234))
    pnp = np.stack([q for _, q, _ in pairs])
    gnp = np.stack([g for _, _, g in pairs])
    partial, gt = torch.from_numpy(pnp).to(dev), torch.from_numpy(gnp).to(dev)
    dtype = torch.bfloat16 if args.bf16 else None
    loaded = eval_mod.load_state(args.checkpoint, dtype) if args.checkpoint else None
    pending: list = []
    if args.mode == "train":
        from rfnet_tpu_torch import train
        from rfnet_tpu_torch.data import online

        config = train.TrainConfig(batch_size=args.batch,
                                   compute_dtype="bfloat16" if args.bf16 else "float32")
        state = train.create_state(config, dev)
        if loaded is not None:
            state.model.load_state_dict(loaded.state_dict())
        n1 = 2 * config.n_seed
        n2 = n1 * config.up_ratio
        if args.data == "preload":
            gt1s, gt2s = train._precompute_pyramids(gt, n1, n2)
            rows = torch.arange(args.batch, device=dev)

            def step():
                take = (x.index_select(0, rows) for x in (partial, gt, gt1s, gt2s))
                return train.train_step_pyr(state, *take)
        elif args.data == "online":
            def step():
                p_, g_ = online.synthetic_batch(config.seed, state.step, args.batch,
                                                config.innum, config.ptnum, dev)
                return train.train_step(state, p_, g_, n1=n1, n2=n2)
        else:
            def step():
                return train.train_step(state, partial, gt, n1=n1, n2=n2)
    else:
        model = loaded or RFNet(generator=torch.Generator().manual_seed(0), dtype=dtype)
        model = model.to(dev).eval()
        complete, metrics = eval_mod.make_complete_fn(model)
        if args.pipeline:
            def step():
                pending.append(eval_mod.dispatch(complete, metrics, pnp, gnp, dev))
                if len(pending) == eval_mod.DEPTH:
                    eval_mod.collect(pending.pop(0))
        else:
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
        while pending:
            eval_mod.collect(pending.pop(0))
        torch.cuda.synchronize(dev)
        wall = (time.time() - t0) / args.iters
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # device_time_total is in microseconds, summed over the profiled steps
    dev_ms = {e.key: e.device_time_total / 1e3 / args.iters for e in events}
    busy = sum(dev_ms.values())
    mode = (f"{args.mode}{' pipelined' if args.pipeline else ''} batch {args.batch}"
            f"{', data ' + args.data if args.mode == 'train' else ''}"
            f"{', bf16' if args.bf16 else ''}")
    print(f"{mode}, backend {args.backend}: wall {wall * 1e3:.3f} "
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

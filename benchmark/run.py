#!/usr/bin/env python3
"""The benchmark of ``rfnet_tpu_torch``: one run of one cell on the card.

    python3 benchmark/run.py --workload serve_b32 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout. Each run is a new process: it sets up the
cell (the program's kernels, the weights, the traffic's pool from
``--seed``, the cell's own shapes warmed), measures ``--seconds`` of its
traffic, checks what the window produced against the plain reference in
``benchmark/reference/``, and prints one JSON line last on standard output
(``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer
metrics of a profiled slice of the window, the device's busy share and a
breakdown). The numbers the check compared, each with its limit, are the
last lines of standard error and the line's last key.

It needs a CUDA card (as many as the cell asks for) and fails without one;
it never runs on the CPU. Caches (CUDA, Triton, extensions) live in
``benchmark/runs/cache/`` of the checkout; the program builds its kernels
into ``rfnet_tpu_torch/_build/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rfnet_tpu")


def _environment() -> None:
    cache = os.path.join(HERE, "runs", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    limit = harness.power_limit()
    if limit:
        result["device"]["power"] = limit
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K9's design choices (``csrc/nn_variant.cu``) timed against their
alternatives, on one card.

    python3 tools/bench_torch_k9_designs.py [--iters 20] [--rounds 2]

Each design is the kernel's committed source with one substitution
(``DESIGNS``): the re-find behind a warp vote instead of a plain branch,
chunks of 8 or of 12 targets for every variant at 8 queries a thread, v1
capped at two CTAs an SM. Every design is built with the package's nvcc
flags into a library of its own under ``rfnet_tpu_torch/_build/designs/``,
all builds started together; then each is timed in a process of its own
that loads no other build, the designs in turns, forward then backward,
``--rounds`` times. A substitution whose text the source no longer holds
stops the tool (:func:`design_source`). A process runs v1, v2 and v3 at
(32,16384,3)² on ``RandomState(0)`` clouds under K9's plan and under the
plan of 4 queries a thread, holds each output to its plain version bit for
bit first, and times ``--iters`` launches between two CUDA events after 3
warm-ups. The last line is one JSON object: {design: {variant and plan: ms
of each round}}, with the card's name and power limit. Needs the card and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rfnet_tpu_torch import kernels  # noqa: E402
from tools import bench_chamfer_variants_torch as variants  # noqa: E402
from tools._common_torch import device_info, emit, require  # noqa: E402

SOURCE = os.path.join(kernels.CSRC_DIR, "nn_variant.cu")
OUT_DIR = os.path.join(kernels.BUILD_DIR, "designs")
# design -> (text in the source, its replacement); "shipped" is the source
DESIGNS = {
    "shipped": None,
    "vote": ("if (least < best[r]) {",
             "if (__any_sync(0xffffffffu, least < best[r])) if (least < best[r]) {"),
    "chunk 8": ("return R == 8 && !kFma ? 12 : 64 / R;", "return 64 / R;"),
    "chunk 12": ("return R == 8 && !kFma ? 12 : 64 / R;", "return R == 8 ? 12 : 64 / R;"),
    "v1 two CTAs": ("return eq ? 2 : 3;", "return 2;"),
}
SHAPE = (32, 16384, 16384)


def design_source(name: str, source: str) -> str:
    """The kernel's source for design ``name``; the substitution's text must
    occur exactly once."""
    if DESIGNS[name] is None:
        return source
    old, new = DESIGNS[name]
    if source.count(old) != 1:
        raise ValueError(f"design {name!r}: {old!r} occurs {source.count(old)} times")
    return source.replace(old, new)


def build(names) -> dict:
    """Builds each design into ``OUT_DIR``, all nvcc processes at once;
    returns {design: library path}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    source = open(SOURCE).read()
    procs, libs = {}, {}
    for name in names:
        stem = os.path.join(OUT_DIR, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(design_source(name, source))
        libs[name] = stem + ".so"
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-shared",
             stem + ".cu", "-o", libs[name]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, p in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        require(p.returncode == 0, f"design {name!r} did not build:\n{log}")
    return libs


def worker(lib_path: str, iters: int) -> dict:
    """One design's times: {"<variant> <plan>": ms}, each output held to its
    plain version first."""
    lib = ctypes.CDLL(lib_path)
    lib.rfnet_nn_variant.argtypes = list(kernels._SIGNATURES["nn_variant"])
    lib.rfnet_nn_variant.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    b, n, m = SHAPE
    gt, out3 = (torch.from_numpy(rng.rand(b, k, 3).astype(np.float32)).to(dev) for k in (n, m))
    plains = {f: variants.nn_variant_plain(gt, out3, fma=f) for f in (False, True)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dist = torch.empty(b, n, device=dev)
    idx = torch.empty(b, n, dtype=torch.int32, device=dev)
    out = {}
    for name, fma, eq in variants.VARIANTS[1:]:
        for r in (8, 4):
            plan = variants.variant_plan(b, n, m, sms, r)

            def launch():
                err = lib.rfnet_nn_variant(gt.data_ptr(), out3.data_ptr(), b, n, m, *plan,
                                           int(fma), int(eq), dist.data_ptr(), idx.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
                require(err == 0, f"{name} {plan}: error {err}")

            launch()
            torch.cuda.synchronize()
            pd, pi = plains[fma]
            require(torch.equal(dist, pd) and torch.equal(idx, pi),
                    f"{name} {plan} differs from its plain version")
            for _ in range(3):
                launch()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                launch()
            end.record()
            torch.cuda.synchronize()
            out[f"{name} {plan}"] = start.elapsed_time(end) / iters
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--iters", type=int, default=20, help="timed launches a case")
    p.add_argument("--rounds", type=int, default=2, help="passes over the designs, forward "
                   "then backward")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.iters)), flush=True)
        return {}
    require(torch.cuda.is_available(), "needs a CUDA device")
    info = device_info("cuda")
    print(f"device: {info['smi']}", flush=True)
    libs = build(DESIGNS)
    result = {name: {} for name in DESIGNS}
    order = list(DESIGNS)
    for k in range(args.rounds):
        for name in order if k % 2 == 0 else order[::-1]:
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  libs[name], "--iters", str(args.iters)],
                                 capture_output=True, text=True)
            require(run.returncode == 0, f"design {name!r}: {run.stderr[-2000:]}")
            for case, ms in json.loads(run.stdout.strip().splitlines()[-1]).items():
                result[name].setdefault(case, []).append(ms)
            print(f"{name:12s} " + "; ".join(f"{c} {v[-1]:.4f}" for c, v in result[name].items()),
                  flush=True)
    return emit({"tool": "bench_torch_k9_designs", "device": info, "shape": list(SHAPE),
                 "ms": result})


if __name__ == "__main__":
    main()

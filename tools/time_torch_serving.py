#!/usr/bin/env python3
"""Serving latency of the port's eval CLI on one CUDA card: "Average time"
of the synchronous path against ``--pipeline``, in float32 and ``--bf16``.

    python3 tools/time_torch_serving.py [--num 64] [--batch 4] [--rounds 2]

Writes the first ``--num`` clouds of the held-out synthetic set in the PCN
layout (``tools/make_synthetic_evalset_torch.py``), then serves them with
the converged weights ``weights/rfnet_r4_105000.npz`` through
``rfnet_tpu_torch.eval.main`` on the card, each round in turns (sync,
pipeline, pipeline, sync), for float32 and for ``--bf16``, and prints
every run's "Average time" (models 0-9 excluded as warm-up; sync: the
forward to ``synchronize()`` per cloud; pipeline: the amortized wall time
per cloud between read-backs) and the wall time of the whole run, with the
card's name and power limit. Every run must write the same CSV as the
first run of its dtype. Imports no JAX.
Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_torch_serving: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from rfnet_tpu_torch import eval as eval_mod
    from tools.make_synthetic_evalset_torch import write_evalset

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    tmp = tempfile.mkdtemp()
    try:
        write_evalset(tmp, args.num, pcn_layout=True)
        common = ["--list_path", os.path.join(tmp, "test.list"), "--data_dir",
                  os.path.join(tmp, "data"), "--checkpoint", chip_smoke.WEIGHTS,
                  "--plot_freq", "1000000", "--batch_size", str(args.batch), "--device", "cuda"]
        first: dict = {}
        for dtype in ([], ["--bf16"]):
            for r in range(args.rounds):
                for mode in ("sync", "pipeline", "pipeline", "sync"):
                    out = os.path.join(tmp, "results")
                    argv_ = [*common, "--results_dir", out, *dtype,
                             *(["--pipeline"] if mode == "pipeline" else [])]
                    buf = io.StringIO()
                    t0 = time.time()
                    with contextlib.redirect_stdout(buf):
                        eval_mod.main(argv_)
                    wall = time.time() - t0
                    avg = float(re.search(r"Average time: ([0-9.eE+-]+)", buf.getvalue())[1])
                    with open(os.path.join(out, "results.csv")) as f:
                        rows = f.read()
                    tag = "bf16" if dtype else "float32"
                    if first.setdefault(tag, rows) != rows:
                        raise SystemExit(f"{tag} {mode}: the CSV differs from the first run's")
                    print(f"{tag} {mode} round {r}: Average time {avg:.6f} s/cloud, run "
                          f"{wall:.3f} s for {args.num} clouds at batch {args.batch}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

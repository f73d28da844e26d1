#!/usr/bin/env python3
"""Readings of a cell's checked numbers over many seeds, in one process.

    python3 benchmark/readings.py --workload serve_b32 --seeds 1,2,3 \
        [--program port|control|<fault>] [--seconds 3] [--out FILE]

Runs the cell as ``benchmark/run.py`` does (set-up, a window of
``--seconds``, the check) once a seed, with the program under test, the
control (the reference one precision below, ``controls.CONTROLS``) or a
planted fault (``controls.FAULTS``) in its place, and prints one JSON line
a seed: the checked numbers (their limits are the cell's, for reference)
and whether the run came out correct. The limits in ``workloads/<cell>.json``
are set from these readings. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import controls, harness  # noqa: E402
from benchmark.run import _environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", default="port")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    _environment()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device is available", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    kind = cell["spec"]["driver"]
    program = {"port": None, "control": controls.CONTROLS[kind], **controls.FAULTS[kind]}[
        args.program]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t0,
                               program)
        line = json.dumps({"workload": args.workload, "program": args.program, "seed": seed,
                           "correct": res["correct"], "checks": res["checks"],
                           "details": res["details"], "metrics": res["metrics"],
                           "run_s": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Programs that must come out not correct in ``serve_snow_b32``, and the
readings of its checked numbers over many seeds.

    python3 benchmark/controls_snowflake.py --seeds 1,2,3 \
        [--program port|control|answer_altered|half_batch] [--seconds 3] [--out FILE]

Each program is a ``program`` for ``drivers/serve_snowflake.Driver``: a
class built from ``(cell, device)`` with the interface of the driver's
``Port``.

* The control (:class:`Control`): the plain reference in the program's
  place, one precision below the configuration's float32: both operands of
  every convolution rounded to TF32 and the serving metrics' scans in
  bfloat16.
* The faults: one cloud's completion moved by 0.01 in x where it is
  produced (:class:`AnswerAltered`); only the first half of each batch
  completed, its answers copied over the second half's
  (:class:`HalfBatchServed`).

Run as a script it does what ``benchmark/readings.py`` does for the other
cells: the cell once a seed, as ``benchmark/run.py`` runs it (set-up, a
window of ``--seconds``, the check), with the program under test or one of
these in its place, one JSON line a seed. The cell's limits are set from
these readings. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.drivers import serve_snowflake as snow  # noqa: E402
from benchmark.reference import rfnet as ref_rfnet  # noqa: E402

CELL = "serve_snow_b32"


class Control:
    def __init__(self, cell: dict, device: torch.device, precision: str = "tf32"):
        net = snow.reference(cell["config"], device, precision)

        @torch.no_grad()
        def stages(partial):
            with ref_rfnet.full_fp32():
                return net(partial)

        @torch.no_grad()
        def metrics(partial, output, gt):
            # the scans' float32 arithmetic one step down: bfloat16
            p, o, g = (x.bfloat16() for x in (partial, output, gt))
            cd = (ref_rfnet.mean_nearest(o, g) + ref_rfnet.mean_nearest(g, o)) / 2
            return cd.float(), ref_rfnet.mean_nearest(p, o).float()

        self.stages, self.metrics = stages, metrics
        self.complete = lambda partial: stages(partial)["p3"]


class AnswerAltered(snow.Port):
    """Cloud 0's completion moved by 0.01 in x where it is produced."""

    def __init__(self, cell, device):
        super().__init__(cell, device)
        complete = self.complete

        def altered(partial):
            out = complete(partial).clone()
            out[0, :, 0] += 0.01
            return out

        self.complete = altered


class HalfBatchServed(snow.Port):
    """Only the first half of each batch completed; its answers stand in
    for the second half's."""

    def __init__(self, cell, device):
        super().__init__(cell, device)
        complete = self.complete

        def half(partial):
            h = partial.shape[0] // 2
            out = complete(partial[:h])
            return torch.cat([out, out[: partial.shape[0] - h]])

        self.complete = half


PROGRAMS = {"port": None, "control": Control, "answer_altered": AnswerAltered,
            "half_batch": HalfBatchServed}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", default="port", choices=sorted(PROGRAMS))
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    from benchmark import harness
    from benchmark.run import _environment

    _environment()
    if not torch.cuda.is_available():
        print("controls_snowflake: no CUDA device is available", file=sys.stderr)
        return 2
    cell = harness.load_cell(CELL)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t0,
                               PROGRAMS[args.program])
        line = json.dumps({"workload": CELL, "program": args.program, "seed": seed,
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

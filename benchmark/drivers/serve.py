"""Serving driver: closed-loop batches through the eval CLI's entry.

Each step hands one batch of the pool (host arrays) to
``rfnet_tpu_torch.eval.dispatch`` with the ``complete`` and ``metrics`` of
``eval.make_complete_fn``, each wrapped in a span of its own
(``bench.complete``, ``bench.metrics``; the call in ``bench.dispatch``),
and waits for ``eval.collect``: the copy in, the forward, ``cd`` and
fidelity, the read-back. One batch is in flight, as the eval CLI serves.

The check: a sample of the window's batches, drawn from the seed, and its
last batch. For each, the completion against the reference's forward of
the same partials (``out4_gap``: per cloud, the mean distance of a point
to the nearest of the other completion, both ways: a completion is a set,
and a merge's near-tie that picks another input point moves one point, not
the set), and the program's ``cd`` and fidelity against what the
reference's scans read on the program's own completion (``cd_gap``,
``fid_gap``: relative), each worst over the clouds. Beside them, in
``details``: the mean coordinate gap, and the answers against the
reference's answers on its own completion, which the merges' near-ties move
as much as one precision down does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import flops
from benchmark.harness import ROOT
from benchmark.reference import rfnet as ref
from benchmark.traffic import synthetic


def worst(a: float, b: float) -> float:
    """The larger of two gaps; NaN, once read, stays."""
    return a if (a != a or b <= a) else b


def spanned(name: str, fn):
    def call(*args):
        with record_function(name):
            return fn(*args)
    return call


class Port:
    """The program under test: the eval CLI's model and functions."""

    def __init__(self, cell: dict, device: torch.device):
        from rfnet_tpu_torch import eval as ev

        cfg = cell["config"]
        dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else None
        self.model = ev.load_state(os.path.join(ROOT, cfg["weights"]), dtype).to(device).eval()
        self.complete, self.metrics = ev.make_complete_fn(self.model)


class Driver:
    def __init__(self, cell: dict, seed: int, device: torch.device, program=None):
        from rfnet_tpu_torch import eval as ev

        self.ev, self.cell, self.device = ev, cell, device
        self.spec = cell["spec"]
        self.batch = cell["traffic"]["batch"]
        self.partials, self.gts = synthetic.pool(cell["traffic"], seed)
        self.prog = (program or Port)(cell, device)
        self.complete = spanned("bench.complete", self.prog.complete)
        self.metrics = spanned("bench.metrics", self.prog.metrics)
        chk = self.spec["check"]
        rng = np.random.default_rng(synthetic.seed32(seed) + 1)
        self.sample = set(rng.choice(chk["sample_from"], chk["sample_batches"],
                                     replace=False).tolist())
        self.kept: dict[int, tuple] = {}
        self.last = None
        self.times: list[float] = []
        self.host_s: list[float] = []
        self.scores: list[np.ndarray] = []

    def _serve(self, slot: int):
        t = time.perf_counter()
        with record_function("bench.dispatch"):
            pending = self.ev.dispatch(self.complete, self.metrics, self.partials[slot],
                                       self.gts[slot], self.device)
        self.host_s.append(time.perf_counter() - t)
        return self.ev.collect(pending)

    def warm(self) -> None:
        for i in range(self.spec["warm_batches"]):
            self._serve(i % len(self.partials))
        self.host_s = []
        if self.device.type == "cuda":
            # the host buffers the kept batches hold, cached before the window
            shapes = [(self.batch,), (self.batch,), (self.batch, self.cell["traffic"]["ptnum"], 3)]
            held = [torch.empty(s, pin_memory=True) for _ in range(len(self.sample) + 2)
                    for s in shapes]
            del held

    def step(self, i: int) -> None:
        slot = i % len(self.partials)
        t = time.perf_counter()
        cds, emds, completion = self._serve(slot)
        self.times.append(time.perf_counter() - t)
        self.scores.append(np.stack([cds, emds]))
        if i in self.sample:
            self.kept[i] = (slot, cds, emds, completion)
        self.last = (i, (slot, cds, emds, completion))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_to_end(self, window_s: float) -> dict:
        return {"serve_clouds_per_s": self.batch * len(self.times) / window_s,
                "serve_p95_ms": float(np.percentile(self.times, 95)) * 1e3}

    def tally(self) -> tuple[int, int]:
        scores = np.stack(self.scores)
        return self.batch * len(self.times), int((~np.isfinite(scores)).any(axis=1).sum())

    def work(self):
        cfg = self.cell["config"]
        return (flops.forward_matmuls(cfg, self.batch), flops.serve_scan_flops(cfg) * self.batch)

    def release(self) -> None:
        del self.prog, self.complete, self.metrics

    def check(self) -> list[tuple[str, float, float]]:
        kept = dict(self.kept)
        kept[self.last[0]] = self.last[1]
        dev = self.device
        params, _ = ref.load_npz(os.path.join(ROOT, self.cell["config"]["weights"]), dev)
        net = ref.Net(params, "fp32")
        gaps = dict.fromkeys(("out4_gap", "cd_gap", "fid_gap", "out4_point_gap",
                              "cd_answer_gap", "fid_answer_gap"), 0.0)

        def scores(part, out, gt):
            cd = (ref.mean_nearest(out, gt) + ref.mean_nearest(gt, out)) / 2
            return cd.cpu().numpy(), ref.mean_nearest(part, out).cpu().numpy()

        def rel(a, b):
            return float(np.max(np.abs(a - b) / b))

        with ref.full_fp32(), torch.no_grad():
            want = {}
            for s in sorted({k[0] for k in kept.values()}):
                part = torch.from_numpy(self.partials[s]).to(dev)
                out = net(part)["out4"]
                want[s] = (out, *scores(part, out, torch.from_numpy(self.gts[s]).to(dev)))
            for slot, cds, emds, completion in kept.values():
                out = torch.from_numpy(np.ascontiguousarray(completion)).to(dev).float()
                part = torch.from_numpy(self.partials[slot]).to(dev)
                gt = torch.from_numpy(self.gts[slot]).to(dev)
                ref_out, ref_cd, ref_fid = want[slot]
                judged_cd, judged_fid = scores(part, out, gt)
                apart = (ref.mean_nearest(out, ref_out) + ref.mean_nearest(ref_out, out)) / 2
                for k, v in (("out4_gap", apart.max().item()),
                             ("cd_gap", rel(cds, judged_cd)), ("fid_gap", rel(emds, judged_fid)),
                             ("out4_point_gap", (out - ref_out).abs().mean(dim=(1, 2)).max().item()),
                             ("cd_answer_gap", rel(cds, ref_cd)),
                             ("fid_answer_gap", rel(emds, ref_fid))):
                    gaps[k] = worst(gaps[k], v)
        self.details = gaps
        limits = self.spec["check"]["limits"]
        return [(k, gaps[k], limits[k]) for k in ("out4_gap", "cd_gap", "fid_gap")]

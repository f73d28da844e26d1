"""Serving driver for SnowflakeNet: closed-loop batches through the eval
CLI's entry, as ``serve`` drives RFNet.

Each step hands one batch of the pool (host arrays) to
``rfnet_tpu_torch.eval.dispatch`` with the ``complete`` and ``metrics`` of
``eval.make_complete_fn`` on the configuration's SnowflakeNet, and waits
for ``eval.collect``: the copy in, the forward, ``cd`` and fidelity at
16 384 points, the read-back. The weights are the benchmark's own: drawn
from the configuration's ``weights_seed`` in the published shapes
(``reference/snowflakenet.draw_weights``, BatchNorm's statistics far from
its init), saved to a file and loaded by ``eval.load_state``, as a trained
checkpoint would be; the reference takes the same state dict.

The check: a sample of the window's batches, drawn from the seed, and its
last batch, against the plain reference (``reference/snowflakenet.py``)
run on the same partials in blocks of ``check.block`` clouds. For each
batch, per cloud and worst over the clouds: ``out_gap``, the completion as
a set against the reference's (the mean distance of a point to the nearest
of the other completion, both ways: an FPS or k-NN near-tie that picks
another point moves single points, not the set); ``cd_gap`` and
``fid_gap``, the program's ``cd`` and fidelity against what the
reference's scans read on the program's own completion (relative). Beside
them, in ``details``: the same set gap at the seeds and at P0-P2 (the
program's forward replayed on the batch), the mean coordinate gap of the
completion, and the answers against the reference's answers on its own
completion.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

# on a tree without SnowflakeNet the cell stops here, before anything is built
from rfnet_tpu_torch.models.snowflakenet import SnowflakeNet  # noqa: F401

from benchmark import flops_snowflake
from benchmark.drivers import serve
from benchmark.reference import rfnet as ref_rfnet
from benchmark.reference import snowflakenet as ref

STAGES = ("seeds", "p0", "p1", "p2", "p3")


def weights(cfg: dict) -> dict:
    """The configuration's weights: a state dict in the published shapes,
    drawn from its ``weights_seed``."""
    shapes = ref.published_shapes(cfg["dim_feat"], cfg["num_pc"], cfg["up_factors"],
                                  cfg["attn_dim"], cfg["pos_hidden_dim"],
                                  cfg["attn_hidden_multiplier"])
    return ref.draw_weights(shapes, cfg["weights_seed"])


def reference(cfg: dict, device: torch.device, precision: str = "fp32") -> ref.Net:
    params = {k: v.to(device) for k, v in weights(cfg).items()}
    return ref.Net(params, precision, num_p0=cfg["num_p0"], sa_points=tuple(cfg["sa_points"]),
                   k=cfg["k"], radius=cfg["radius"])


class Port:
    """The program under test: the eval CLI's model, loaded by
    ``eval.load_state`` from a file of the configuration's weights, and its
    functions; ``stages`` replays its forward for the check's details."""

    def __init__(self, cell: dict, device: torch.device):
        from rfnet_tpu_torch import eval as ev

        cfg = cell["config"]
        sizes = dict(num_p0=cfg["num_p0"], radius=cfg["radius"],
                     sa_points=tuple(cfg["sa_points"]), input_points=cfg["innum"])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "snowflakenet.pt")
            torch.save(weights(cfg), path)
            model = ev.load_state(path, model="snowflakenet", sizes=sizes)
        self.model = model.to(device).eval()
        self.complete, self.metrics = ev.make_complete_fn(self.model)

    @torch.inference_mode()
    def stages(self, partial: torch.Tensor) -> dict:
        out = self.model(partial)
        return dict(zip(STAGES, (out.seeds, out.p0, *out.stages)))


class Driver(serve.Driver):
    def __init__(self, cell: dict, seed: int, device: torch.device, program=None):
        super().__init__(cell, seed, device, program or Port)
        self.stages = self.prog.stages  # kept past release() for the check's details

    def work(self):
        cfg = self.cell["config"]
        return (flops_snowflake.forward_matmuls(cfg, self.batch),
                flops_snowflake.scan_flops(cfg) * self.batch)

    def check(self) -> list[tuple[str, float, float]]:
        kept = dict(self.kept)
        kept[self.last[0]] = self.last[1]
        dev, cfg, spec = self.device, self.cell["config"], self.spec["check"]
        net = reference(cfg, dev)
        names = ("out_gap", "cd_gap", "fid_gap", "out_point_gap", "cd_answer_gap",
                 "fid_answer_gap") + tuple(s + "_gap" for s in STAGES[:-1])
        gaps = dict.fromkeys(names, 0.0)

        def apart(a, b):  # per cloud: the two clouds as sets
            return (ref_rfnet.mean_nearest(a, b) + ref_rfnet.mean_nearest(b, a)) / 2

        def scores(part, out, gt):
            cd = (ref_rfnet.mean_nearest(out, gt) + ref_rfnet.mean_nearest(gt, out)) / 2
            return cd.cpu().numpy(), ref_rfnet.mean_nearest(part, out).cpu().numpy()

        def rel(a, b):
            return float(np.max(np.abs(a - b) / b))

        with ref.full_fp32(), torch.no_grad():
            want = {}
            for s in sorted({k[0] for k in kept.values()}):
                part = torch.from_numpy(self.partials[s]).to(dev)
                blocks = [net(part[i:i + spec["block"]]) for i in range(0, len(part), spec["block"])]
                stages = {k: torch.cat([blk[k] for blk in blocks]) for k in STAGES}
                mine = self.stages(part)
                for k in STAGES[:-1]:
                    gaps[k + "_gap"] = serve.worst(gaps[k + "_gap"],
                                                   apart(mine[k].float(), stages[k]).max().item())
                gt = torch.from_numpy(self.gts[s]).to(dev)
                want[s] = (stages["p3"], *scores(part, stages["p3"], gt))
            for slot, cds, emds, completion in kept.values():
                out = torch.from_numpy(np.ascontiguousarray(completion)).to(dev).float()
                part = torch.from_numpy(self.partials[slot]).to(dev)
                gt = torch.from_numpy(self.gts[slot]).to(dev)
                ref_out, ref_cd, ref_fid = want[slot]
                judged_cd, judged_fid = scores(part, out, gt)
                for k, v in (("out_gap", apart(out, ref_out).max().item()),
                             ("cd_gap", rel(cds, judged_cd)), ("fid_gap", rel(emds, judged_fid)),
                             ("out_point_gap", (out - ref_out).abs().mean(dim=(1, 2)).max().item()),
                             ("cd_answer_gap", rel(cds, ref_cd)),
                             ("fid_answer_gap", rel(emds, ref_fid))):
                    gaps[k] = serve.worst(gaps[k], v)
        self.details = gaps
        limits = spec["limits"]
        return [(k, gaps[k], limits[k]) for k in ("out_gap", "cd_gap", "fid_gap")]

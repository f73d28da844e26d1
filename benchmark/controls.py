"""Programs that must come out not correct: the control and planted faults.

Each is a ``program`` for a driver (``Driver(cell, seed, device,
program)``): a class built from ``(cell, device)`` with the interface of
the driver's ``Port``.

* The control (:class:`ServeControl`, :class:`TrainControl`): the plain
  reference put in the program's place, computed one precision below the
  configuration's float32: every matrix product's operands rounded to TF32,
  and the serving metrics' scans, float32 arithmetic outside any product,
  in bfloat16.
* The faults: an answer altered where it is produced (one cloud's
  completion moved, one cloud's ``cd`` scaled); half of the batch left out
  (the other half's answers copied over it, or a train step's loss taken
  over the first half alone); a train step that leaves its state
  unchanged.

``benchmark/readings.py`` reads them on the card; ``benchmark/tests`` sees
each come out not correct on the CPU.
"""

from __future__ import annotations

import os

import torch

from benchmark.drivers import serve, train
from benchmark.harness import ROOT
from benchmark.reference import losses as ref_losses
from benchmark.reference import rfnet as ref


class ServeControl:
    def __init__(self, cell: dict, device: torch.device, precision: str = "tf32"):
        params, _ = ref.load_npz(os.path.join(ROOT, cell["config"]["weights"]), device)
        net = ref.Net(params, precision)

        @torch.no_grad()
        def complete(partial):
            with ref.full_fp32():
                return net(partial)["out4"]

        @torch.no_grad()
        def metrics(partial, output, gt):
            # the scans' float32 arithmetic one step down: bfloat16
            p, o, g = (x.bfloat16() for x in (partial, output, gt))
            cd = (ref.mean_nearest(o, g) + ref.mean_nearest(g, o)) / 2
            return cd.float(), ref.mean_nearest(p, o).float()

        self.complete, self.metrics = complete, metrics


class TrainControl:
    def __init__(self, cell: dict, device: torch.device, precision: str = "tf32"):
        params, step = ref.load_npz(os.path.join(ROOT, cell["config"]["weights"]), device)
        self.trainer = ref_losses.Trainer(params, step, precision)
        self.device = device

    def place(self, batch):
        return torch.from_numpy(batch).to(self.device)

    def step(self, partial, gt):
        with ref.full_fp32():
            return self.trainer.step(partial, gt)

    def params(self):
        return self.trainer.params

    def first_moments(self):
        opt = self.trainer.opt
        names = {id(p): k for k, p in self.trainer.params.items()}
        return ({names[id(p)]: s["exp_avg"] for p, s in opt.state.items() if "exp_avg" in s},
                opt.param_groups[0]["betas"][0])


class AnswerAltered(serve.Port):
    """Cloud 0's completion moved by 0.01 in x where it is produced."""

    def __init__(self, cell, device):
        super().__init__(cell, device)
        complete = self.complete

        def altered(partial):
            out = complete(partial).clone()
            out[0, :, 0] += 0.01
            return out

        self.complete = altered


class ScoreAltered(serve.Port):
    """Cloud 0's ``cd`` scaled by 1.01 where it is produced."""

    def __init__(self, cell, device):
        super().__init__(cell, device)
        metrics = self.metrics

        def altered(partial, output, gt):
            cd, fid = metrics(partial, output, gt)
            cd = cd.clone()
            cd[0] *= 1.01
            return cd, fid

        self.metrics = altered


class HalfBatchServed(serve.Port):
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


class StateUnchanged(train.Port):
    """A step that computes its loss and gradients and leaves the
    parameters as they were."""

    def step(self, partial, gt):
        before = [p.detach().clone() for p in self.state.model.parameters()]
        loss = super().step(partial, gt)
        with torch.no_grad():
            for p, b in zip(self.state.model.parameters(), before):
                p.copy_(b)
        return loss


class HalfBatchTrained(train.Port):
    """A step whose loss is the mean over the first half of the batch."""

    def step(self, partial, gt):
        h = partial.shape[0] // 2
        return super().step(partial[:h].contiguous(), gt[:h].contiguous())


FAULTS = {
    "serve": {"answer_altered": AnswerAltered, "score_altered": ScoreAltered,
              "half_batch": HalfBatchServed},
    "train": {"state_unchanged": StateUnchanged, "half_batch": HalfBatchTrained},
}
CONTROLS = {"serve": ServeControl, "train": TrainControl}

"""Training driver: the trainer's step on host batches, one after another.

Each step copies one host batch to the card as the trainer's host source
does (``torch.from_numpy(batch).to(device)``) and calls
``rfnet_tpu_torch.train.train_step(state, partial, gt, n1, n2)``, inside the
span ``bench.step``; the window ends with a ``synchronize()``.

Set-up builds one training state (the configuration's weights, the step
count they were trained to, Adam) and drives it through the first three
steps by the window's own call, on three distinct batches of the pool; the
window goes on from there with the same state. The check follows those
three steps with the reference's trainer and compares, with the contract's
measures:

* ``loss_gap``: each step's loss, relative to the reference's, worst step;
* ``grad_gap``: the first step's gradient as Adam holds it (its first
  moment over 1 − b1), each leaf's norm against the reference's, relative
  to the larger of that leaf's reference norm and the median leaf's;
* ``change_gap``: each leaf's change over the three steps, likewise, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move by rounding alone).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import flops
from benchmark.drivers.serve import worst
from benchmark.harness import ROOT
from benchmark.reference import losses as ref_losses
from benchmark.reference import rfnet as ref
from benchmark.traffic import synthetic

CHECKED_STEPS = 3


def flax_name(name: str) -> str:
    """A parameter's ``state_dict`` name as its flax path (the reference's)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def weights_step(path: str) -> int:
    with np.load(path) as z:
        return int(z["__step__"]) if "__step__" in z.files else 0


class Port:
    """The program under test: the trainer's state and step."""

    def __init__(self, cell: dict, device: torch.device):
        from rfnet_tpu_torch import eval as ev
        from rfnet_tpu_torch import train

        cfg = cell["config"]
        self.train, self.device = train, device
        weights = os.path.join(ROOT, cfg["weights"])
        config = train.TrainConfig(batch_size=cell["traffic"]["batch"], innum=cfg["innum"],
                                   ptnum=cfg["ptnum"], n_seed=cfg["n_seed"],
                                   up_ratio=cfg["up_ratio"], compute_dtype=cfg["dtype"])
        self.state = train.create_state(config, device)
        self.state.model.load_state_dict(ev.load_state(weights).state_dict())
        self.state.step = weights_step(weights)
        self.n1, self.n2 = 2 * cfg["n_seed"], 2 * cfg["n_seed"] * cfg["up_ratio"]

    def place(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(self.device)

    def step(self, partial: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        report, _ = self.train.train_step(self.state, partial, gt, n1=self.n1, n2=self.n2)
        return report.total

    def params(self) -> dict[str, torch.Tensor]:
        return {flax_name(k): p for k, p in self.state.model.named_parameters()}

    def first_moments(self) -> tuple[dict[str, torch.Tensor], float]:
        """Adam's first moment of each parameter that has one, and b1."""
        opt = self.state.optimizer
        names = {id(p): flax_name(k) for k, p in self.state.model.named_parameters()}
        moments = {names[id(p)]: s["exp_avg"] for p, s in opt.state.items() if "exp_avg" in s}
        return moments, opt.param_groups[0]["betas"][0]


def _norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: torch.linalg.vector_norm(v.detach().double()).item() for k, v in tensors.items()}


def norm_gap(prog: dict[str, float], refn: dict[str, float], leaves, over=None) -> float:
    """|‖prog‖ − ‖ref‖| / max(‖ref‖ of the leaf, of the median leaf), at the
    worst leaf (or reduced over the leaves by ``over``)."""
    floor = float(np.median([refn[k] for k in leaves]))
    gaps = [abs(prog.get(k, 0.0) - refn[k]) / max(refn[k], floor) for k in leaves]
    if over is not None:
        return float(over(gaps))
    gap = 0.0
    for g in gaps:
        gap = worst(gap, g)
    return gap


class Driver:
    def __init__(self, cell: dict, seed: int, device: torch.device, program=None):
        self.cell, self.device, self.spec = cell, device, cell["spec"]
        self.batch = cell["traffic"]["batch"]
        self.partials, self.gts = synthetic.pool(cell["traffic"], seed)
        if len(self.partials) <= CHECKED_STEPS:
            raise ValueError("the pool needs more batches than the checked steps")
        self.prog = (program or Port)(cell, device)
        self.losses: list[torch.Tensor] = []
        self.host_s: list[float] = []

    def _step(self, slot: int) -> torch.Tensor:
        t = time.perf_counter()
        with record_function("bench.step"):
            partial = self.prog.place(self.partials[slot])
            gt = self.prog.place(self.gts[slot])
            loss = self.prog.step(partial, gt)
        self.host_s.append(time.perf_counter() - t)
        return loss

    def warm(self) -> None:
        """The first steps, read for the check as they go: each loss, Adam's
        first moment after the first, each leaf's change after the first
        and after the last."""
        start = {k: p.detach().clone() for k, p in self.prog.params().items()}
        self.first_losses, self.change_norms = [], {}
        for k in range(CHECKED_STEPS):
            self.first_losses.append(self._step(k).item())
            if k == 0:
                moments, b1 = self.prog.first_moments()
                self.grad_norms = {n: v / (1.0 - b1) for n, v in _norms(moments).items()}
            if k in (0, CHECKED_STEPS - 1):
                now = self.prog.params()
                self.change_norms[k + 1] = _norms({n: now[n].detach() - start[n] for n in start})
        self.host_s = []

    def step(self, i: int) -> None:
        self.losses.append(self._step((CHECKED_STEPS + i) % len(self.partials)))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_to_end(self, window_s: float) -> dict:
        return {"train_clouds_per_s": self.batch * len(self.losses) / window_s}

    def tally(self) -> tuple[int, int]:
        finite = torch.isfinite(torch.stack(self.losses).float()).cpu().numpy()
        return self.batch * len(self.losses), int((~finite).sum())

    def work(self):
        cfg = self.cell["config"]
        return (flops.train_matmuls(cfg, self.batch), flops.train_scan_flops(cfg) * self.batch)

    def release(self) -> None:
        del self.prog
        self.losses = []

    def check(self) -> list[tuple[str, float, float]]:
        dev = self.device
        params, step = ref.load_npz(os.path.join(ROOT, self.cell["config"]["weights"]), dev)
        ref_losses_seen, change = [], {}
        with ref.full_fp32():
            trainer = ref_losses.Trainer(params, step, "fp32")
            start = {k: v.detach().clone() for k, v in trainer.params.items()}
            for k in range(CHECKED_STEPS):
                part = torch.from_numpy(self.partials[k]).to(dev)
                gt = torch.from_numpy(self.gts[k]).to(dev)
                ref_losses_seen.append(trainer.step(part, gt).item())
                if k == 0:
                    grads = _norms({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                    for n, p in trainer.params.items()})
                if k in (0, CHECKED_STEPS - 1):
                    change[k + 1] = _norms({n: p.detach() - start[n]
                                            for n, p in trainer.params.items()})
        steps = [abs(a - b) / abs(b) for a, b in zip(self.first_losses, ref_losses_seen)]
        floor = 1e-3 * float(np.median(list(grads.values())))
        moving = [k for k in grads if grads[k] >= floor]
        last = CHECKED_STEPS
        self.details = {
            "loss_gaps": steps,
            "grad_gap": norm_gap(self.grad_norms, grads, list(grads)),
            "grad_gap_median": norm_gap(self.grad_norms, grads, list(grads), np.median),
            "change1_gap": norm_gap(self.change_norms[1], change[1], moving),
            "change1_gap_median": norm_gap(self.change_norms[1], change[1], moving, np.median),
            f"change{last}_gap": norm_gap(self.change_norms[last], change[last], moving),
            f"change{last}_gap_median": norm_gap(self.change_norms[last], change[last], moving,
                                                 np.median),
            "leaves_left_out": len(grads) - len(moving),
        }
        loss_gap = 0.0
        for g in steps:
            loss_gap = worst(loss_gap, g)
        limits = self.spec["check"]["limits"]
        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("grad_gap", self.details["grad_gap"], limits["grad_gap"]),
                ("change_gap", self.details[f"change{last}_gap"], limits["change_gap"])]

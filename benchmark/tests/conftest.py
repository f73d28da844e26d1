"""Fixtures of the benchmark's CPU tests: cells cut to a tiny size.

A tiny cell keeps its driver, traffic generator, reference and check, with
the model at 4 seeds and ×4 upsampling (64 input points, 128 out), random
weights written as the flat flax ``.npz`` the configurations name, and a
pool of 8 batches of 4. The port runs its kernels' plain versions on the
CPU.
"""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import harness

torch.set_num_threads(2)  # several test workers share the CPU

TINY = dict(innum=64, ptnum=128, n_seed=4, up_ratio=4)
# The checks' limits at the tiny size, set from its readings on this CPU as
# the cells' are set from theirs on the card: serving, sound runs (5 seeds)
# out4 3.7-4.6e-8, cd 0.86-1.5e-7, fid 0.88-1.2e-7, the control (3 seeds)
# out4 4.1-4.9e-5, cd 1.0-1.6e-3, fid 1.7-2.7e-3; training, sound loss
# 9.7e-7, grad 2.2e-5, change 7.7e-4, the control loss 1.2e-4, grad 2.9e-2,
# change 1.8e-2 (a state left unchanged reads 1).
TINY_LIMITS = {
    "serve_b32": {"out4_gap": 1e-6, "cd_gap": 1e-5, "fid_gap": 1e-5},
    "train_b32": {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 0.3},
}


@pytest.fixture(scope="session")
def tiny_weights(tmp_path_factory) -> str:
    from rfnet_tpu_torch.compat.convert import save_npz
    from rfnet_tpu_torch.models import RFNet

    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    model = RFNet(n_seed=TINY["n_seed"], up_ratio=TINY["up_ratio"],
                  generator=torch.Generator().manual_seed(3))
    save_npz(path, model.state_dict(), 105_000)
    return path


@pytest.fixture
def tiny_cell(tiny_weights):
    def make(name: str) -> dict:
        cell = harness.load_cell(name)
        cell["config"].update(TINY, weights=tiny_weights)
        cell["traffic"].update(innum=TINY["innum"], ptnum=TINY["ptnum"], pool=32, batch=4)
        cell["spec"]["trace_steps"] = 3
        cell["spec"]["check"]["limits"] = dict(TINY_LIMITS[name])
        if "sample_from" in cell["spec"]["check"]:
            cell["spec"]["check"].update(sample_from=6, sample_batches=3)
        return cell
    return make


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def benchmark_files(sub: str = "") -> list[str]:
    base = os.path.join(harness.HERE, sub)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs
                  if f.endswith(".py") and "runs" not in os.path.relpath(d, harness.HERE).split(os.sep))

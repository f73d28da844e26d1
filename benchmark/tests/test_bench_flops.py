"""The closed forms of ``flops.py`` against what ``FlopCounterMode`` counts
on the program: the forward at two tiny sizes and at the published widths
(one cloud), and a whole train step (forward, losses, backward, Adam) at
the two tiny sizes. The scans' closed forms against their pair counts."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops

PUBLISHED = dict(innum=3000, ptnum=16384, n_seed=32, up_ratio=16, state_len=256)
TINY = [dict(innum=64, ptnum=128, n_seed=4, up_ratio=4, state_len=256),
        dict(innum=50, ptnum=72, n_seed=4, up_ratio=3, state_len=256)]


def _clouds(cfg, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(b, cfg["innum"], 3, generator=g) - 0.5,
            torch.rand(b, cfg["ptnum"], 3, generator=g) - 0.5)


def _model(cfg):
    from rfnet_tpu_torch.models import RFNet

    return RFNet(state_len=cfg["state_len"], n_seed=cfg["n_seed"], up_ratio=cfg["up_ratio"],
                 generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("cfg,b", [(TINY[0], 2), (TINY[1], 3), (PUBLISHED, 1)])
def test_forward_matmul_flops(cfg, b):
    model = _model(cfg)
    partial, _ = _clouds(cfg, b)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(partial)
    assert counter.get_total_flops() == flops.total_flops(flops.forward_matmuls(cfg, b))


def test_published_forward_is_the_issue_count():
    assert flops.total_flops(flops.forward_matmuls(PUBLISHED, 1)) == pytest.approx(16.267e9, rel=1e-4)


@pytest.mark.parametrize("cfg,b", [(TINY[0], 2), (TINY[1], 3)])
def test_train_step_matmul_flops(cfg, b):
    from rfnet_tpu_torch import train

    state = train.create_state(train.TrainConfig(batch_size=b, innum=cfg["innum"],
                                                 ptnum=cfg["ptnum"], n_seed=cfg["n_seed"],
                                                 up_ratio=cfg["up_ratio"]), "cpu")
    partial, gt = _clouds(cfg, b, 1)
    n1, n2 = 2 * cfg["n_seed"], 2 * cfg["n_seed"] * cfg["up_ratio"]
    with FlopCounterMode(display=False) as counter:
        train.train_step(state, partial, gt, n1=n1, n2=n2)
    assert counter.get_total_flops() == flops.total_flops(flops.train_matmuls(cfg, b))


def test_every_layer_of_the_forward_is_listed_once():
    names = [x.name for x in flops.forward_layers(PUBLISHED)]
    assert len(names) == len(set(names))
    # the program's dense layers, called once a step where shared
    from rfnet_tpu_torch.nn import Dense, StepDense

    model = _model(PUBLISHED)
    dense = [m for m in model.modules() if isinstance(m, (Dense, StepDense))]
    shared_calls = sum(1 for m in dense if isinstance(m, StepDense)
                       and m.bias.shape[0] == 3) * 2 + sum(
        1 for m in dense if isinstance(m, StepDense) and m.bias.shape[0] == 2)
    assert len(names) == len(dense) + shared_calls


def test_scan_flops():
    c = PUBLISHED
    assert flops.serve_scan_flops(c) == 8 * ((64 + 1024 + 16384) * 3000 + 32 * 3000)
    pyramid = (64 + 1024) * 16384 + 1024 * 64 + 16384 * 1024
    assert flops.train_scan_flops(c) == flops.serve_scan_flops(c) + 8 * pyramid


def test_roofline_takes_the_larger_bound_of_each_product():
    mms = [flops.Matmul("a", 67e12, 1.0), flops.Matmul("b", 1.0, 3.35e12)]
    least, t_f, t_b = flops.roofline_seconds(mms, 67e12, 3.35e12)
    assert least == pytest.approx(2.0) and t_f == pytest.approx(1.0) and t_b == pytest.approx(1.0)

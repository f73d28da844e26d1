"""``serve_snow_b32`` on the CPU at a tiny size: a sound run comes out
correct; the control (the reference one precision below, TF32) and both
planted faults come out not correct; ``flops_snowflake.py``'s closed form
equals ``FlopCounterMode``'s count of the reference's forward."""

from __future__ import annotations

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import controls_snowflake, flops, flops_snowflake, harness
from benchmark.drivers import serve_snowflake

SEED = 2**31 + 11  # past 32 signed bits, as the driver's seeds may be
# every width as published; the point counts cut to a CPU test's
TINY = dict(innum=256, num_pc=32, num_p0=64, up_factors=[2, 2], sa_points=[64, 16])
# The check's limits at the tiny size, from its readings on the CPU (5
# seeds each, 2**31 + 11 to + 15): sound runs out 3.9-4.6e-8, cd 7.4e-8 -
# 1.2e-7, fid 7.8e-8 - 1.3e-7; the control (TF32) out 2.0-2.4e-5, cd 9.8e-4 -
# 2.2e-3, fid 3.3-5.2e-3; one cloud moved out 8.4-8.6e-3, half the batch
# copied out 0.34-0.53.
TINY_LIMITS = {"out_gap": 5e-7, "cd_gap": 1e-5, "fid_gap": 1e-5}


@pytest.fixture
def tiny_snow():
    cell = harness.load_cell("serve_snow_b32")
    cell["config"].update(TINY)
    cell["traffic"].update(innum=TINY["innum"], ptnum=256, pool=16, batch=4)
    cell["spec"]["trace_steps"] = 2
    cell["spec"]["check"].update(sample_from=3, sample_batches=2, block=2,
                                 limits=dict(TINY_LIMITS))
    return cell


def _run(cell, trace=False, program=None, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(), program)


def test_sound_run_is_correct(tiny_snow):
    res = _run(tiny_snow, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["details"]) >= {"seeds_gap", "p0_gap", "p1_gap", "p2_gap", "out_point_gap"}
    assert all(v < 1e-6 for k, v in res["details"].items() if k.endswith("_gap")
               and "answer" not in k), res["details"]


@pytest.mark.parametrize("program", ["control", "answer_altered", "half_batch"])
def test_control_and_faults_are_not_correct(tiny_snow, program):
    res = _run(tiny_snow, program=controls_snowflake.PROGRAMS[program])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("sizes", [TINY, dict(TINY, up_factors=[4], num_pc=16, innum=128)],
                         ids=["tiny", "two_stages"])
def test_closed_form_equals_flop_counter_on_the_reference(sizes):
    cfg = dict(harness.load_cell("serve_snow_b32")["config"], **sizes)
    net = serve_snowflake.reference(cfg, torch.device("cpu"))
    x = torch.rand(2, cfg["innum"], 3, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    assert counter.get_total_flops() == flops.total_flops(flops_snowflake.forward_matmuls(cfg, 2))


def test_published_counts():
    cfg = harness.load_cell("serve_snow_b32")["config"]
    assert flops_snowflake.stage_points(cfg) == [512, 512, 2048, 16384]
    assert flops.total_flops(flops_snowflake.forward_matmuls(cfg, 1)) == 10_931_175_424
    assert flops_snowflake.knn_pairs(cfg) == 6_111_232

"""The port's spans and counters (``rfnet_tpu_torch/tracing.py``) on the CPU.

Without a profiler every span is the shared no-op and no counter records;
the tiny model's forward and a served batch give the same bits with a
profiler around them or not. Under a CPU ``torch.profiler`` one served batch
records exactly its spans: ``eval.dispatch`` (with the batch's ordinal),
inside it ``eval.copy_in`` (the partial), ``rfnet.forward``, ``eval.copy_in``
(the ground truth) and ``eval.metrics``, and the forward's four stages for
each of its three steps, in step order. The dense layers' two counters read
the published widths' closed form. An exported forward holds no profiler
node. K3's counter is checked on the card (``tests/test_torch_gpu.py``).
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import flops
from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch import export, tracing
from rfnet_tpu_torch.models import RFNet

CPU = torch.device("cpu")
PUBLISHED = {"innum": 3000, "n_seed": 32, "up_ratio": 16, "state_len": 256}
# the input columns of each layer (``flops.forward_layers``' names) that hold
# one vector a cloud: a codeword, the state or a max-pool
CLOUD_COLS = {r"cell\d\.state_mlp\.l0": 256, r"recover\d\.mlp\.l0": 256,
              r"init_move\.mlp\.l0": 256, r"init_move\.(feat|pts)mlp\.l0": 512,
              r"init_cell\.state_mlp\.l0": 256, r"decode\d\.(mask|state)_mlp\.l0": 256,
              r"refine\w+\.(self|feat)_mlp\.l0": 256, r"refine\w+\.mlp\.l0": 128}
STAGES = ("rfnet.encode", "rfnet.decode", "rfnet.merge", "rfnet.refine")
NAMES = {"eval.dispatch", "eval.copy_in", "eval.metrics", "rfnet.forward", *STAGES}


@pytest.fixture(autouse=True)
def _fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def _model():
    return RFNet(n_seed=4, up_ratio=4, generator=torch.Generator().manual_seed(5)).eval()


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return rng.rand(b, 64, 3).astype(np.float32), rng.rand(b, 128, 3).astype(np.float32)


def _serve(model, pnp, gnp):
    complete, metrics = teval.make_complete_fn(model)
    return teval.collect(teval.dispatch(complete, metrics, pnp, gnp, CPU))


def _forward(model, pnp):
    with torch.inference_mode():
        return model(torch.from_numpy(pnp)).out4


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn(*args)
    spans = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in NAMES),
                   key=lambda e: e.start_ns())
    return out, spans


def test_without_a_profiler_spans_and_counters_are_off(monkeypatch):
    def entered(*_):
        raise AssertionError("a record was entered with no profiler running")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", entered)
    assert tracing.span("rfnet.forward") is tracing.span("eval.dispatch", batch=3)
    assert tracing.span("rfnet.encode", step=1) is tracing._OFF
    tracing.count("k3.pairs_dense", 10)
    assert tracing.device_counter("k3.pairs_loaded", CPU) is None
    assert tracing.counters() == {} and not tracing._device
    model = _model()
    pnp, gnp = _batch()
    _forward(model, pnp)  # no record entered on the way
    _serve(model, pnp, gnp)


def test_outputs_bit_equal_with_a_profiler_around_them():
    model = _model()
    pnp, gnp = _batch(1)
    plain_out, plain_served = _forward(model, pnp), _serve(model, pnp, gnp)
    traced_out, _ = _profiled(_forward, model, pnp)
    traced_served, spans = _profiled(_serve, model, pnp, gnp)
    assert spans  # the profiler recorded the spans
    torch.testing.assert_close(traced_out, plain_out, rtol=0, atol=0)
    for got, want in zip(traced_served, plain_served):
        np.testing.assert_array_equal(got, want)


def test_counters_count_only_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("k3.pairs_dense", 7)
        tracing.count("k3.pairs_dense", 5)
    tracing.count("k3.pairs_dense", 100)  # the profiler has stopped
    assert tracing.counters() == {"k3.pairs_dense": 12}
    tracing.reset()
    assert tracing.counters() == {}


def test_one_batch_records_exactly_its_spans_in_order():
    model = _model()
    pnp, gnp = _batch(2)

    def two_batches():
        _serve(model, pnp, gnp)
        _serve(model, pnp, gnp)

    _, spans = _profiled(two_batches)
    dispatches = [e for e in spans if e.name() == "eval.dispatch"]
    assert len(dispatches) == 2
    first, second = (e.kwinputs()["batch"] for e in dispatches)
    assert second == first + 1  # each batch carries its ordinal

    def ends(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    lo, hi = ends(dispatches[0])
    batch = [e for e in spans if lo <= e.start_ns() and ends(e)[1] <= hi]
    names = [e.name() for e in batch]
    assert sorted(names) == sorted(["eval.dispatch", "eval.copy_in", "rfnet.forward",
                                    "eval.copy_in", "eval.metrics", *STAGES * 3])
    # dispatch holds the partial's copy in, the forward, the ground truth's
    # copy in and the metrics, one after another
    outer = [e for e in batch if e.name() in ("eval.copy_in", "rfnet.forward", "eval.metrics")]
    assert [e.name() for e in outer] == ["eval.copy_in", "rfnet.forward", "eval.copy_in",
                                         "eval.metrics"]
    assert all(ends(a)[1] <= ends(b)[0] for a, b in zip(outer, outer[1:]))
    # the stages: inside the forward, one after another, in step order
    f0, f1 = ends(outer[1])
    stages = [e for e in batch if e.name() in STAGES]
    assert [(e.name(), e.kwinputs()["step"]) for e in stages] == [
        (name, step) for step in (1, 2, 3) for name in STAGES]
    assert all(f0 <= ends(e)[0] and ends(e)[1] <= f1 for e in stages)
    assert all(ends(a)[1] <= ends(b)[0] for a, b in zip(stages, stages[1:]))


def test_export_holds_no_profiler_node():
    exported = export.export_forward(_model(), 2, innum=64)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_dense_counters_read_the_published_closed_form():
    """One forward of the published widths at batch 1: the multiply-adds
    over per-cloud columns done once a cloud instead of at every point, and
    those done at every point, equal their closed forms from the published
    layer list (2.837e9 and 5.296e9, a share of 34.89 %). With no profiler
    neither counter is added to."""
    saved = point = 0
    for layer in flops.forward_layers(PUBLISHED):
        cols = [c for k, c in CLOUD_COLS.items() if re.fullmatch(k, layer.name)]
        cloud = cols[0] if cols else 0
        saved += layer.rows * cloud * layer.d_out
        point += layer.rows * (layer.d_in - cloud) * layer.d_out
    assert (saved, point) == (2_837_446_656, 5_296_123_904)
    model = RFNet(generator=torch.Generator().manual_seed(5)).eval()
    x = np.random.RandomState(3).rand(1, PUBLISHED["innum"], 3).astype(np.float32)
    _forward(model, x)
    assert tracing.counters() == {}
    _profiled(_forward, model, x)
    got = tracing.counters()
    assert (got["dense.macs_per_cloud_saved"], got["dense.macs_per_point"]) == (saved, point)
    share = 100 * saved / (saved + point)
    assert round(share, 2) == 34.89

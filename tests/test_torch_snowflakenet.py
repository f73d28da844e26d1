"""SnowflakeNet (``rfnet_tpu_torch/models/snowflakenet.py``) on the CPU.

The program against the benchmark's plain reference
(``benchmark/reference/snowflakenet.py``, the published code in plain
``torch``) on seeded random weights at every published channel width and
small point counts; the k-NN op (``ops/knn.py``, K10's plain version)
against the reference's k-NN, with planted exact ties and every point's
distance to itself 0; the eval CLI's ``--model snowflakenet`` end to end on
two ``.pcd`` files; loading by the checkpoint's keys; and the model's spans
and counters under a profiler. K10 itself is held to the plain version on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 15).
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import flops_snowflake
from benchmark.reference import snowflakenet as ref
from rfnet_tpu_torch import eval as teval
from rfnet_tpu_torch import tracing
from rfnet_tpu_torch.data import pcd_io
from rfnet_tpu_torch.models.snowflakenet import SnowflakeNet
from rfnet_tpu_torch.ops import knn

# every channel width as published; 2 clouds of 256 points, set abstraction
# centres 64 and 16, 32 seeds, P0 64, up factors [1, 2, 2]: 64 -> 64 -> 128 -> 256
SMALL = dict(num_pc=32, num_p0=64, up_factors=(2, 2), sa_points=(64, 16), input_points=256)
STAGES = ("seeds", "p0", "p1", "p2", "p3")
# The program multiplies per point with F.linear, folds BatchNorm into the
# convolution before it and multiplies the global feature once a cloud; the
# reference convolves the published way. Both are float32, so every point
# agrees to float32 rounding carried through the layers: 1.3e-7 at most
# over seeds 1-3 at coordinates up to 0.76. The tolerance is 5x that and
# more; the reference one precision down (TF32 operands) moves the points
# up to 4.3e-5 to 6.9e-5 on those seeds, 40x the tolerance and more.
ATOL = 1e-6


def _weights(seed: int) -> dict:
    """The reference's weights at the small sizes, in the published shapes,
    BatchNorm's statistics and affine parameters far from their init."""
    return ref.draw_weights(ref.published_shapes(num_pc=32, up_factors=(2, 2)), seed)


def _model(seed: int) -> SnowflakeNet:
    model = SnowflakeNet(**SMALL)
    model.load_state_dict(_weights(seed), strict=True)
    return model.eval()


def _partial(seed: int, b: int = 2, n: int = 256) -> torch.Tensor:
    return torch.rand(b, n, 3, generator=torch.Generator().manual_seed(seed)) - 0.5


def _stages(out) -> dict:
    return dict(zip(STAGES, (out.seeds, out.p0, *out.stages)))


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_matches_the_reference(seed):
    weights, x = _weights(seed), _partial(seed + 10)
    model = _model(seed)
    with torch.inference_mode():
        got = _stages(model(x))
        want = ref.Net(weights, num_p0=64, sa_points=(64, 16))(x)
        tf32 = ref.Net(weights, "tf32", num_p0=64, sa_points=(64, 16))(x)
    assert [got[k].shape[1] for k in STAGES] == [32, 64, 64, 128, 256]
    for k in STAGES:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=ATOL)
    assert (tf32["p3"] - want["p3"]).abs().max() > 5 * ATOL  # the tolerance sees TF32
    assert torch.equal(got["p3"], model(x).out4)


def test_published_size_and_parameters():
    model = teval.load_state(None, model="snowflakenet")
    assert teval.count_params(model) == 19_317_612 and model.input_points == 2048
    same = SnowflakeNet(generator=torch.Generator().manual_seed(teval.RANDOM_INIT_SEED))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 same.state_dict().values()))
    assert flops_snowflake.stage_points(dict(num_p0=512, up_factors=[4, 8])) == [512, 512, 2048,
                                                                                   16384]
    # the reference's list of the published tensors names every one of the
    # program's, each as many numbers (1x1 weights without their kernel dims)
    shapes = ref.published_shapes()
    assert set(shapes) == set(model.state_dict())
    assert all(torch.Size(shapes[k]).numel() == v.numel() for k, v in model.state_dict().items())


def _cloud(seed, b, n):
    return torch.rand(b, n, 3, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n,m", [(64, 300), (200, 200), (7, 16)])
def test_knn_plain_matches_the_reference(n, m):
    t, q = _cloud(1, 3, m), _cloud(2, 3, n)
    d, i = knn.knn(16, t, q)
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (3, n, 16)
    want = ref.knn(16, t, q)
    assert torch.equal(i.long(), want)
    torch.testing.assert_close(d, ref.sq_dist(q, t).gather(2, want), rtol=0, atol=0)
    assert (d[..., 1:] >= d[..., :-1]).all()


def test_knn_ties_go_to_the_lower_index_and_self_is_first():
    # on a 1/4 grid many distances tie exactly, and every point has copies
    pts = torch.from_numpy(np.random.RandomState(3).randint(0, 3, (2, 300, 3)) / 4).float()
    d, i = knn.knn(16, pts, pts)
    assert torch.equal(i.long(), ref.knn(16, pts, pts))
    assert (d[..., 0] == 0).all()
    same = d[..., 1:] == d[..., :-1]
    assert same.sum() > 1000 and (i[..., 1:][same] > i[..., :-1][same]).all()
    # a point with no copy below it is its own nearest
    first = torch.ones(2, 300, dtype=torch.bool)
    for b in range(2):
        seen = set()
        for j, p in enumerate(map(tuple, pts[b].tolist())):
            first[b, j] = p not in seen
            seen.add(p)
    assert (i[..., 0][first] == torch.arange(300).expand(2, -1)[first]).all()


def test_knn_refuses_too_few_targets():
    with pytest.raises(ValueError):
        knn.knn(16, _cloud(0, 1, 15), _cloud(1, 1, 4))


def test_eval_cli_serves_snowflakenet(tmp_path, capsys):
    """``--model snowflakenet`` with no checkpoint: the published model's
    seeded init serves two .pcd files (partials resampled to 2 048 points)
    at batch 2 and batch 1, the same completions both ways."""
    rng = np.random.RandomState(4)
    ids = ["0001/a", "0002/b"]
    for mid in ids:
        for kind, n in (("partial", 1500), ("complete", 4096)):
            path = os.path.join(tmp_path, "data", kind, mid + ".pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            pcd_io.save_pcd(path, rng.rand(n, 3).astype(np.float32) - 0.5)
    list_path = os.path.join(tmp_path, "test.list")
    with open(list_path, "w") as f:
        f.write("\n".join(ids))
    served = {}
    for bs in ("2", "1"):
        out = os.path.join(tmp_path, "results" + bs)
        np.random.seed(0)  # the loader's resampling draws from numpy's global generator
        teval.main(["--model", "snowflakenet", "--list_path", list_path, "--data_dir",
                    os.path.join(tmp_path, "data"), "--checkpoint", os.path.join(tmp_path, "no"),
                    "--results_dir", out, "--num_gt_points", "4096", "--batch_size", bs,
                    "--plot_freq", "1000", "--save_pcd", "--device", "cpu"])
        served[bs] = [pcd_io.read_pcd(os.path.join(out, "pcds", mid + ".pcd")) for mid in ids]
        with open(os.path.join(out, "results.csv")) as f:
            rows = f.read().splitlines()
        assert rows[0] == "id,cd,emd" and len(rows) == 3
        assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    assert "trainable parameters: 19317612" in capsys.readouterr().out
    for a, b in zip(served["2"], served["1"]):
        assert a.shape == (16384, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_load_state_picks_the_model_by_its_keys(tmp_path):
    small = SnowflakeNet(num_pc=32, up_factors=(2, 2), generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "snow.pt")
    torch.save(small.state_dict(), path)
    got = teval.load_state(path)
    assert isinstance(got, SnowflakeNet)
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 small.state_dict().values()))
    with pytest.raises(SystemExit):
        teval.load_state(path, model="rfnet")
    with pytest.raises(SystemExit):
        teval.load_state(None, torch.bfloat16, model="snowflakenet")
    # published shapes (1x1 weights with their kernel dims) and the sizes
    # the weights do not hold
    published = str(tmp_path / "published.pt")
    torch.save(_weights(9), published)
    got = teval.load_state(published, model="snowflakenet",
                           sizes=dict(num_p0=64, sa_points=(64, 16), input_points=256))
    want = _model(9)
    assert got.input_points == 256 and got.decoder.num_p0 == 64
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 want.state_dict().values()))
    x = _partial(10)
    with torch.inference_mode():
        assert torch.equal(got(x).out4, want(x).out4)


def test_spans_and_counters_fire_under_a_profiler():
    tracing.reset()
    model, x = _model(7), _partial(8)
    with torch.inference_mode():
        plain = model(x).out4
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with torch.inference_mode():
            traced = model(x).out4
    counts = tracing.counters()
    tracing.reset()
    assert torch.equal(traced, plain)
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                      key=lambda e: e.start_ns())
             if e.name().startswith("snow.")]
    assert names.count("snow.forward") == 1 and names.count("snow.extract") == 1
    assert names.count("snow.seed") == 1 and names.count("snow.spd") == 3
    attn = [e for e in prof.profiler.kineto_results.events() if e.name() == "snow.attn"]
    assert sorted(e.kwinputs()["block"] for e in attn) == [0, 1, 2, 3, 4]
    spd = [e for e in prof.profiler.kineto_results.events() if e.name() == "snow.spd"]
    assert sorted(e.kwinputs()["step"] for e in spd) == [0, 1, 2]
    # the CPU's plain k-NN launches nothing, so counts nothing
    assert "knn.launches" not in counts and "knn.pairs" not in counts


def test_knn_counts_k10_launches(monkeypatch):
    """``knn.launches`` and ``knn.pairs`` count each K10 launch (here a
    stand-in that writes the plain version's answer) under a profiler, and
    nothing without one."""
    t, q = _cloud(3, 2, 300), _cloud(4, 2, 64)

    def launch(name, device, queries, targets, b, n, m, k, dist, idx):
        assert name == "knn" and (b, n, m, k) == (2, 64, 300, 16)
        dist[:], idx[:] = knn._knn_plain(k, targets, queries)

    monkeypatch.setattr(knn.kernels, "launch", launch)
    tracing.reset()
    knn._knn_launch(16, t, q)
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        d, i = knn._knn_launch(16, t, q)
        knn._knn_launch(16, t, q)
    counts = tracing.counters()
    tracing.reset()
    assert counts == {"knn.pairs": 2 * 2 * 64 * 300, "knn.launches": 2}
    assert torch.equal(i.long(), ref.knn(16, t, q))

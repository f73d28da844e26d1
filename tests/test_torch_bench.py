"""The port's measurement entry points (``bench_torch.py``,
``tools/verify_onchip_torch.py``, ``tools/profile_forward_torch.py``,
``tools/profile_trainstep_torch.py``) on the CPU at a tiny size: the
benchmark's FLOP counts against ``bench.py``'s closed form and the model's
layer shapes, its breakdown components against the JAX functions on the
same inputs and weights, and each tool run where JAX cannot be imported.
Also ``tools/bench_torch_k1_k3.py`` past its argument parsing, with the
card stubbed."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfnet_tpu import losses as jlosses
from rfnet_tpu.models import RFNet as JRFNet
from rfnet_tpu.ops.chamfer import chamfer_means_pair as j_chamfer_means_pair
from rfnet_tpu.ops.fps import farthest_point_sample as jfps
from rfnet_tpu.ops.fps import gather_point as jgather
from rfnet_tpu.train import TrainConfig as JTrainConfig
from rfnet_tpu_torch import losses
from rfnet_tpu_torch.compat.convert import flatten_params, flax_to_state_dict
from rfnet_tpu_torch.models import RFNet
from rfnet_tpu_torch.train import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# runs a script's __main__ where neither JAX nor the JAX package can be imported
BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['rfnet_tpu'] = None; "
           "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")
TOOLS = {"bench": "bench_torch.py", "verify": "tools/verify_onchip_torch.py",
         "forward": "tools/profile_forward_torch.py",
         "trainstep": "tools/profile_trainstep_torch.py"}
TINY_ARGS = {"bench": [], "verify": [], "forward": ["--iters", "1"],
             "trainstep": ["--iters", "1"]}
B = 4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("bench", "bench.py")  # the JAX benchmark; main() does not run
bench_torch = _load("bench_torch", "bench_torch.py")
CONFIG = TrainConfig(**bench_torch.TINY)
N1, N2 = bench_torch.pyramid_sizes(CONFIG)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("b", [4, 32])
def test_kernel_train_flops_equal_bench_closed_form(b):
    """``_kernel_train_flops`` is ``bench.py``'s ``_pallas_train_flops`` at
    the full width (the kernels' pair count of one train step)."""
    assert bench_torch._kernel_train_flops(b, TrainConfig()) == \
        bench._pallas_train_flops(b, JTrainConfig())


@pytest.mark.parametrize("n_seed,up_ratio,innum", [(4, 4, 64), (2, 8, 40)])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_forward_flop_count_equals_layer_closed_form(n_seed, up_ratio, innum, dtype):
    """FlopCounterMode over a forward counts 2·Σ rows·in·out over the
    model's Dense/StepDense layers and the 3×3 seed transform, nothing
    else (the kernels' plain versions do no matrix product), in float32 and
    bfloat16; at batch 3 three times one cloud's."""
    model = RFNet(n_seed=n_seed, up_ratio=up_ratio, dtype=dtype)
    x = torch.from_numpy(np.random.RandomState(0).rand(3, innum, 3).astype(np.float32))
    with torch.no_grad():
        counted = bench_torch.matmul_flops(model, x)
    flops, elems = bench_torch.forward_layer_costs(model, innum)
    assert counted == 3 * flops
    assert elems > 0


@pytest.fixture(scope="module")
def pair():
    """The JAX model's tiny flax parameters and the port model holding them,
    with ``bench.py``'s breakdown clouds at batch 4."""
    jmodel = JRFNet(n_seed=CONFIG.n_seed, up_ratio=CONFIG.up_ratio)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, CONFIG.innum, 3), jnp.float32))
    model = RFNet(n_seed=CONFIG.n_seed, up_ratio=CONFIG.up_ratio)
    model.load_state_dict(flax_to_state_dict(flatten_params(params["params"])), strict=True)
    inputs = bench_torch.breakdown_inputs(CONFIG, B)
    return jmodel, params, model, inputs


def _t(inputs, *names):
    return [torch.from_numpy(inputs[n]) for n in names]


def _j(inputs, *names):
    return [jnp.asarray(inputs[n]) for n in names]


def _value_and_grads(f, argnums, *args):
    return jax.jit(jax.value_and_grad(f, argnums=argnums))(*args)


def test_breakdown_inputs_are_bench_py_draws():
    """At the full width the breakdown's clouds are ``bench.py``'s:
    ``RandomState(1)`` draws of 8 clouds at batch 32 in its order."""
    got = bench_torch.breakdown_inputs(TrainConfig(), 2)
    rng = np.random.RandomState(1)
    for name, n in (("partial", 3000), ("gt", 16384), ("out3", 16384), ("out4", 16384),
                    ("gt1", 64), ("gt2", 1024), ("p1", 64), ("p2", 1024)):
        assert np.array_equal(got[name], rng.rand(2, n, 3).astype(np.float32)), name


def test_cd34_component_matches_jax(pair):
    """cd3 + cd4's means and their gradients in out3, out4: values 1e-5
    relative, gradients 1e-4 relative L2."""
    inputs = pair[3]
    v, g = bench_torch.cd34(*_t(inputs, "gt", "out3", "out4"))
    gt, o3, o4 = _j(inputs, "gt", "out3", "out4")
    jv, jg = _value_and_grads(lambda a, c: sum(j_chamfer_means_pair(gt, a, c)), (0, 1), o3, o4)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
    for got, want in zip(g, jg):
        assert _rel(got.numpy(), want) < 1e-4


def test_emd_component_matches_jax(pair):
    """The two pyramid EMD terms and their gradients."""
    inputs = pair[3]
    v, g = bench_torch.emd(*_t(inputs, "gt1", "gt2", "p1", "p2"))
    g1, g2, p1, p2 = _j(inputs, "gt1", "gt2", "p1", "p2")
    jv, jg = _value_and_grads(
        lambda a, c: jlosses.earth_mover(g1, a) + jlosses.earth_mover(g2, c), (0, 1), p1, p2)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
    for got, want in zip(g, jg):
        assert _rel(got.numpy(), want) < 1e-4


def test_recd_component_matches_jax(pair):
    """``re_chamfer`` (8 slices) and its gradient."""
    inputs = pair[3]
    v, (g,) = bench_torch.recd(*_t(inputs, "gt", "out3"))
    gt, o3 = _j(inputs, "gt", "out3")
    jv, jg = _value_and_grads(lambda a: jlosses.re_chamfer(gt, a, part=8), 0, o3)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
    assert _rel(g.numpy(), jg) < 1e-4


def test_fps_pyramids_and_eval_emd_components_match_jax(pair):
    """The FPS pyramids' indices exactly, the gathered points bit for bit;
    the eval EMD at batch 4 to 1e-5 relative."""
    inputs = pair[3]
    (gt,) = _t(inputs, "gt")
    (jgt,) = _j(inputs, "gt")
    i1, i2, pyr1, pyr2 = bench_torch.fps_pyramids(gt, N1, N2)
    for n, idx, pyr in ((N1, i1, pyr1), (N2, i2, pyr2)):
        jidx = jfps(n, jgt)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert np.array_equal(pyr.numpy(), np.asarray(jgather(jgt, jidx)))
    out4, jout4 = _t(inputs, "out4")[0], _j(inputs, "out4")[0]
    with torch.no_grad():
        v = losses.earth_mover_eval(gt[:bench_torch.EVAL_BATCH], out4[:bench_torch.EVAL_BATCH])
    jv = jax.jit(jlosses.earth_mover_eval)(jgt[:bench_torch.EVAL_BATCH],
                                           jout4[:bench_torch.EVAL_BATCH])
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)


def test_forward_and_train_step_components_match_jax(pair):
    """The breakdown's forward (out3, out4 to rtol 1e-4 / atol 1e-5, as the
    model's tests) and its train step's total loss (1e-3) from the same
    weights and batch; the step runs on a copy, leaving the model as it was."""
    jmodel, params, model, inputs = pair
    partial, gt = _t(inputs, "partial", "gt")
    jpartial, jgt = _j(inputs, "partial", "gt")
    o3, o4 = bench_torch.forward34(model, partial)
    jout = jax.jit(jmodel.apply)(params, jpartial)
    np.testing.assert_allclose(o3.numpy(), np.asarray(jout.out3), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(o4.numpy(), np.asarray(jout.out4), rtol=1e-4, atol=1e-5)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = bench_torch.copy_for_training(model, CONFIG, torch.device("cpu"))
    total = bench_torch.step_total(state, partial, gt, N1, N2)

    @jax.jit
    def jtotal(p, x, g):
        g1 = jgather(g, jfps(N1, g))
        g2 = jgather(g, jfps(N2, g))
        return jlosses.total_loss(jmodel.apply(p, x), g, g1, g2, 0).total

    np.testing.assert_allclose(float(total), float(jtotal(params, jpartial, jgt)), rtol=1e-3)
    assert state.step == 1
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Each tool with ``--device cpu --tiny`` in its own interpreter where
    ``jax`` and ``rfnet_tpu`` cannot be imported, the four at once; the
    validation sweep is pointed at a scratch artifact path."""
    out = tmp_path_factory.mktemp("tiny") / "onchip.json"
    procs = {}
    for name, path in TOOLS.items():
        argv = ["--device", "cpu", "--tiny", *TINY_ARGS[name]]
        if name == "verify":
            argv += ["--out", str(out)]
        # two threads each: four processes of a full thread pool each
        # oversubscribe the cores many times over
        procs[name] = subprocess.Popen([sys.executable, "-c", BLOCKED, os.path.join(REPO, path),
                                        *argv], cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True,
                                       env={**os.environ, "OMP_NUM_THREADS": "2"})
    runs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        runs[name] = (proc.returncode, stdout, stderr)
    return runs, out


def test_bench_tiny_runs_without_jax_and_names_the_cpu(tiny_runs):
    """One JSON line naming device cpu: the headline and every breakdown key
    of ``bench.py`` but the dropped two, no share, rate, roofline or memory
    key, and matmul FLOPs equal to the layer closed form."""
    rc, stdout, stderr = tiny_runs[0]["bench"]
    assert rc == 0, stderr[-3000:]
    (line,) = stdout.strip().splitlines()
    got = json.loads(line)
    assert got["metric"] == "completion_throughput_16384pts" and got["value"] > 0
    assert got["device"] == {"name": "cpu", "power_limit_w": None, "count": 1}
    keys = set(got["breakdown"])
    assert {"fwd_b32_ms", "cd34_fb_b32_ms", "cd34_fb_real_b32_ms", "emd_fb_b32_ms",
            "recd_fb_b32_ms", "fps_pyramids_b32_ms", "eval_emd_16k_b4_ms",
            "train_step_b32_ms", "cd34_fb_indist_b32_ms", "train_step_indist_b32_ms",
            "train_gflops_per_cloud", "headline_batch", "fwd_gflops_per_cloud",
            "fwd_b4_ms", "fwd_bf16_b8_clouds_per_sec"} <= keys
    assert not [k for k in keys if "mfu" in k or "roofline" in k or "peak" in k
                or "tflops" in k or "oom" in k]
    model = RFNet(n_seed=CONFIG.n_seed, up_ratio=CONFIG.up_ratio)
    flops, _ = bench_torch.forward_layer_costs(model, CONFIG.innum)
    assert got["breakdown"]["fwd_gflops_per_cloud"] == flops / 1e9
    assert got["breakdown"]["train_kernel_flops"] == bench_torch._kernel_train_flops(B, CONFIG)


def test_verify_tiny_passes_every_check_without_jax_and_writes_nothing(tiny_runs):
    """All 15 checks pass on the plain versions; no artifact is written,
    neither where ``--out`` points nor at the card's default path."""
    runs, out = tiny_runs
    rc, stdout, stderr = runs["verify"]
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    assert json.loads(stdout.strip().splitlines()[-1]) == {"ok": True, "passed": 15,
                                                           "total": 15}
    assert stdout.count("[PASS]") == 15 and "nn_pruned_vs_dense" in stdout
    assert not out.exists()
    assert "wrote" not in stdout


@pytest.mark.parametrize("tool,lines", [("forward", 14), ("trainstep", 12)])
def test_profilers_tiny_run_without_jax(tiny_runs, tool, lines):
    """Each profiler times its stages or components and exits 0."""
    rc, stdout, stderr = tiny_runs[0][tool]
    assert rc == 0, stderr[-3000:]
    timed = [ln for ln in stdout.splitlines() if ln.rstrip().endswith(" ms")]
    assert len(timed) == lines
    assert all(float(ln.split(":")[-1].split()[0]) > 0 for ln in timed)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_refuse_without_a_card(tool, capsys):
    """Without ``--device`` each tool asks for the card, which this machine
    lacks: it exits non-zero before it measures or prints a value."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown here")
    mod = bench_torch if tool == "bench" else _load(tool, TOOLS[tool])
    with pytest.raises(SystemExit) as exc:
        mod.main([])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)
    assert "value" not in capsys.readouterr().out


def test_bench_refuses_a_missing_checkpoint(tmp_path, capsys):
    """A path that holds no weights is an error, not a silent random init."""
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--device", "cpu", "--checkpoint", str(tmp_path / "none.npz")])
    assert "no weights there" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_k1_k3_bench_runs_its_cases(tmp_path, monkeypatch, capsys):
    """``tools/bench_torch_k1_k3.py`` past its argument parsing, with the card
    and ``chip_smoke.py``'s checks stubbed: it prints ptxas' registers of
    its kernels, hands each K3 case to ``chip_smoke.check_k3`` without the
    older tree's library flag, and ends with 0, ``--sweep`` given or not."""
    import chip_smoke
    from rfnet_tpu_torch import kernels
    from tools import bench_torch_k1_k3 as tool

    (tmp_path / "build.log").write_text(
        "ptxas info    : Compiling entry function '_ZN5rfnet13nn_dyn_kernelILi4EEEvPKf' for "
        "'sm_90a'\nptxas info    : Used 40 registers, used 1 barriers\n")
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tool.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"))
    monkeypatch.setattr(kernels, "build", lambda: "")
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tool, "k1_cases", lambda dev: [])
    monkeypatch.setattr(tool, "k3_cases", lambda dev: [("pair", "qs", "ts", False)])
    monkeypatch.setattr(chip_smoke, "check_k3",
                        lambda *a: calls.append(a) or {"device_ms": 0.1})
    for argv in ([], ["--sweep"]):
        assert tool.main(argv) == 0
    assert calls == [("pair", "qs", "ts")] * 2
    assert "ptxas nn_dyn_kernel<4>: Used 40 registers" in capsys.readouterr().out

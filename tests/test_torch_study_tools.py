"""The port's study tools (``tools/*_torch.py`` counterparts of the chamfer
and loss-stack studies) on the CPU: the loss ablation's ``make_loss``
against the JAX tool's on the same fabricated outputs, the walk counts of
``sim_prune_stats_torch`` against brute-force counts, ``inspect_ref_graph``
against the JAX tool on a small MetaGraphDef, every tool's ``--tiny`` run
where JAX cannot be imported, and their refusal without a card."""

import concurrent.futures
import importlib
import importlib.util
import json
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfnet_tpu.models.rfnet import RFNetOutputs as JOutputs
from rfnet_tpu_torch import losses
from rfnet_tpu_torch.compat.tf_bundle import _pb_bytes_field, _pb_tag, _pb_varint_field
from rfnet_tpu_torch.ops import chamfer
from rfnet_tpu_torch.train import TrainConfig
from tools import inspect_ref_graph_torch, profile_loss_ablate_torch, sim_prune_stats_torch
from tools._common_torch import TINY, fabricated_outputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# runs a script's __main__ where neither JAX nor the JAX package can be imported
BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['rfnet_tpu'] = None; "
           "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")
CPU_TINY = ["--device", "cpu", "--tiny", "--iters", "1"]
# tool: its --tiny arguments (the MetaGraphDef's path is added by the fixture)
TOOLS = {
    "bench_chamfer_variants_torch": CPU_TINY,
    "bench_chamfer_backend_torch": CPU_TINY,
    "bench_chamfer_tile_torch": CPU_TINY,
    "bench_chamfer_dyn_torch": CPU_TINY,
    "bench_chamfer_dyn2_torch": CPU_TINY,
    "bench_dyn_realdata_torch": CPU_TINY,
    "bench_bwd_pieces_torch": CPU_TINY,
    "profile_step_gap_torch": CPU_TINY,
    "profile_loss_ablate_torch": CPU_TINY,
    "profile_loss_composites_torch": CPU_TINY,
    "sim_prune_stats_torch": ["--tiny"],
    "inspect_ref_graph_torch": [],
}
CARD_TOOLS = [k for k, v in TOOLS.items() if v is CPU_TINY]
PARALLEL = 6  # tool processes at once (~0.3 GB each)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_ablate = _load("profile_loss_ablate", "tools/profile_loss_ablate.py")
jax_inspect = _load("inspect_ref_graph", "tools/inspect_ref_graph.py")


@pytest.fixture(scope="module")
def loss_inputs():
    """Fabricated outputs of the tiny model (its seeded random init on a
    seeded partial) with the clouds the loss takes, for both packages."""
    outputs, gt, gt1, gt2 = fabricated_outputs(TrainConfig(**TINY), 4, "cpu")
    fields = {k: v.numpy() for k, v in vars(outputs).items()}
    port = (type(outputs)(**{k: torch.from_numpy(v) for k, v in fields.items()}), gt, gt1, gt2)
    jax_in = (JOutputs(**{k: jnp.asarray(v) for k, v in fields.items()}),
              *(jnp.asarray(x.numpy()) for x in (gt, gt1, gt2)))
    return port, jax_in


@pytest.mark.parametrize("drop", profile_loss_ablate_torch.DROPS,
                         ids=profile_loss_ablate_torch.drop_name)
def test_make_loss_matches_jax_tool(loss_inputs, drop):
    """Each drop of the JAX tool (``profile_loss_ablate.py:175``): the same
    value within 1e-5 relative on the same outputs."""
    port, jax_in = loss_inputs
    got = float(profile_loss_ablate_torch.make_loss(set(drop))(*port))
    want = float(jax_ablate.make_loss(set(drop))(*jax_in))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_make_loss_without_drops_is_total_loss(loss_inputs):
    """With nothing dropped it is ``losses.total_loss``'s total at step 0
    (decline-factor weight 0.01), within 1e-6 relative: the same terms
    summed in another order."""
    port, _ = loss_inputs
    got = float(profile_loss_ablate_torch.make_loss(set())(*port))
    want = float(losses.total_loss(*port, 0).total)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _prune_case(name):
    rng = np.random.RandomState(5)
    q = rng.rand(1, 300, 3).astype(np.float32)
    t = rng.rand(1, 420, 3).astype(np.float32)
    if name == "blob":
        q = (0.05 * rng.randn(1, 300, 3) + 0.5).astype(np.float32)
    elif name == "shifted":
        q = q + np.float32(0.6)
    return torch.from_numpy(q), torch.from_numpy(t)


def _gap2(q, lo, hi):
    """float32 squared gap from q (3,) to the box [lo, hi], summed x, y, z."""
    g = np.maximum(np.maximum(lo - q, q - hi), np.float32(0))
    return np.float32(np.float32(g[0] * g[0] + g[1] * g[1]) + g[2] * g[2])


@pytest.mark.parametrize("name", ["uniform", "blob", "shifted"])
def test_k3_counts_match_brute_force(name):
    """K3's z windows and its blocks' slab pairs against loops over every
    query and target."""
    q, t = _prune_case(name)
    qs, ts = chamfer.sort_by_z_with_order(q)[0], chamfer.sort_by_z_with_order(t)[0]
    dist = chamfer._nn_sorted_plain(qs, ts)[0]
    lo, hi = sim_prune_stats_torch.k3_windows(qs, ts, dist)
    qz, tz, r = qs[0, :, 2].numpy(), ts[0, :, 2].numpy(), torch.sqrt(dist[0]).numpy()
    m, slab, block = ts.shape[1], chamfer._NN_DYN_SLAB, sim_prune_stats_torch.K3_BLOCK
    want_lo, want_hi = [], []
    for i in range(qs.shape[1]):
        inside = [j for j in range(m) if qz[i] - r[i] <= tz[j] <= qz[i] + r[i]]
        want_lo.append(inside[0])
        want_hi.append(inside[-1] + 1)
    assert lo[0].tolist() == want_lo and hi[0].tolist() == want_hi
    pairs = 0
    for s in range(0, qs.shape[1], block):
        first = min(want_lo[s:s + block]) // slab
        last = (max(want_hi[s:s + block]) - 1) // slab
        pairs += len(want_lo[s:s + block]) * (min(m, (last + 1) * slab) - first * slab)
    assert sim_prune_stats_torch.k3_block_pairs(lo, hi, m) == pairs


@pytest.mark.parametrize("name", ["uniform", "blob", "shifted"])
def test_tile_walk_counts_match_brute_force(name):
    """K7/K8's unskippable chunk pairs, a warp's union and a block's tiles
    against loops over every query, chunk and tile."""
    q, t = _prune_case(name)
    qs, ts = chamfer.sort_by_z_with_order(q)[0], chamfer.sort_by_z_with_order(t)[0]
    best = chamfer._nn_sorted_plain(qs, ts)[0]
    warp, block, tile_m = 64, 128, 96
    qn, tn, bn = qs[0].numpy(), ts[0].numpy(), best[0].numpy()
    n, m = len(qn), len(tn)

    def needs(i, lo_j, hi_j):
        box = tn[lo_j:hi_j]
        return _gap2(qn[i], box.min(0), box.max(0)) <= bn[i]

    chunks = [(c, min(c + 32, m)) for c in range(0, m, 32)]
    need = [[needs(i, a, b) for a, b in chunks] for i in range(n)]
    pairs = sum((b - a) * need[i][k] for i in range(n) for k, (a, b) in enumerate(chunks))
    union = 0
    for w in range(0, n, warp):
        rows = need[w:w + warp]
        union += len(rows) * sum(b - a for k, (a, b) in enumerate(chunks)
                                 if any(r[k] for r in rows))
    tiles = sum(any(needs(i, a, min(a + tile_m, m)) for i in range(s, min(s + block, n)))
                for s in range(0, n, block) for a in range(0, m, tile_m))
    got_pairs, got_union = sim_prune_stats_torch.tiled_needed_pairs(qs, ts, best, warp)
    assert (got_pairs, got_union) == (pairs, union)
    assert sim_prune_stats_torch.tiles_needed(qs, ts, best, block, tile_m) == tiles


def _node(name, op, inputs=(), tensor=None) -> bytes:
    body = _pb_bytes_field(1, name.encode()) + _pb_bytes_field(2, op.encode())
    for i in inputs:
        body += _pb_bytes_field(3, i.encode())
    if tensor is not None:  # attr {key: "value", value {tensor}}
        entry = _pb_bytes_field(1, b"value") + _pb_bytes_field(2, _pb_bytes_field(8, tensor))
        body += _pb_bytes_field(5, entry)
    return _pb_bytes_field(1, body)


def _float32(v) -> bytes:  # dtype DT_FLOAT, one fixed32 float_val
    return _pb_varint_field(1, 1) + _pb_tag(5, 5) + struct.pack("<f", v)


def _int32(v) -> bytes:  # dtype DT_INT32, one int_val
    return _pb_varint_field(1, 3) + _pb_varint_field(7, v)


def _write_meta(path: str) -> None:
    """A MetaGraphDef with the parts the tools read: two piecewise schedules
    (boundaries as int_val, packed varints and int64 content; values as
    float_val, packed floats and float content), the Adam constants, a
    gradient root and a loss tree with constant weights, and an op census."""
    nodes = [
        _node("alpha_op/Const", "Const", tensor=_int32(50000)),
        _node("alpha_op/Const_1", "Const",
              tensor=_pb_varint_field(1, 3) + _pb_bytes_field(7, bytes([0xa0, 0x8d, 0x06]))),
        _node("alpha_op/Const_2", "Const", tensor=_float32(0.0005)),
        _node("alpha_op/Const_3", "Const",
              tensor=_pb_varint_field(1, 1) + _pb_bytes_field(5, struct.pack("<f", 0.0002))),
        _node("alpha_op/inner/Const", "Const", tensor=_float32(9.0)),
        _node("alpha_op_1/Const", "Const",
              tensor=_pb_varint_field(1, 9) + _pb_bytes_field(4, struct.pack("<q", 150000))),
        _node("alpha_op_1/Const_1", "Const",
              tensor=_pb_varint_field(1, 1) + _pb_bytes_field(4, struct.pack("<f", 0.01))),
        _node("alpha_op_1/Const_2", "Const", tensor=_float32(0.001)),
        _node("Adam/beta1", "Const", tensor=_float32(0.9)),
        _node("Adam/beta2", "Const", tensor=_float32(0.999)),
        _node("Adam/epsilon", "Const", tensor=_float32(1e-8)),
        _node("gradients/Fill", "Fill"),
        _node("gradients/add_7_grad/Sum", "Sum", ["gradients/Fill", "gradients/Shape"]),
        _node("add_7", "AddV2", ["mul_3", "cd:0"]),
        _node("mul_3", "Mul", ["mul_3/x", "emd"]),
        _node("mul_3/x", "Const", tensor=_float32(0.2)),
        _node("emd", "Identity", ["emd_cost"]),
        _node("cd", "Sum", ["dists"]),
        *(_node(f"Adam/update_w{k}", "ApplyAdam", [f"w{k}"]) for k in range(3)),
        *(_node(f"w{k}", "VariableV2") for k in range(3)),
        _node("conv", "Conv2D", ["x", "w0"]),
    ]
    with open(path, "wb") as f:
        f.write(_pb_bytes_field(2, b"".join(nodes)))


def test_inspect_ref_graph_matches_jax_tool(tmp_path, capsys, monkeypatch):
    """The port's tool prints the JAX tool's output, line for line, for
    the same MetaGraphDef."""
    meta = str(tmp_path / "model.meta")
    _write_meta(meta)
    monkeypatch.setattr(sys, "argv", ["inspect_ref_graph.py", meta])
    jax_inspect.main()
    want = capsys.readouterr().out
    inspect_ref_graph_torch.main([meta])
    got = capsys.readouterr().out
    assert got == want
    assert "values [0.0005000000237487257, 0.00019999999494757503] at boundaries [50000, 100000]" \
        in got
    assert "loss root: add_7" in got and "mul_3/x [Const] = 0.2" in got


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Every tool's --tiny run (the converged-weights backend study beside
    them), each in a subprocess that cannot import JAX, ``PARALLEL`` at a
    time with two threads each: {name: (returncode, stdout, stderr)}."""
    meta = str(tmp_path_factory.mktemp("meta") / "model.meta")
    _write_meta(meta)
    runs = {name: [f"tools/{name}.py", *argv] for name, argv in TOOLS.items()}
    runs["inspect_ref_graph_torch"].append(meta)
    runs["backend_converged"] = ["tools/bench_chamfer_backend_torch.py", *CPU_TINY,
                                 "--checkpoint", "weights/rfnet_r4_105000.npz"]
    def run(argv):
        p = subprocess.run([sys.executable, "-c", BLOCKED, *argv], cwd=REPO, capture_output=True,
                           text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
        return p.returncode, p.stdout, p.stderr

    with concurrent.futures.ThreadPoolExecutor(PARALLEL) as pool:
        return dict(zip(runs, pool.map(run, runs.values())))


@pytest.mark.parametrize("name", [*TOOLS, "backend_converged"])
def test_tool_tiny_runs_without_jax(tiny_runs, name):
    """Exit 0; the card tools end in one JSON object naming the CPU, which
    they ran on with the kernels' plain versions and no card number."""
    rc, out, err = tiny_runs[name]
    assert rc == 0, err[-3000:]
    if name == "inspect_ref_graph_torch":
        assert "loss root: add_7" in out
        return
    line = json.loads(out.strip().splitlines()[-1])
    assert line["tool"] == name.removesuffix("_torch").replace("backend_converged",
                                                               "bench_chamfer_backend")
    assert "device" not in line or line["device"]["name"] == "cpu"
    assert not {"bound_ms", "bounds_ms", "library_ms"} & set(line)
    if name == "backend_converged":
        assert line["weights"].endswith("rfnet_r4_105000.npz")


@pytest.mark.parametrize("name", CARD_TOOLS)
def test_tool_refuses_without_a_card(name, capsys):
    """Without ``--device cpu`` a tool needs the card and stops where there
    is none; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        importlib.import_module(f"tools.{name}").main(["--iters", "1"])

#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one CUDA card: dense completion
throughput at 16384 output points (the counterpart of ``bench.py``).

    python3 bench_torch.py [--checkpoint weights/rfnet_r4_105000.npz]
    python3 bench_torch.py --device cpu --tiny   # tiny widths, plain versions

Prints ONE JSON line on stdout, ``{"metric", "value", "unit", "device",
"breakdown"}`` (progress goes to stderr):

* ``completion_throughput_16384pts`` in clouds/sec/chip: the full-width
  RFNet forward (3000-point partial -> 16384-point completion) on the
  converged weights (``weights/rfnet_r4_105000.npz`` through
  ``eval.load_state``; a missing checkpoint is an error), batched, steady
  state. The value is the best float32 batch of ``bench.py``'s sweep (b64
  timed over 20 calls, b128 and b256 over 10, after a checked first call,
  one more and 3 warm-ups) on ``np.random.RandomState(0)`` clouds. The sweep
  runs again with the feature MLPs in bfloat16 (``load_state(...,
  dtype=torch.bfloat16)``, the eval CLI's ``--bf16``). Each batch gives ms,
  clouds/s and the peak of allocated device memory; a batch the card cannot
  hold is reported as such (``fwd_b<N>_oom``) and leaves the headline.
* ``breakdown``: ``bench.py``'s ``_component_breakdown`` at the trainer's
  batch of 32 on its seeds and inputs (the forward; cd34 value and
  gradients on random, model and in-distribution outputs; EMD and
  re_chamfer value and gradients; the FPS pyramids; the eval EMD at
  (4, 16384); the train step on random and in-distribution batches, run on
  a copy of the model), then FLOP counts and shares: the matmul FLOPs of
  the forward and of one train step from
  ``torch.utils.flop_counter.FlopCounterMode`` (the hand-written kernels
  are invisible to it, as Pallas calls are to XLA's cost model, so
  :func:`_kernel_train_flops` adds their pair count), the forward's closed
  form (:func:`forward_layer_costs`), achieved TFLOP/s, the shares of the
  H100's peaks (every such key has ``mfu`` in its name) and a roofline line
  for each sweep.

Not carried over from ``bench.py``: ``vs_baseline`` (a share of a TPU v4-8
target), ``agg_4chip_clouds_per_sec_est`` (four times one chip, an
estimate, not a measurement) and the relay probe. A failed component exits
non-zero; nothing turns it into an entry.

``--device cpu --tiny`` runs the same code at tiny widths (innum 64, ptnum
128, n_seed 4, up_ratio 4, batch 4, random init) on the kernels' plain
versions, for the tests: its line names the device ``cpu`` and has no
share, rate, roofline or memory key. Without ``--device cpu`` a missing card
is an error. Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from rfnet_tpu_torch import losses  # noqa: E402
from rfnet_tpu_torch.data import online  # noqa: E402
from rfnet_tpu_torch.models import RFNet  # noqa: E402
from rfnet_tpu_torch.nn import Dense, StepDense  # noqa: E402
from rfnet_tpu_torch.ops.chamfer import chamfer_means_pair  # noqa: E402
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point  # noqa: E402
from rfnet_tpu_torch.train import TrainConfig, create_state, train_step  # noqa: E402
from tools._common_torch import TINY, WEIGHTS, device_info, resolve_device, timeit  # noqa: E402
from tools._common_torch import tool_model  # noqa: E402

METRIC = "completion_throughput_16384pts"
UNIT = "clouds/sec/chip"
# (batch, timed calls) of bench.py's sweep; each batch also takes a checked
# first call, timeit's first call and SWEEP_WARMUPS warm-ups
SWEEP = ((64, 20), (128, 10), (256, 10))
SWEEP_WARMUPS = 3
# bench.py's timed(): a first call, one warm-up, 5 timed calls
BREAKDOWN_ITERS = 5
BREAKDOWN_BATCH = 32
EVAL_BATCH = 4
IN_DISTRIBUTION_SEED = 7  # bench.py's PRNGKey(7) batch
TINY_SWEEP = ((4, 2), (8, 2))
TINY_BATCH = 4
# H100 SXM, NVIDIA's data sheet, dense, at 700 W: HBM bytes/s; FLOP/s in
# float32 outside the tensor cores and in bfloat16 on them
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pyramid_sizes(config: TrainConfig) -> tuple[int, int]:
    """The ground truth's FPS pyramid sizes (64, 1024 at full width)."""
    return 2 * config.n_seed, 2 * config.n_seed * config.up_ratio


def _kernel_train_flops(b: int, config: TrainConfig) -> float:
    """Closed-form FLOPs of the hand-written kernels in one train step
    (``bench.py:_pallas_train_flops``): FlopCounterMode sees none of them.

    8 flops a candidate pair of an exact NN scan (3 sub, 3 mul, 2 add), twice
    more for the backward; the early-exit scans priced at their dense pair
    set (the algorithmic work); FPS one 8-flop distance row over n points a
    pick. The approx-EMD recurrences are plain PyTorch, counted already.

      FPS pyramids  (64 + 1024) x 16384 pair rows    no gradient
      model FPS     32 x 3000                        no gradient
      merge NN x3   {64, 1024, 16384} -> 3000        forward and backward
      cd3 + cd4     4 one-sided 16384² scans          forward and backward
      re_chamfer    8 folded slices, 2 one-sided 2048² scans, both
      zgn1 + zgn2   1024 -> 64 and 16384 -> 1024     no gradient
    """
    n_in, n_out = config.innum, config.ptnum
    n1, n2 = pyramid_sizes(config)
    pairs_fwd_only = (n1 + n2) * n_out + 32 * n_in + n2 * n1 + n_out * n2
    pairs_fwd_bwd = (n1 + n2 + n_out) * n_in + 4 * n_out * n_out + 8 * 2 * (n_out // 8) ** 2
    return 8.0 * b * (pairs_fwd_only + 2 * pairs_fwd_bwd)


def forward_scan_flops(config: TrainConfig) -> float:
    """FLOPs of the forward's exact-NN scans a cloud, at their dense pair set
    (8 a pair, as ``bench.py``'s roofline): the three merge scans of
    {64, 1024, 16384} points into the partial, and the 32-pick FPS."""
    n1, n2 = pyramid_sizes(config)
    return 8.0 * ((n1 + n2 + config.ptnum) + config.n_seed) * config.innum


def forward_layer_costs(model: RFNet, innum: int) -> tuple[float, float]:
    """(matmul FLOPs, activation elements) of one cloud of ``innum`` points
    through ``model``'s forward, in closed form: 2·rows·in·out and
    rows·(in + out) over every Dense/StepDense, rows being the points the
    architecture hands the layer at each call, plus InitDecodeLayer's 3×3
    product (2·9 a seed). The elements are each layer's input read once and
    its output written once."""
    n, s, u = innum, model.n_seed, model.decode_cell.up_ratio
    p1, p2, p3 = 2 * s, 2 * s * u, 2 * s * u * u
    encode = (n, n + p1, n + p2)  # the shared cell, once a step
    rows = {
        "init_mlp": (n,), "cell.state_mlp": encode, "cell.state_end": encode,
        "cell.code_mlp": (1, 1, 1),
        "recover1.mlp": (n,), "recover2.mlp": (n + p1,), "recover3.mlp": (n + p2,),
        "recover1.out": (1,), "recover2.out": (1,), "recover3.out": (1,),
        "init_move": (s,), "part_mlp": (n + s,), "feat_trans": (1,),
        "init_cell.input_trans": (1,), "init_cell.mlp": (1,), "init_cell.points_out": (1,),
        "init_cell.state_out": (1,), "init_cell.state_mlp": (s,), "init_cell.state_outo": (s,),
        "decode_cell": (p1, p2),
        "refine_layer1": (p1,), "refine_layer2": (p2,), "refine_layer_final": (p3,),
    }
    flops, elems = 2.0 * 9 * s, 0.0
    for name, module in model.named_modules():
        if not isinstance(module, (Dense, StepDense)):
            continue
        calls = [r for k, r in rows.items() if name == k or name.startswith(k + ".")]
        if len(calls) != 1:
            raise ValueError(f"{name}: no single row count in forward_layer_costs")
        out_ch, in_ch = module.weight.shape
        flops += 2.0 * sum(calls[0]) * in_ch * out_ch
        elems += float(sum(calls[0])) * (in_ch + out_ch)
    return flops, elems


def matmul_flops(fn, *args) -> int:
    """Matrix-product FLOPs of ``fn(*args)`` (forward and any backward it
    runs), as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def breakdown_inputs(config: TrainConfig, b: int) -> dict[str, np.ndarray]:
    """``bench.py:_component_breakdown``'s clouds: ``RandomState(1)`` draws in
    its order, float32."""
    rng = np.random.RandomState(1)
    n1, n2 = pyramid_sizes(config)
    sizes = (("partial", config.innum), ("gt", config.ptnum), ("out3", config.ptnum),
             ("out4", config.ptnum), ("gt1", n1), ("gt2", n2), ("p1", n1), ("p2", n2))
    return {k: rng.rand(b, n, 3).astype(np.float32) for k, n in sizes}


def value_and_grads(f, *xs: torch.Tensor):
    """(f(*xs) detached, its gradients with respect to ``xs``)."""
    xs = [x.detach().requires_grad_() for x in xs]
    v = f(*xs)
    return v.detach(), torch.autograd.grad(v, xs)


def cd34(gt, out3, out4):
    """cd3 + cd4's four chamfer means and their gradients in the outputs."""
    return value_and_grads(lambda a, c: sum(chamfer_means_pair(gt, a, c)), out3, out4)


def emd(gt1, gt2, p1, p2):
    """The two pyramid EMD terms and their gradients in the predictions."""
    return value_and_grads(lambda a, c: losses.earth_mover(gt1, a) + losses.earth_mover(gt2, c),
                           p1, p2)


def recd(gt, out3):
    """``re_chamfer`` (8 slices) and its gradient in the output."""
    return value_and_grads(lambda a: losses.re_chamfer(gt, a, part=8), out3)


def fps_pyramids(gt, n1: int, n2: int):
    """(indices of n1, of n2, the two gathered pyramids) of ``gt``."""
    i1, i2 = farthest_point_sample(n1, gt), farthest_point_sample(n2, gt)
    return i1, i2, gather_point(gt, i1), gather_point(gt, i2)


@torch.no_grad()
def forward34(model: RFNet, x: torch.Tensor):
    out = model(x)
    return out.out3, out.out4


def step_total(state, partial, gt, n1: int, n2: int) -> torch.Tensor:
    """One train step (it updates ``state``); its total loss."""
    return train_step(state, partial, gt, n1=n1, n2=n2)[0].total


def copy_for_training(model: RFNet, config: TrainConfig, device: torch.device):
    """A train state holding a float32 copy of ``model``'s weights, so the
    timed steps leave the benchmarked model as it was."""
    state = create_state(dataclasses.replace(config, compute_dtype="float32"), device)
    state.model.load_state_dict(model.state_dict())
    return state


def component_breakdown(model: RFNet, config: TrainConfig, b: int,
                        device: torch.device) -> dict:
    """``bench.py:_component_breakdown`` on the port: ms of each component
    (timeit, ``BREAKDOWN_ITERS`` calls), then the train step's matmul FLOPs
    (FlopCounterMode over one step) and kernel FLOPs (closed form). The
    key names are ``bench.py``'s, whose full-width shapes they name."""
    t = {k: torch.from_numpy(v).to(device) for k, v in breakdown_inputs(config, b).items()}
    n1, n2 = pyramid_sizes(config)
    res = {}

    def timed(key, fn, *args):
        res[key] = timeit("", fn, *args, iters=BREAKDOWN_ITERS, warmups=1, device=device)
        _log(f"{key}: {res[key]:.3f} ms")

    with torch.inference_mode():
        timed("fwd_b32_ms", lambda x: model(x).out4, t["partial"])
    timed("cd34_fb_b32_ms", cd34, t["gt"], t["out3"], t["out4"])
    # the early-exit scans' cost depends on the data: the model's own outputs
    o3, o4 = forward34(model, t["partial"])
    timed("cd34_fb_real_b32_ms", cd34, t["gt"], o3, o4)
    timed("emd_fb_b32_ms", emd, t["gt1"], t["gt2"], t["p1"], t["p2"])
    timed("recd_fb_b32_ms", recd, t["gt"], t["out3"])
    timed("fps_pyramids_b32_ms", fps_pyramids, t["gt"], n1, n2)
    with torch.no_grad():
        timed("eval_emd_16k_b4_ms", losses.earth_mover_eval, t["gt"][:EVAL_BATCH],
              t["out4"][:EVAL_BATCH])
    state = copy_for_training(model, config, device)
    timed("train_step_b32_ms", step_total, state, t["partial"], t["gt"], n1, n2)
    # in distribution: a synthetic batch, which a trained model completes
    # closely (tight early-exit bounds); the random clouds above are the
    # stress regime
    partial_d, gt_d = online.synthetic_batch(IN_DISTRIBUTION_SEED, 0, b, config.innum,
                                             config.ptnum, device)
    o3d, o4d = forward34(model, partial_d)
    timed("cd34_fb_indist_b32_ms", cd34, gt_d, o3d, o4d)
    timed("train_step_indist_b32_ms", step_total, state, partial_d, gt_d, n1, n2)
    res["train_matmul_flops"] = matmul_flops(step_total, state, partial_d, gt_d, n1, n2)
    res["train_kernel_flops"] = _kernel_train_flops(b, config)
    total = res["train_matmul_flops"] + res["train_kernel_flops"]
    res["train_gflops_per_cloud"] = total / b / 1e9
    if device.type == "cuda":
        tflops = total / (res["train_step_indist_b32_ms"] / 1e3) / 1e12
        res["train_achieved_tflops"] = tflops
        res["train_mfu_vs_h100_fp32_peak67"] = tflops / (PEAK_FP32 / 1e12)
    return res


def sweep(model: RFNet, config: TrainConfig, batches, device: torch.device) -> dict:
    """{batch: {"ms", "clouds_per_sec"[, "peak_gb"]}} of the forward on
    ``RandomState(0)`` clouds; a batch the card cannot hold gives {"oom"}."""
    rng = np.random.RandomState(0)
    rows = {}
    for batch, iters in batches:
        x = torch.from_numpy(rng.rand(batch, config.innum, 3).astype(np.float32)).to(device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        try:
            with torch.inference_mode():
                out = model(x).out4
                if out.shape != (batch, config.ptnum, 3) or not bool(torch.isfinite(out).all()):
                    raise RuntimeError(f"b{batch}: forward gave {tuple(out.shape)}, or a "
                                       "non-finite value")
                del out
                ms = timeit("", lambda: model(x).out4, iters=iters, warmups=SWEEP_WARMUPS,
                            device=device)
        except torch.cuda.OutOfMemoryError as e:  # a finding, reported in the line
            rows[batch] = {"oom": str(e).splitlines()[0][:200]}
            _log(f"forward b{batch} {model.dtype}: out of memory")
            continue
        finally:
            del x
        rows[batch] = {"ms": ms, "clouds_per_sec": batch / ms * 1e3}
        if device.type == "cuda":
            rows[batch]["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        _log(f"forward b{batch} {model.dtype}: {rows[batch]}")
    return rows


def roofline(mm_flops: float, scan_flops: float, act_bytes: float, mm_peak: float,
             clouds_per_sec: float, label: str) -> str:
    """The forward's least time a cloud on an H100: the FLOP bound (matmuls
    at ``mm_peak``, the scans at the float32 peak) against the bytes bound
    (the point-wise activations read and written once at HBM rate), the
    larger bounding; with the measured rate's share of that ceiling."""
    t_ops = (mm_flops / mm_peak + scan_flops / PEAK_FP32) * 1e3
    t_bytes = act_bytes / PEAK_BYTES * 1e3
    bound_ms, by = (t_ops, "FLOPs") if t_ops >= t_bytes else (t_bytes, "bytes")
    ceiling = 1e3 / bound_ms
    return (f"{label} forward = {mm_flops / 1e9:.2f} GFLOP/cloud of matmul at "
            f"{mm_peak / 1e12:.0f} TFLOP/s + {scan_flops / 1e9:.2f} GFLOP/cloud of exact-NN "
            f"scan at {PEAK_FP32 / 1e12:.0f} TFLOP/s = {t_ops:.4f} ms/cloud; "
            f"{act_bytes / 1e9:.3f} GB/cloud of activations at {PEAK_BYTES / 1e12:.2f} TB/s "
            f"= {t_bytes:.4f} ms/cloud; bound by {by}: {ceiling:.0f} clouds/s; measured "
            f"{clouds_per_sec:.1f} = {100 * clouds_per_sec / ceiling:.1f} % of it")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--checkpoint", default=WEIGHTS,
                   help="the weights (any form eval.load_state takes)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="tiny widths and random init (the tests)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    checkpoint = None if args.tiny else args.checkpoint
    config = TrainConfig(**TINY) if args.tiny else TrainConfig()
    batches, b = (TINY_SWEEP, TINY_BATCH) if args.tiny else (SWEEP, BREAKDOWN_BATCH)
    cuda = device.type == "cuda"
    info = device_info(device)
    _log(f"device: {info['smi'] or info['name']}; weights: "
         f"{'random init (--tiny)' if args.tiny else args.checkpoint}")

    model = tool_model(config, device, checkpoint)
    fp32 = sweep(model, config, batches, device)
    bf16 = sweep(tool_model(config, device, checkpoint, torch.bfloat16), config, batches, device)
    ran = {k: r for k, r in fp32.items() if "ms" in r}
    if not ran:
        raise SystemExit("no batch of the float32 sweep ran")
    best = max(ran, key=lambda k: ran[k]["clouds_per_sec"])
    clouds_per_sec = ran[best]["clouds_per_sec"]

    res = component_breakdown(model, config, b, device)
    for tag, rows in (("", fp32), ("bf16_", bf16)):
        for batch, row in rows.items():
            for key, value in row.items():
                res[f"fwd_{tag}b{batch}_{key}"] = value
    res["headline_batch"] = best
    x1 = torch.from_numpy(breakdown_inputs(config, 1)["partial"]).to(device)
    with torch.no_grad():
        counted = matmul_flops(model, x1)
    mm, elems = forward_layer_costs(model, config.innum)
    if counted != mm:
        raise SystemExit(f"FlopCounterMode counted {counted} matmul FLOPs in a cloud's "
                         f"forward, the closed form {mm}")
    scan = forward_scan_flops(config)
    res["fwd_gflops_per_cloud"] = mm / 1e9
    res["fwd_scan_gflops_per_cloud"] = scan / 1e9
    res["fwd_activation_gb_per_cloud"] = elems * 4 / 1e9
    if cuda:
        res["achieved_tflops"] = (mm + scan) * clouds_per_sec / 1e12
        res["mfu_vs_h100_fp32_peak67"] = res["achieved_tflops"] / (PEAK_FP32 / 1e12)
        res["roofline"] = roofline(mm, scan, elems * 4, PEAK_FP32, clouds_per_sec, "float32")
        bf16_ran = {k: r for k, r in bf16.items() if "ms" in r}
        if bf16_ran:
            bf16_best = max(bf16_ran, key=lambda k: bf16_ran[k]["clouds_per_sec"])
            bf16_cps = bf16_ran[bf16_best]["clouds_per_sec"]
            res["bf16_headline_batch"] = bf16_best
            res["bf16_achieved_tflops"] = (mm + scan) * bf16_cps / 1e12
            res["mfu_vs_h100_bf16_peak989"] = res["bf16_achieved_tflops"] / (PEAK_BF16 / 1e12)
            res["roofline_bf16"] = roofline(mm, scan, elems * 2, PEAK_BF16, bf16_cps,
                                            "bfloat16")
    line = {"metric": METRIC, "value": clouds_per_sec, "unit": UNIT,
            "device": {k: info[k] for k in ("name", "power_limit_w", "count")},
            "breakdown": res}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rfnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the CUDA kernels from
   rfnet_tpu_torch/csrc (nvcc, one process per source, all at once);
2. holds each kernel against its plain PyTorch version and times kernel,
   plain version and a one-call PyTorch yardstick with CUDA events: K1 FPS,
   K2 NN + coords and K3 early-exit NN at the serving path's shapes
   (batch 4); K1, K2, K3, K4 dense NN, K5 chamfer-backward scatter and K6
   approx-EMD cost at the trainer's shapes (batch 32, eval batch 4); K7
   box-pruned NN and K8 best-first box-tile NN, bit for bit, at the losses'
   and the metrics' shapes on completion-like and on random-init outputs,
   each beside K3, and K5 with K8's Morton-order indices; K5 also with
   every query on one target, with a random-init model's argmins and with
   ragged n != m, beside a stable sort of its indices alone; K6 also on
   random-init outputs and on a ragged pair, bit-equal with its skip rule
   off, with the share of tile pairs it skips at each level and its time
   with each switchable design step off;
3. serves 16 synthetic clouds in the PCN layout through
   ``rfnet_tpu_torch.eval.main`` on the card with a random-init full-width
   RFNet, checks the CSV, and checks the kernels that run launched; then
   serves the first 4 clouds again on the CPU with the plain versions and
   holds the card's CSV to it;
4. trains the full-width RFNet at batch 32 on synthetic clouds through
   ``rfnet_tpu_torch.train.train``: 4 Adam steps with two evals and two
   checkpoints, then a resume that takes one more step; checks the losses,
   the files, the resume and the launch counts of every kernel; times the
   train step and the eval;
5. runs one full-width train step at batch 2 on the card and on the CPU
   from the same weights and batch and holds the two to each other;
6. times the full-width forward at batch 32;
7. drives the public op API (``rfnet_tpu_torch.ops``) on the card: the
   pruned and the tile scan on unsorted clouds against the early-exit one,
   grouping, interpolation, the auction assignment and ``emd_func`` against
   their CPU run;
8. flips the losses' sorted-space backend to "tile" (Morton sort + K8) and
   holds one full-width train step at batch 32 and one eval batch of 4 (CD
   and fidelity) to the "dyn" backend from the same weights and batch, with
   exact launch counts, timing both;
9. prints the per-kernel JSON line, then ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no result.
It needs the rest of the repository: alone, or without a card, it fails.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "chip_smoke_work")  # listed in .gitignore, removed at exit
B = 4  # serving batch
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str) -> float | None:
    """Device time a call of ``fn`` spends in the kernels whose name contains
    ``kernel``, from ``torch.profiler``: what the card takes, however long the
    host needs to launch. None where the profiler recorded no device event
    in two tries (its tracing may be unavailable on a machine): the number
    is a side reading, and no check rests on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / 1e3 / iters
    seen = sorted({e.key for e in prof.key_averages()})
    print(f"device_ms: the profiler recorded no device time for kernels named *{kernel}* in "
          f"two tries (events it saw: {seen[:8]}); that time is not measured in this run")
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_k3(name: str, qs, ts, library: bool = True) -> dict:
    """K3 on z-sorted clouds against the full plain scan; returns its row.
    The yardstick ``cdist(q, t).min(-1)`` is skipped where its (b, n, m)
    matrix would not fit in the card's memory."""
    import torch

    from rfnet_tpu_torch.ops import chamfer

    kd, ki = chamfer.nn_dyn(qs, ts)
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    torch.cuda.synchronize()
    err = float((kd - pd).abs().max())
    agree = float((ki == pi).float().mean())
    check(err <= 1e-6, f"K3 {name}: distances differ from the full plain scan by {err}")
    check(agree >= 0.999, f"K3 {name}: indices agree on only {agree:.6f}")
    b, nq, m = qs.shape[0], qs.shape[1], ts.shape[1]
    # pairs any exact z-slab walk must visit: targets with (qz-tz)^2 <= best
    tz = ts[..., 2].contiguous()
    r = torch.sqrt(kd)
    lo = torch.searchsorted(tz, (qs[..., 2] - r).contiguous(), right=False)
    hi = torch.searchsorted(tz, (qs[..., 2] + r).contiguous(), right=True)
    pairs = float((hi - lo).sum())
    ms = cuda_ms(lambda: chamfer.nn_dyn(qs, ts), 20)
    plain_ms = cuda_ms(lambda: chamfer._nn_sorted_plain(qs, ts), 3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.cdist(qs, ts).min(-1), 5) if library else None
    b_ms, b_by = bound(9.0 * pairs, 4.0 * b * (3 * nq + 3 * m + 2 * nq))
    lib = f"{lib_ms:.4f} ms" if library else "not run (matrix too large)"
    print(f"K3 nn_dyn {name} ({b},{nq},3)x({b},{m},3): max|dd| vs full plain scan {err:.3g}, "
          f"index agreement {agree:.6f}; slab pairs {pairs:.0f} "
          f"({pairs / (b * nq * m):.4%} of dense); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, cdist.min {lib}, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def record(rows: dict, name: str, shape: str, row: dict, main: bool = False) -> None:
    """Keep ``row`` under ``rows[name]["shapes"]``; the kernel's own numbers
    in the JSON line are those of its ``main`` shape."""
    entry = rows.setdefault(name, {"shapes": []})
    entry["shapes"].append({"shape": shape, **row})
    if main:
        entry.update(row)


def check_k1(x, npoint: int, iters: int) -> dict:
    """K1 against the plain loop: identical indices required."""
    import torch

    from rfnet_tpu_torch.ops import fps

    b, n = x.shape[0], x.shape[1]
    k_idx = fps.farthest_point_sample(npoint, x)
    p_idx = fps._fps_plain(x, npoint)
    torch.cuda.synchronize()
    check(torch.equal(k_idx, p_idx), f"K1 FPS ({b},{n},3)->{npoint}: indices differ from the "
          f"plain version at {int((k_idx != p_idx).sum())} of {k_idx.numel()} picks")
    ms = cuda_ms(lambda: fps.farthest_point_sample(npoint, x), iters)
    plain_ms = cuda_ms(lambda: fps._fps_plain(x, npoint), 3, warmup=1)
    b_ms, b_by = bound(8.0 * b * n * npoint, 4.0 * b * (3 * n + npoint))
    print(f"K1 fps ({b},{n},3)->{npoint}: indices identical; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_k2(q, t) -> dict:
    """K2 against the plain dense scan: distances, and coordinates wherever
    the indices agree; a differing index must be an exact tie."""
    import torch

    from rfnet_tpu_torch.ops import chamfer

    b, nq, m = q.shape[0], q.shape[1], t.shape[1]
    kd, ki, kc = chamfer.nn_coords(q, t)
    pd, pi = chamfer._one_sided(q, t)
    pc = chamfer._gather_rows(t, pi)
    torch.cuda.synchronize()
    err = float((kd - pd).abs().max())
    same = ki == pi
    # both run one op chain, so 0 is expected; 1e-6 absolute leaves room
    # only for a rounding difference, at distances of order 1e-4..1e-1
    check(err <= 1e-6, f"K2 ({b},{nq})->{m}: distances differ by {err}")
    check(bool(torch.equal(kc[same], pc[same])), f"K2 ({b},{nq})->{m}: coordinates differ")
    # where the indices differ the two picks must be equally near
    tie_gap = ((kc - q).square().sum(-1) - (pc - q).square().sum(-1))[~same]
    check(tie_gap.numel() == 0 or float(tie_gap.abs().max()) <= 1e-6,
          f"K2 ({b},{nq})->{m}: a differing pick is not a tie")
    agree = float(same.float().mean())
    check(agree >= 0.999, f"K2 ({b},{nq})->{m}: indices agree on only {agree:.6f}")
    ms = cuda_ms(lambda: chamfer.nn_coords(q, t), 20)
    plain_ms = cuda_ms(lambda: chamfer._one_sided(q, t), 3)
    lib_ms = cuda_ms(lambda: torch.cdist(q, t).min(-1), 10)
    b_ms, b_by = bound(9.0 * b * nq * m, 4.0 * b * (3 * nq + 3 * m + 5 * nq))
    print(f"K2 nn_coords ({b},{nq},3)x({b},{m},3): max|dd| {err:.3g}, index agreement "
          f"{agree:.6f}, coords equal where indices agree; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, cdist.min {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_kernels(dev):
    """Phase 2: every kernel against its plain version at the serving shapes."""
    import numpy as np
    import torch

    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.ops import chamfer

    pairs = list(synthetic_pairs(B, seed=7))
    partial = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)  # (4, 3000, 3)
    gt = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)  # (4, 16384, 3)
    gen = torch.Generator(device=dev).manual_seed(7)
    # a completion-like cloud: the gt jittered by 0.005
    out = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    rows = {}

    # K1: 32 seeds of the 3000-point input, as the model's forward samples
    record(rows, "fps", f"({B},3000,3)->32", check_k1(partial, 32, 50), main=True)
    # K2: the three merge scans, 64 / 1024 / 16384 queries into the input
    for nq in (64, 1024, 16384):
        record(rows, "nn_coords", f"({B},{nq},3)x({B},3000,3)",
               check_k2(out[:, :nq].contiguous(), partial), main=nq == 16384)

    # K3: the eval metrics' three sorted scans
    gts, _ = chamfer.sort_by_z_with_order(gt)
    outs, _ = chamfer.sort_by_z_with_order(out)
    parts, _ = chamfer.sort_by_z_with_order(partial)
    for name, qs, ts in (("out->gt", outs, gts), ("gt->out", gts, outs),
                         ("partial->out", parts, outs)):
        record(rows, "nn_dyn", f"{name} {tuple(qs.shape)}x{tuple(ts.shape)}",
               check_k3(name, qs, ts), main=name == "out->gt")
    return rows


def train_batch(b: int, seed: int):
    """(partial (b, 3000, 3), gt (b, 16384, 3)) synthetic clouds on the CPU."""
    import numpy as np
    import torch

    from rfnet_tpu_torch.data.dataset import synthetic_pairs

    pairs = list(synthetic_pairs(b, seed=seed))
    return (torch.from_numpy(np.stack([p for _, p, _ in pairs])),
            torch.from_numpy(np.stack([g for _, _, g in pairs])))


def check_k5(name: str, x1, g, idx, m: int | None = None) -> dict:
    """K5 against its CPU plain version (``index_add_`` in query order), bit
    for bit, for one (x1, g, idx) of a chamfer backward into ``m`` targets
    (the number of queries where not given); returns its row. ``ms`` is the
    wrapper's call (scratch allocation and launch included, which the host
    bounds where the kernel is short), ``device_ms`` the kernel on the card.
    Beside them it times the stable sort of ``idx`` alone, the grouping step
    a sort-based design pays before it sums."""
    import torch

    from rfnet_tpu_torch.ops.nn_grad import _scatter_plain, nn_grad_scatter

    dev = x1.device
    b, nq = idx.shape
    m = nq if m is None else m
    ksp, ksw = nn_grad_scatter(x1, g, idx, m)
    psp, psw = _scatter_plain(x1.cpu(), g.cpu(), idx.cpu(), m)  # index_add_ in order
    torch.cuda.synchronize()
    err = max(float((ksp.cpu() - psp).abs().max()), float((ksw.cpu() - psw).abs().max()))
    check(torch.equal(ksp.cpu(), psp) and torch.equal(ksw.cpu(), psw),
          f"K5 {name}: sums differ from the CPU plain version by {err}")
    src = torch.cat([g[..., None] * x1, g[..., None]], -1).reshape(-1, 4)
    flat = (idx.long() + m * torch.arange(b, device=dev)[:, None]).reshape(-1)
    ms = cuda_ms(lambda: nn_grad_scatter(x1, g, idx, m), 20)
    dev_ms = device_ms(lambda: nn_grad_scatter(x1, g, idx, m), 20, "nn_grad_kernel")
    plain_ms = cuda_ms(lambda: _scatter_plain(x1, g, idx, m), 20)
    lib_ms = cuda_ms(lambda: torch.zeros(b * m, 4, device=dev).index_add_(0, flat, src), 20)
    sort_ms = cuda_ms(lambda: torch.sort(idx, dim=1, stable=True), 20)
    b_ms, b_by = bound(8.0 * b * nq, 20.0 * b * nq + 16.0 * b * m)
    print(f"K5 nn_grad {name} ({b},{nq})->{m}: equal to the CPU plain version bit for bit; "
          f"kernel {ms:.4f} ms ({fmt_ms(dev_ms)} on the card alone), plain {plain_ms:.4f} ms, "
          f"index_add_ {lib_ms:.4f} ms, a stable "
          f"torch.sort of the indices alone {sort_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, index_sort_ms=sort_ms, device_ms=dev_ms)


def check_k6(name: str, x1, x2) -> dict:
    """K6 against its plain recurrence (rtol 2e-4: the same recurrence with
    its fp32 sums in another order and its weights a few ulps apart), against
    itself (two runs bit-equal) and against itself with the band skip off
    (bit-equal: a skipped pair's weight is exactly 0); returns its row, with
    the share of tile pairs skipped at each level and the time with the skip
    off."""
    import torch

    from rfnet_tpu_torch.ops import emd

    kc = emd.approx_match_cost(x1, x2)
    again = emd.approx_match_cost(x1, x2)
    unskipped = emd._approx_match_cost_kernel(x1, x2, band_skip=False)
    pc = emd._approx_match_cost_plain(x1, x2)
    torch.cuda.synchronize()
    rel = float(((kc - pc).abs() / pc.abs()).max())
    check(bool(torch.isfinite(kc).all()) and rel <= 2e-4, f"K6 {name}: cost {kc} vs plain {pc}")
    check(torch.equal(kc, again), f"K6 {name}: two runs differ: {kc} vs {again}")
    check(torch.equal(kc, unskipped),
          f"K6 {name}: skipping changed the result: {kc} vs {unskipped} with every pair visited")
    shares = emd._skipped_shares(emd._sorted_with_boxes(x1)[0], emd._sorted_with_boxes(x2)[0])
    print(f"K6 emd_cost {name}: share of (64-point, 128-point) tile pairs skipped at levels "
          f"{[int(v) if v == int(v) else v for v in emd._levels()]}: "
          f"{[round(v, 4) for v in shares]}")
    ms = cuda_ms(lambda: emd.approx_match_cost(x1, x2), 5, warmup=1)
    no_skip_ms = cuda_ms(lambda: emd._approx_match_cost_kernel(x1, x2, band_skip=False), 3,
                         warmup=1)
    prep_ms = cuda_ms(lambda: emd._morton_sorted_pair(x1, x2), 5)
    dev_ms = device_ms(lambda: emd.approx_match_cost(x1, x2), 3, "emd_")
    plain_ms = cuda_ms(lambda: emd._approx_match_cost_plain(x1, x2), 1, warmup=0)
    # per pair: d2 and its root once (9 ops), then per level exp, the row and
    # column sums, delta, its cost and its row sum (10 ops) over 10 levels;
    # a pair at a level where its tile pair is skipped needs none of the 10
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    ops = 9.0 + 10.0 * sum(1.0 - v for v in shares)
    b_ms, b_by = bound(ops * b * n * m, 4.0 * (3 * b * (n + m) + b))
    full_ms, _ = bound(109.0 * b * n * m, 0.0)
    print(f"K6 emd_cost {name} ({b},{n},3)x({b},{m},3): max rel diff vs plain {rel:.3g} (rtol "
          f"2e-4), two runs bit-equal, "
          f"bit-equal with the skip off; kernel with its Morton sorts {ms:.4f} ms (the sorts "
          f"alone {prep_ms:.4f}, its device kernels alone {fmt_ms(dev_ms)}), skip off "
          f"{no_skip_ms:.4f}, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}; {ops:.1f} ops a pair after skipping, {full_ms:.6f} ms "
          f"at 109 with nothing skipped)")
    return dict(max_abs_err=float((kc - pc).abs().max()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, skipped_share_by_level=shares,
                no_skip_ms=no_skip_ms, prep_ms=prep_ms, device_ms=dev_ms,
                bound_unskipped_ms=full_ms)


def check_train_kernels(dev, rows: dict) -> None:
    """Phase 2b: K1-K6 against their plain versions at the trainer's shapes
    (batch 32; the eval's batch 4 for K6), recorded into ``rows``."""
    import torch

    from rfnet_tpu_torch.ops import chamfer, fps

    partial, gt = (x.to(dev) for x in train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    # completion-like outputs: the gt jittered by 0.005 (out3 and out4)
    out_a = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    out_b = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)

    # K1: the step's seeds of the input and its two ground-truth pyramids
    record(rows, "fps", "(32,3000,3)->32", check_k1(partial, 32, 50))
    for npoint in (64, 1024):
        record(rows, "fps", f"(32,16384,3)->{npoint}", check_k1(gt, npoint, 20))
    gt1 = fps.gather_point(gt, fps.farthest_point_sample(64, gt))
    gt2 = fps.gather_point(gt, fps.farthest_point_sample(1024, gt))
    # K2: the three merge scans of the forward, outputs into the input
    for nq in (64, 1024, 16384):
        record(rows, "nn_coords", f"(32,{nq},3)x(32,3000,3)",
               check_k2(out_a[:, :nq].contiguous(), partial))

    # K4: zero_groupnear's two scans, rawpts -> ptcens
    for q, t in ((gt2, gt1), (gt, gt2)):
        b, nq, m = q.shape[0], q.shape[1], t.shape[1]
        kd, ki = chamfer.nn_dense(q, t)
        pd, pi = chamfer._one_sided(q, t)
        torch.cuda.synchronize()
        err = float((kd - pd).abs().max())
        check(err == 0.0, f"K4 {nq}->{m}: distances differ from the plain scan by {err}")
        same = ki == pi
        # where the indices differ (an exact tie, found in another order by
        # the plain min) the two picks must be equally near
        tq = q[~same]
        tie_gap = ((chamfer._gather_rows(t, ki)[~same] - tq).square().sum(-1)
                   - (chamfer._gather_rows(t, pi)[~same] - tq).square().sum(-1))
        check(tie_gap.numel() == 0 or float(tie_gap.abs().max()) <= 1e-6,
              f"K4 {nq}->{m}: a differing pick is not a tie")
        agree = float(same.float().mean())
        ms = cuda_ms(lambda: chamfer.nn_dense(q, t), 20)
        plain_ms = cuda_ms(lambda: chamfer._one_sided(q, t), 3)
        lib_ms = cuda_ms(lambda: torch.cdist(q, t).min(-1), 10)
        b_ms, b_by = bound(9.0 * b * nq * m, 4.0 * b * (3 * nq + 3 * m + 2 * nq))
        print(f"K4 nn_dense ({b},{nq},3)x({b},{m},3): distances bit-equal, index agreement "
              f"{agree:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cdist.min "
              f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        record(rows, "nn_dense", f"({b},{nq},3)x({b},{m},3)",
               dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms), main=nq == 16384)

    # K3 at the loss's shapes: the pair (gt twice, out3 and out4 stacked)
    # both ways, and re_chamfer's slices folded into the batch both ways
    gts, _ = chamfer.sort_by_z_with_order(gt)
    outs, _ = chamfer.sort_by_z_with_order(torch.cat([out_a, out_b], 0))
    gt2x = torch.cat([gts, gts], 0)
    ps, _ = chamfer.sort_by_z_with_order(out_a.reshape(256, 2048, 3))
    gss, _ = chamfer.sort_by_z_with_order(gt.reshape(256, 2048, 3))
    for name, qs, ts in (("pair gt->out", gt2x, outs), ("pair out->gt", outs, gt2x),
                         ("re_chamfer pred->gt", ps, gss), ("re_chamfer gt->pred", gss, ps)):
        # cdist's (64, 16384, 16384) matrix of the pair would take 64 GiB
        record(rows, "nn_dyn", f"{name} {tuple(qs.shape)}x{tuple(ts.shape)}",
               check_k3(name, qs, ts, library=name.startswith("re_chamfer")))

    # K5: the two scatters a train step runs, with real argmins from K3
    d1, i1 = chamfer.nn_dyn(gt2x, outs)  # pair: gt rows routed onto outputs
    g1 = 1.0 / (64 * 16384 * 2.0 * torch.clamp(torch.sqrt(d1), min=1e-7))
    d2, i2 = chamfer.nn_dyn(gss, ps)  # re_chamfer: gt slices onto predictions
    g2 = 1.0 / (256 * 2048 * 2.0 * torch.clamp(torch.sqrt(d2), min=1e-7))
    for name, x1, g, idx in (("pair", gt2x, g1, i1), ("re_chamfer", gss, g2, i2),
                             ("pair all-to-one", gt2x, g1, torch.full_like(i1, 16383))):
        record(rows, "nn_grad", f"{name} ({idx.shape[0]},{idx.shape[1]})->{idx.shape[1]}",
               check_k5(name, x1, g, idx), main=name == "pair")
    # ragged n != m both ways: the input's 3000 points against an output's 16384
    pz, _ = chamfer.sort_by_z_with_order(partial)
    oz, _ = chamfer.sort_by_z_with_order(out_a)
    for name, q, t in (("ragged partial->out", pz, oz), ("ragged out->partial", oz, pz)):
        d3, i3 = chamfer.nn_dyn(q, t)
        g3 = 1.0 / (32 * q.shape[1] * 2.0 * torch.clamp(torch.sqrt(d3), min=1e-7))
        record(rows, "nn_grad", f"{name} (32,{q.shape[1]})->{t.shape[1]}",
               check_k5(name, q, g3, i3, m=t.shape[1]))

    # K6: the eval's approx-EMD cost, 4 clouds of 16384 points
    record(rows, "emd_cost", "completion-like (4,16384,3)x(4,16384,3)",
           check_k6("completion-like", gt[:4].contiguous(), out_a[:4].contiguous()), main=True)


# launches of each kernel in one train step and in one eval batch of 4
STEP_LAUNCHES = {"fps": 3, "nn_coords": 3, "nn_dyn": 4, "nn_dense": 2, "nn_grad": 2,
                 "emd_cost": 0, "nn_pruned": 0, "nn_tile": 0}
EVAL_LAUNCHES = {"fps": 1, "nn_coords": 3, "nn_dyn": 2, "nn_dense": 0, "nn_grad": 0,
                 "emd_cost": 1, "nn_pruned": 0, "nn_tile": 0}
# launches in one serving batch of 4: forward, CD both ways, fidelity
SERVE_LAUNCHES = {"fps": 1, "nn_coords": 3, "nn_dyn": 3, "nn_dense": 0, "nn_grad": 0,
                  "emd_cost": 0, "nn_pruned": 0, "nn_tile": 0}


def under_tile_backend(counts: dict) -> dict:
    """The launch counts ``counts`` with K8 standing where K3 stood."""
    return {**counts, "nn_tile": counts["nn_dyn"], "nn_dyn": 0}


def expected_launches(steps: int, evals: int) -> dict:
    return {k: steps * STEP_LAUNCHES[k] + evals * EVAL_LAUNCHES[k] for k in STEP_LAUNCHES}


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_run(dev):
    """Phase 4: the trainer end to end at full width, batch 32; returns the
    launch counts of its first run."""
    import dataclasses

    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.data.dataset import synthetic_dataflow

    root = os.path.join(WORK, "train")
    workdir = os.path.join(root, "model")
    config = train.TrainConfig(iters=4, batch_size=32, eval_size=4, log_every=1, ckpt_every=2,
                               workdir=workdir)

    def run(cfg):
        df, _ = synthetic_dataflow(64, cfg.batch_size, cfg.innum, cfg.ptnum)
        vdf, vn = synthetic_dataflow(4, cfg.eval_size, cfg.innum, cfg.ptnum, is_training=False,
                                     seed=1234)
        buf = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            state = train.train(cfg, df, vdf, vn, device=dev)
        torch.cuda.synchronize(dev)
        counts = dict(kernels.launches)
        print(buf.getvalue(), end="")
        return state, counts, buf.getvalue()

    torch.cuda.reset_peak_memory_stats(dev)
    state, counts, _ = run(config)
    peak = torch.cuda.max_memory_allocated(dev)
    want = expected_launches(4, 2)
    print(f"launches in the train run (4 steps, 2 evals of 1 batch): {counts} (expected {want}: "
          f"per step {STEP_LAUNCHES}, per eval batch {EVAL_LAUNCHES})")
    check(counts == want, f"train launch counts {counts}")
    check(state.step == 4, f"trained to step {state.step}")
    check(sorted(os.listdir(workdir)) == ["ckpt_2.pt", "ckpt_4.pt"], "checkpoints")
    with open(os.path.join(root, "bestrecord", "best.json")) as f:
        best = json.load(f)
    check(best["step"] in (2, 4) and math.isfinite(best["cd"]), f"best.json {best}")
    check(os.path.exists(os.path.join(root, "bestrecord", "model.pt")), "best model.pt")
    lines = read_jsonl(os.path.join(root, "logs", "metrics.jsonl"))
    losses_ = [x for x in lines if "total" in x]
    evals = [x for x in lines if "eval_cd" in x]
    check([x["step"] for x in losses_] == [0, 1, 2, 3], f"metrics steps {lines}")
    check(all(math.isfinite(v) for x in losses_ for v in x.values()), "a non-finite loss term")
    check([x["step"] for x in evals] == [2, 4]
          and all(math.isfinite(x["eval_cd"]) and math.isfinite(x["eval_emd"]) for x in evals),
          f"eval lines {evals}")

    # resume: the latest checkpoint (step 4) is restored and one step taken
    state, counts_r, text = run(dataclasses.replace(config, iters=5))
    check("restored checkpoint at step 4" in text and state.step == 5, "resume")
    check(counts_r == expected_launches(1, 0), f"resume launch counts {counts_r}")
    check(len(read_jsonl(os.path.join(root, "logs", "metrics.jsonl"))) == len(lines) + 1,
          "resume metrics line")
    print(f"train: 4 steps + 2 evals, then resumed at step 4 and took step 5; every loss term "
          f"finite; max_memory_allocated {peak} bytes")

    # time the step and the eval on a fixed batch, warm-up excluded
    partial, gt = (x.to(dev) for x in train_batch(32, seed=21))
    n1, n2 = 2 * config.n_seed, 2 * config.n_seed * config.up_ratio
    train.train_step(state, partial, gt, n1=n1, n2=n2)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    for _ in range(3):
        train.train_step(state, partial, gt, n1=n1, n2=n2)
    torch.cuda.synchronize(dev)
    step_ms = (time.time() - t0) / 3 * 1e3
    p4, g4 = partial[:4].contiguous(), gt[:4].contiguous()
    train.eval_step(state, p4, g4)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    for _ in range(3):
        train.eval_step(state, p4, g4)
    torch.cuda.synchronize(dev)
    eval_ms = (time.time() - t0) / 3 * 1e3
    print(f"train step b32: {step_ms:.3f} ms, {32 / step_ms * 1e3:.1f} clouds/s; "
          f"eval step b4: {eval_ms:.3f} ms/batch")
    return counts


def cross_check_step(dev):
    """Phase 5: one full-width train step at batch 2 on the card and on the
    CPU, from the same weights (the port's seeded init) and batch. The loss
    terms agree to 1e-3 relative; the gradients to 2e-4 relative L2 over
    all parameters and 1e-2 per parameter: the model's matmuls sum in other
    orders on the two devices, which can flip a near-tie argmin of the
    random-init output and move a small gradient (an H100 run gave 1.4e-5
    and 5.8e-4)."""
    import torch

    from rfnet_tpu_torch import train

    partial, gt = train_batch(2, seed=31)
    config = train.TrainConfig(batch_size=2)
    n1, n2 = 2 * config.n_seed, 2 * config.n_seed * config.up_ratio
    res = []
    for d in (dev, torch.device("cpu")):
        state = train.create_state(config, d)
        lb, _ = train.train_step(state, partial.to(d), gt.to(d), n1=n1, n2=n2)
        res.append(({k: float(v) for k, v in lb._asdict().items()},
                    {n: (p.grad.cpu() if p.grad is not None else None)
                     for n, p in state.model.named_parameters()}))
    (lk, gk), (lc, gc) = res
    worst_loss = 0.0
    for k in lk:
        diff = abs(lk[k] - lc[k])
        check(diff <= 1e-3 * max(abs(lk[k]), abs(lc[k])) + 1e-7, f"{k}: card {lk[k]} cpu {lc[k]}")
        worst_loss = max(worst_loss, diff / max(abs(lc[k]), 1e-30))
    num = den = 0.0
    worst = (0.0, "")
    for n in gk:
        check((gk[n] is None) == (gc[n] is None), f"{n}: gradient on one device only")
        if gk[n] is None:
            continue
        d2 = float((gk[n].double() - gc[n].double()).square().sum())
        r2 = float(gc[n].double().square().sum())
        num, den = num + d2, den + r2
        rel = math.sqrt(d2 / max(r2, 1e-60))
        check(rel <= 1e-2, f"{n}: gradient differs by {rel:.3g} relative L2")
        worst = max(worst, (rel, n))
    total = math.sqrt(num / den)
    check(total <= 2e-4, f"gradients differ by {total:.3g} relative L2")
    print(f"train step b2, card vs CPU: loss terms within {worst_loss:.3g} relative; gradients "
          f"{total:.3g} relative L2 over all parameters, worst parameter {worst[1]} "
          f"{worst[0]:.3g}")


def write_evalset(root: str, num: int) -> list[str]:
    """``num`` synthetic clouds laid out like the PCN test set (8 synsets)."""
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.data.pcd_io import save_pcd

    synsets = ("02691156", "02933112", "02958343", "03001627",
               "03636649", "04256520", "04379243", "04530566")
    ids = []
    for i, (mid, part, gt) in enumerate(synthetic_pairs(num, seed=1234)):
        mid = f"{synsets[i % len(synsets)]}/{mid.split('/')[-1]}"
        for kind, cloud in (("partial", part), ("complete", gt)):
            path = os.path.join(root, "data", kind, mid + ".pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_pcd(path, cloud)
        ids.append(mid)
    return ids


def run_eval(argv: list[str]) -> str:
    from rfnet_tpu_torch import eval as eval_mod

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_mod.main(argv)
    text = buf.getvalue()
    print(text, end="")
    return text


def read_rows(results_dir: str) -> list[list[str]]:
    with open(os.path.join(results_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["id", "cd", "emd"], f"CSV header {rows[0]}")
    return rows[1:]


def serve(dev):
    """Phase 3: the serving path end to end; returns the launch counts."""
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.models import RFNet

    ids = write_evalset(WORK, 16)
    with open(os.path.join(WORK, "test.list"), "w") as f:
        f.write("\n".join(ids))
    with open(os.path.join(WORK, "ref.list"), "w") as f:
        f.write("\n".join(ids[:4]))
    ckpt = os.path.join(WORK, "model.pt")
    torch.save(RFNet(generator=torch.Generator().manual_seed(0)).state_dict(), ckpt)
    common = ["--data_dir", os.path.join(WORK, "data"), "--checkpoint", ckpt,
              "--num_gt_points", "16384", "--plot_freq", "8", "--batch_size", str(B)]

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    text = run_eval(["--list_path", os.path.join(WORK, "test.list"),
                     "--results_dir", os.path.join(WORK, "gpu"), "--device", "cuda", *common])
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    n_batches = 16 // B
    print(f"launches in the serving run: {counts} (expected fps {n_batches}, "
          f"nn_coords {3 * n_batches}, nn_dyn {3 * n_batches})")
    check(counts == {k: n_batches * v for k, v in SERVE_LAUNCHES.items()},
          f"launch counts {counts}")
    avg = re.search(r"Average time: ([0-9.eE+-]+)", text)
    check(avg is not None, "no 'Average time' line")
    print(f"serving: Average time {float(avg.group(1)):.6f} s/cloud (batch {B}, models 12-15), "
          f"max_memory_allocated {peak} bytes")

    gpu_rows = read_rows(os.path.join(WORK, "gpu"))
    check([r[0] for r in gpu_rows] == ids, "CSV ids differ from the list")
    vals = [float(v) for r in gpu_rows for v in r[1:]]
    check(all(math.isfinite(v) and v > 0 for v in vals), "non-finite or non-positive metric")

    # the same weights and clouds on the CPU, through the plain versions;
    # CPU and card sum the MLP matmuls in other orders (float32 throughout)
    # and a near-tie merge can pick another neighbour, so the per-cloud
    # metrics agree to 1e-3 relative, not bit for bit
    run_eval(["--list_path", os.path.join(WORK, "ref.list"),
              "--results_dir", os.path.join(WORK, "cpu"), "--device", "cpu", *common])
    for g, c in zip(gpu_rows[:4], read_rows(os.path.join(WORK, "cpu"))):
        for gv, cv in zip(g[1:], c[1:]):
            rel = abs(float(gv) - float(cv)) / abs(float(cv))
            check(rel <= 1e-3, f"{g[0]}: card {gv} vs cpu {cv} (rel {rel:.3g})")
    print("serving: 16 finite CSV rows; first 4 match the CPU reference within 1e-3 relative")
    return counts


def forward_throughput(dev):
    """Phase 4: full-width forward at batch 32, timed to synchronize()."""
    import numpy as np
    import torch

    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.models import RFNet

    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    parts = np.stack([p for _, p, _ in synthetic_pairs(32, seed=3)])
    x = torch.from_numpy(parts).to(dev)
    with torch.inference_mode():
        for _ in range(2):
            out = model(x).out4
        torch.cuda.synchronize(dev)
        iters = 5
        t0 = time.time()
        for _ in range(iters):
            out = model(x).out4
        torch.cuda.synchronize(dev)
        dt = (time.time() - t0) / iters
    check(bool(torch.isfinite(out).all()) and out.shape == (32, 16384, 3), "b32 forward output")
    print(f"forward b32: {dt * 1e3:.3f} ms/batch, {32 / dt:.1f} clouds/s")


def check_tiled(kernel: str, name: str, q, t, library: bool = True) -> dict:
    """K7 or K8 on the clouds ``q`` -> ``t`` (sorted here as the kernel wants
    them) against the full plain scan, bit for bit on distances and indices,
    K7 also against K3; timed beside K3 on the same clouds z-sorted. The
    bound counts the pairs the kernel's own rule cannot skip: for each query,
    the points of every tile whose box is no farther than its final best."""
    import torch

    from rfnet_tpu_torch.ops import chamfer, chamfer_pruned, chamfer_tile

    label, sort_fn, fn, tile_n, tile_m = {
        "nn_pruned": ("K7", chamfer.sort_by_z_with_order, chamfer_pruned.nn_pruned,
                      chamfer_pruned._TILE_N, chamfer_pruned._TILE_M),
        "nn_tile": ("K8", chamfer_tile.sort_by_morton_with_order, chamfer_tile.nn_tile,
                    chamfer_tile._TILE_N, chamfer_tile._TILE_M),
    }[kernel]
    qs, ts = sort_fn(q)[0], sort_fn(t)[0]
    kd, ki = fn(qs, ts)
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    torch.cuda.synchronize()
    err = float((kd - pd).abs().max())
    check(torch.equal(kd, pd), f"{label} {name}: distances differ from the plain scan by {err}")
    check(torch.equal(ki, pi), f"{label} {name}: indices differ from the plain scan at "
          f"{int((ki != pi).sum())} of {ki.numel()} queries")
    qz, tz = chamfer.sort_by_z_with_order(q)[0], chamfer.sort_by_z_with_order(t)[0]
    if kernel == "nn_pruned":
        dd, di = chamfer.nn_dyn(qs, ts)
        check(torch.equal(kd, dd) and torch.equal(ki, di), f"K7 {name}: differs from K3")
    b, nq, m = qs.shape[0], qs.shape[1], ts.shape[1]
    tile_m = min(tile_m, m)
    mt = -(-m // tile_m)
    # tiles each block loaded, from the kernel's own count
    _, _, visited = chamfer._nn_tiled(kernel, qs, ts, tile_n, tile_m)
    loaded = float(visited.float().mean()) / mt
    # pairs the rule cannot skip: point-to-box gap against the final best
    boxes = chamfer._tile_boxes(ts, tile_m)
    gap2 = torch.zeros((b, nq, mt), device=qs.device)
    for a in range(3):
        qa = qs[:, :, None, a]
        g = torch.clamp(torch.maximum(boxes[:, None, :, a] - qa, qa - boxes[:, None, :, 3 + a]),
                        min=0.0)
        gap2 += g * g
    sizes = torch.full((mt,), float(tile_m), device=qs.device)
    sizes[-1] = m - (mt - 1) * tile_m
    pairs = float(((gap2 <= kd[..., None]) * sizes).sum())
    del gap2
    ms = cuda_ms(lambda: fn(qs, ts), 20)
    k3_ms = cuda_ms(lambda: chamfer.nn_dyn(qz, tz), 10)
    plain_ms = cuda_ms(lambda: chamfer._nn_sorted_plain(qs, ts), 2, warmup=1)
    lib_ms = cuda_ms(lambda: torch.cdist(qs, ts).min(-1), 5) if library else None
    b_ms, b_by = bound(9.0 * pairs, 4.0 * b * (3 * nq + 3 * m + 6 * mt + 2 * nq))
    lib = f"{lib_ms:.4f} ms" if library else "not run (matrix too large)"
    print(f"{label} {kernel} {name} ({b},{nq},3)x({b},{m},3), tiles {tile_n}x{tile_m}: distances "
          f"and indices bit-equal to the plain scan; tiles loaded {loaded:.4%}, pairs the rule "
          f"cannot skip {pairs / (b * nq * m):.4%} of dense; kernel (with its boxes) {ms:.4f} ms, "
          f"K3 on the same clouds {k3_ms:.4f} ms, plain {plain_ms:.4f} ms, cdist.min {lib}, "
          f"bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, k3_ms=k3_ms, tiles_loaded=loaded,
                needed_pairs_share=pairs / (b * nq * m))


def check_tiled_kernels(dev, rows: dict) -> None:
    """Phase 2c: K7 and K8 against the plain scan at the metrics' and the
    losses' shapes, on completion-like clouds (the gt jittered by 0.005) and
    on a random-init model's outputs, which lie far from the gt; and K5 with
    K8's Morton-order indices."""
    import torch

    from rfnet_tpu_torch.models import RFNet
    from rfnet_tpu_torch.ops import chamfer, chamfer_tile

    partial, gt = (x.to(dev) for x in train_batch(32, seed=11))
    gen = torch.Generator(device=dev).manual_seed(11)
    out_a = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    out_b = gt + 0.005 * torch.randn(gt.shape, generator=gen, device=dev)
    model = RFNet(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.inference_mode():
        res = model(partial)
    rnd_a, rnd_b = res.out3.clone(), res.out4.clone()
    gt2, pair_like = torch.cat([gt, gt], 0), torch.cat([out_a, out_b], 0)
    pair_rnd = torch.cat([rnd_a, rnd_b], 0)
    cases = [
        ("completion-like out->gt", out_a[:4], gt[:4], True),
        ("random-init out->gt", rnd_b[:4], gt[:4], True),
        ("random-init gt->out", gt[:4], rnd_b[:4], True),
        # cdist's (64, 16384, 16384) matrix of the pair would take 64 GiB
        ("completion-like pair gt->out", gt2, pair_like, False),
        ("completion-like pair out->gt", pair_like, gt2, False),
        ("random-init pair gt->out", gt2, pair_rnd, False),
        ("random-init pair out->gt", pair_rnd, gt2, False),
        ("completion-like re_chamfer pred->gt", out_a.reshape(256, 2048, 3),
         gt.reshape(256, 2048, 3), True),
        ("random-init re_chamfer pred->gt", rnd_a.reshape(256, 2048, 3),
         gt.reshape(256, 2048, 3), True),
        ("ragged partial->out", partial[:3], out_a[:3], True),
        ("op API gt->partial", gt[:4], partial[:4], True),
    ]
    # the shape whose numbers stand for the kernel in the JSON line: the one
    # its main path gives it (K7 the op API, K8 the tile backend's eval batch)
    main = {"nn_pruned": "op API gt->partial", "nn_tile": "random-init out->gt"}
    for kernel in ("nn_pruned", "nn_tile"):
        for name, q, t, library in cases:
            record(rows, kernel, name, check_tiled(kernel, name, q.contiguous(), t.contiguous(),
                                                   library),
                   main=name == main[kernel])

    # K5 with K8's argmins: Morton order, no longer near-monotone in the query
    for name, outs in (("pair, Morton order, completion-like", pair_like),
                       ("pair, Morton order, random-init", pair_rnd)):
        gts, _ = chamfer_tile.sort_by_morton_with_order(gt2)
        os_, _ = chamfer_tile.sort_by_morton_with_order(outs)
        d1, i1 = chamfer_tile.nn_tile(gts, os_)
        g1 = 1.0 / (64 * 16384 * 2.0 * torch.clamp(torch.sqrt(d1), min=1e-7))
        record(rows, "nn_grad", f"{name} (64,16384)->16384", check_k5(name, gts, g1, i1))
    gzs, _ = chamfer.sort_by_z_with_order(gt2)
    ozs, _ = chamfer.sort_by_z_with_order(pair_rnd)
    d1, i1 = chamfer.nn_dyn(gzs, ozs)
    g1 = 1.0 / (64 * 16384 * 2.0 * torch.clamp(torch.sqrt(d1), min=1e-7))
    record(rows, "nn_grad", "pair, z order, random-init (64,16384)->16384",
           check_k5("pair, z order, random-init", gzs, g1, i1))

    # K6 on a random-init model's outputs, and on a ragged pair
    record(rows, "emd_cost", "random-init (4,16384,3)x(4,16384,3)",
           check_k6("random-init", gt[:4].contiguous(), rnd_b[:4].contiguous()))
    record(rows, "emd_cost", "ragged (4,3000,3)x(4,16384,3)",
           check_k6("ragged", partial[:4].contiguous(), out_a[:4].contiguous()))


def op_api(dev) -> dict:
    """Phase 7: the public op API on the card; returns its launch counts.
    The plain-PyTorch ops round after every elementwise op on both devices,
    so the card's results are held to the CPU's exactly where they are
    indices, and to 1e-6 where a sum's order may differ."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import kernels, losses, ops

    cpu = torch.device("cpu")
    partial, gt = train_batch(4, seed=41)
    q, t = gt.to(dev), partial.to(dev)  # (4,16384,3) queries into (4,3000,3)
    kernels.reset_launch_counts()
    dp, ip = ops.nearest_neighbor_pruned(q, t)
    dt, it = ops.nearest_neighbor_tile(q, t)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    check(counts["nn_pruned"] == 1 and counts["nn_tile"] == 1, f"op API launch counts {counts}")
    from rfnet_tpu_torch.ops.chamfer import _gather_rows, nearest_neighbor_dyn

    dd, _ = nearest_neighbor_dyn(q, t)
    for name, d, i in (("pruned", dp, ip), ("tile", dt, it)):
        check(torch.equal(d, dd), f"ops.nearest_neighbor_{name}: distances differ from "
              f"nearest_neighbor_dyn by {float((d - dd).abs().max())}")
        picked = (q - _gather_rows(t, i)).square().sum(-1)
        check(bool(torch.allclose(picked, dd, rtol=1e-5, atol=1e-9)),
              f"ops.nearest_neighbor_{name}: an index does not pick a nearest target")
    print("op API: nearest_neighbor_pruned and nearest_neighbor_tile (4,16384,3)x(4,3000,3) "
          "unsorted: distances bit-equal to nearest_neighbor_dyn, every index a nearest target")

    # grouping and interpolation: 256 FPS centroids of the 3000-point cloud
    _, cen = ops.sampling(256, t, "f")
    ridx, rpts = ops.sampling(256, t, "r", generator=torch.Generator(device=dev).manual_seed(3))
    check(bool((ridx == ridx[:1]).all()) and len(set(ridx[0].tolist())) == 256
          and torch.equal(rpts, ops.gather_point(t, ridx)), "sampling('r') contract")
    tc, cc = t.cpu(), cen.cpu()
    for got, want, what in zip(ops.query_ball_point(0.1, 32, t, cen),
                               ops.query_ball_point(0.1, 32, tc, cc), ("idx", "pts_cnt")):
        check(torch.equal(got.cpu(), want), f"query_ball_point {what}: card differs from CPU")
    bidx, _ = ops.query_ball_point(0.1, 32, t, cen)
    check(torch.equal(ops.group_point(t, bidx).cpu(), ops.group_point(tc, bidx.cpu())),
          "group_point: card differs from CPU")
    for got, want, what in zip(ops.knn_point(16, t, cen), ops.knn_point(16, tc, cc),
                               ("val", "idx")):
        check(torch.equal(got.cpu(), want), f"knn_point {what}: card differs from CPU")
    d3, i3 = ops.three_nn(t, cen)
    d3c, i3c = ops.three_nn(tc, cc)
    check(torch.equal(d3.cpu(), d3c) and torch.equal(i3.cpu(), i3c), "three_nn: card vs CPU")
    w = 1.0 / (d3 + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    feats = torch.from_numpy(np.random.RandomState(5).rand(4, 256, 8).astype(np.float32))
    res = []
    for d in (dev, cpu):
        f = feats.to(d).requires_grad_()
        out = ops.three_interpolate(f, i3.to(d), w.to(d))
        out.square().sum().backward()
        res.append((out.detach().cpu(), f.grad.cpu()))
    check(bool(torch.allclose(res[0][0], res[1][0], rtol=1e-6, atol=1e-7))
          and bool(torch.allclose(res[0][1], res[1][1], rtol=1e-5, atol=1e-6)),
          "three_interpolate: card differs from CPU")
    print("op API: sampling('r'), query_ball_point, group_point, knn_point, three_nn equal "
          "their CPU run exactly; three_interpolate and its gradient within 1e-5")

    # the auction at n = 1024 against its CPU run, then timed at the 4096 cap
    a, b = (torch.from_numpy(np.random.RandomState(s).rand(2, 1024, 3).astype(np.float32))
            for s in (6, 7))
    t0 = time.time()
    ml, mr = ops.auction_match(a.to(dev), b.to(dev))
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    mlc, _ = ops.auction_match(a, b)
    t_cpu = time.time() - t0
    iota = torch.arange(1024, device=dev).expand(2, 1024)
    check(torch.equal(ml.long().sort(1).values, iota)
          and torch.equal(mr.long().sort(1).values, iota)
          and torch.equal(torch.gather(mr.long(), 1, ml.long()), iota),
          "auction_match: matchl/matchr are not inverse permutations")
    cost = [float((a - _gather_rows(b, m)).norm(dim=-1).sum()) for m in (ml.cpu(), mlc)]
    check(abs(cost[0] - cost[1]) <= 1e-5 * cost[1], f"auction_match: card cost {cost[0]} vs "
          f"CPU {cost[1]}")
    e_card, e_cpu = float(losses.emd_func(a.to(dev), b.to(dev))), float(losses.emd_func(a, b))
    check(abs(e_card - e_cpu) <= 1e-5 * e_cpu, f"emd_func: card {e_card} vs CPU {e_cpu}")
    big = [torch.from_numpy(np.random.RandomState(s).rand(4, 4096, 3).astype(np.float32)).to(dev)
           for s in (8, 9)]
    t0 = time.time()
    ml4, _ = ops.auction_match(*big)
    torch.cuda.synchronize()
    t_big = time.time() - t0
    check(torch.equal(ml4.long().sort(1).values, torch.arange(4096, device=dev).expand(4, 4096)),
          "auction_match (4,4096,3): matchl is not a permutation")
    print(f"op API: auction_match (2,1024,3) permutations, assignment "
          f"{'identical to' if torch.equal(ml.cpu(), mlc) else 'as cheap as'} the CPU run's "
          f"(cost {cost[0]:.6f}), {t_card:.3f} s on the card, {t_cpu:.3f} s on the CPU; emd_func "
          f"{e_card:.8f} vs CPU {e_cpu:.8f}; auction_match (4,4096,3) {t_big:.3f} s on the card")
    return counts


def tile_backend(dev) -> dict:
    """Phase 8: one full-width train step at batch 32 and one eval batch of
    4 (forward, CD, fidelity) under the "tile" backend against the "dyn"
    backend, from the same weights and batch. Loss terms and metrics agree
    within 1e-5 relative and the gradients within 1e-4 relative L2 (the
    distances are bit-equal; the means sum them in another order); launch
    counts are exact, K8 standing where K3 stood. Returns the tile run's
    launch counts."""
    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.eval import make_complete_fn
    from rfnet_tpu_torch.ops import chamfer

    partial, gt = (x.to(dev) for x in train_batch(32, seed=21))
    p4, g4 = partial[:4].contiguous(), gt[:4].contiguous()
    config = train.TrainConfig(batch_size=32)
    n1, n2 = 2 * config.n_seed, 2 * config.n_seed * config.up_ratio
    check(chamfer._NN_SORTED_BACKEND == "dyn", "the default backend is not dyn")
    res = {}
    try:
        for backend in ("dyn", "tile"):
            chamfer._NN_SORTED_BACKEND = backend
            state = train.create_state(config, dev)
            # the eval first: after a step the two backends' weights differ
            # wherever Adam's first update takes the sign of a tiny gradient
            complete, metrics = make_complete_fn(state.model)
            kernels.reset_launch_counts()
            cd, fid = metrics(p4, complete(p4), g4)
            torch.cuda.synchronize(dev)
            eval_counts = dict(kernels.launches)
            kernels.reset_launch_counts()
            lb, _ = train.train_step(state, partial, gt, n1=n1, n2=n2)
            torch.cuda.synchronize(dev)
            step_counts = dict(kernels.launches)
            terms = {k: float(v) for k, v in lb._asdict().items()}
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
                     if p.grad is not None}

            def timed(fn):
                fn()
                torch.cuda.synchronize(dev)
                t0 = time.time()
                for _ in range(3):
                    fn()
                torch.cuda.synchronize(dev)
                return (time.time() - t0) / 3 * 1e3

            step_ms = timed(lambda: train.train_step(state, partial, gt, n1=n1, n2=n2))
            eval_ms = timed(lambda: metrics(p4, complete(p4), g4))
            res[backend] = (terms, grads, cd.cpu(), fid.cpu(), step_counts, eval_counts,
                            step_ms, eval_ms)
    finally:
        chamfer._NN_SORTED_BACKEND = "dyn"
    (lt, gd, cdd, fd, sc_d, ec_d, sms_d, ems_d) = res["dyn"]
    (tt, gtile, cdt, ft, sc_t, ec_t, sms_t, ems_t) = res["tile"]
    check(sc_d == STEP_LAUNCHES and ec_d == SERVE_LAUNCHES, f"dyn launch counts {sc_d} {ec_d}")
    check(sc_t == under_tile_backend(STEP_LAUNCHES) and ec_t == under_tile_backend(SERVE_LAUNCHES),
          f"tile launch counts {sc_t} {ec_t}")
    worst = 0.0
    for k in lt:
        rel = abs(lt[k] - tt[k]) / max(abs(lt[k]), 1e-30)
        check(rel <= 1e-5, f"{k}: dyn {lt[k]} tile {tt[k]}")
        worst = max(worst, rel)
    num = sum(float((gd[n].double() - gtile[n].double()).square().sum()) for n in gd)
    den = sum(float(gd[n].double().square().sum()) for n in gd)
    grel = math.sqrt(num / den)
    check(set(gd) == set(gtile) and grel <= 1e-4, f"gradients differ by {grel:.3g} relative L2")
    mrel = max(float(((cdd - cdt).abs() / cdd.abs()).max()), float(((fd - ft).abs() / fd).max()))
    check(mrel <= 1e-5, f"eval metrics differ by {mrel:.3g} relative")
    print(f"tile backend, train step b32: loss terms within {worst:.3g} relative of dyn, "
          f"gradients {grel:.3g} relative L2; launches {sc_t}; step {sms_t:.3f} ms "
          f"({32 / sms_t * 1e3:.1f} clouds/s) vs dyn {sms_d:.3f} ms ({32 / sms_d * 1e3:.1f})")
    print(f"tile backend, eval batch of 4 (forward + CD + fidelity): metrics within {mrel:.3g} "
          f"relative of dyn; launches {ec_t}; {ems_t:.3f} ms vs dyn {ems_d:.3f} ms")
    return {k: sc_t[k] + ec_t[k] for k in sc_t}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from rfnet_tpu_torch import kernels  # absent when run outside the repository

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.time()
    kernels.build()
    print(f"kernel build: {time.time() - t0:.1f} s")
    with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        rows = check_kernels(dev)
        check_train_kernels(dev, rows)
        check_tiled_kernels(dev, rows)
        serve_counts = serve(dev)
        train_counts = train_run(dev)
        cross_check_step(dev)
        forward_throughput(dev)
        ops_counts = op_api(dev)
        tile_counts = tile_backend(dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    src = {"fps": ("fps.cu", "rfnet_tpu/ops/pallas/fps.py:73", "serve"),
           "nn_coords": ("nn_coords.cu", "rfnet_tpu/ops/pallas/chamfer.py:153", "serve"),
           "nn_dyn": ("nn_dyn.cu", "rfnet_tpu/ops/pallas/chamfer_dyn.py:170", "serve"),
           "nn_dense": ("nn_dense.cu", "rfnet_tpu/ops/pallas/chamfer.py:222", "train"),
           "nn_grad": ("nn_grad.cu", "rfnet_tpu/ops/pallas/nn_grad.py:81", "train"),
           "emd_cost": ("emd_cost.cu", "rfnet_tpu/ops/pallas/emd.py:347", "train"),
           "nn_pruned": ("nn_pruned.cu", "rfnet_tpu/ops/pallas/chamfer_pruned.py:128", "ops"),
           "nn_tile": ("nn_tile.cu", "rfnet_tpu/ops/pallas/chamfer_tile.py:214", "tile")}
    by_path = {"serve": serve_counts, "train": train_counts, "ops": ops_counts,
               "tile": tile_counts}
    for name, (_, _, path) in src.items():
        check(by_path[path][name] > 0, f"{name} was not launched on the {path} path")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": "rfnet_tpu_torch/csrc/" + file,
         "replaces": replaces, "launches": by_path[path][name],
         "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
         "pass": True, **rows[name]}
        for name, (file, replaces, path) in src.items()
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

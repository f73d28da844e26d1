#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rfnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the CUDA kernels from
   rfnet_tpu_torch/csrc (nvcc, one process per source, all at once);
2. holds each kernel against its plain PyTorch version and times kernel,
   plain version and a one-call PyTorch yardstick with CUDA events: K1 FPS,
   K2 NN + coords and K3 early-exit NN at the serving path's shapes
   (batch 4); K1, K2, K3, K4 dense NN, K5 chamfer-backward scatter and K6
   approx-EMD cost at the trainer's shapes (batch 32, eval batch 4); K2 and
   K4 bit for bit, with their launch plan, device time and the SASS issue
   slots a pair of their scan; K1 with its cluster size, its form
   (registers or streaming) and its chain
   bound, also on 70 000 points; K3 with the share of pairs its blocks
   must scan, also on a random-init model's outputs; K7
   box-pruned NN and K8 best-first box-tile NN, bit for bit, at the losses'
   and the metrics' shapes on completion-like and on random-init outputs,
   each beside K3, and K5 with K8's Morton-order indices; K5 also with
   every query on one target, with a random-init model's argmins and with
   ragged n != m, beside a stable sort of its indices alone; K6 also on
   random-init outputs and on a ragged pair, bit-equal with its skip rule
   off, with the share of tile pairs it skips at each level and its time
   with each switchable design step off;
3. serves 16 synthetic clouds in the PCN layout (the first of the
   64-cloud held-out set ``synthetic_pairs(64, seed=1234)``) through
   ``rfnet_tpu_torch.eval.main`` on the card with the converged weights
   ``weights/rfnet_r4_105000.npz`` (``tools/export_torch_weights.py``
   writes them from ``run_r4/bestrecord``), reading the .pcd files with the
   native codec; checks the kernels that run launched, holds every row's cd
   and fidelity to the JAX CPU eval of the same weights and clouds
   (``weights/rfnet_r4_105000.jax_cpu.csv``, 1e-3 relative), prints the
   difference from the TPU eval (``run_r4/results_synth``) and the mean cd;
   then serves the first 4 clouds again on the CPU with the plain versions
   and holds the card's CSV to it;
3c. serves the 16 clouds again with ``--pipeline`` (3 batches in flight):
   the CSV identical to the synchronous one row for row, both "Average
   time" values printed;
3d. serves them with ``--bf16`` (bfloat16 feature MLPs): the mean cd
   within 0.5 % of the JAX CPU eval with ``--bf16``
   (``weights/rfnet_r4_105000.jax_cpu_bf16.csv``), the largest row
   deviation printed;
3b. on the converged model's outputs for those clouds (batch 4) and for
   the held-out set's first 32 (the losses' pair, batch 32): K3 and K8 on
   the metrics' three scans and on the pair both ways, K7 at the op API's
   shape, K6 on an eval batch of 4, each held to its plain version, with
   the share of dense pairs each scans; one b32 train step from the
   converged weights under "dyn" and under "tile", with the card's time of
   the step and of K3 and K8;
4. trains the full-width RFNet at batch 32 on synthetic clouds through
   ``rfnet_tpu_torch.train.train``: 4 Adam steps with two evals and two
   checkpoints, then a resume that takes one more step; checks the losses,
   the files, the resume and the launch counts of every kernel; times the
   train step and the eval;
4b. writes 64 full-width synthetic pairs as a tensorpack LMDB and trains
   from it through ``rfnet_tpu_torch.train.main --train_path --val_path``
   at batch 32: 2 steps, one eval of the 64 pairs and one checkpoint; checks
   the losses, the files and the launch counts, and holds the first batch
   and loss to a step on the synthetic dataflow over the same pairs;
4c. holds K1 at the pyramid precompute's shapes (64,16384,3)->64 and
   ->1024 to its plain version, then trains at batch 32 with
   ``preload_device`` on a 256-pair synthetic set: the precomputed
   pyramids equal an on-step FPS of every row and the first step's loss
   terms the host path's first step on the same batch, bit for bit;
4d. trains 3 steps with ``--synthetic_online`` through the CLI at batch
   32, with a checkpoint and an eval, then resumes: the resumed step's
   batch equals a straight-through stream's bit for bit; first of all
   phases (before any other profiling), one online step under
   ``torch.profiler`` copies nothing over 64 KB from the host (a host-fed
   step's trace, the control, shows its batch's copies);
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
9. diagnostics: ``--debug_nans`` stops a b2 step with a NaN weight with
   ``FloatingPointError``; ``--profile_dir`` writes non-empty traces of a
   short eval and a short train run that name K3's and K2's kernels;
10. data parallelism (``parallel/``, ``ops/sharded.py``) on the one card:
   (a) the trainer's CLI under ``torchrun --standalone --nproc_per_node 1``
   with ``--mesh`` (NCCL, a world of 1), 2 b32 steps, an eval and a
   checkpoint: parameters, Adam state and eval line bit-equal to the run
   without ``--mesh``; (b) a b32 step's card time with and without a 1-rank
   NCCL group (the gradient all_reduce), in turns; (c) two spawned ranks
   sharing the card through a gloo group (a check of correctness, not of
   scaling: gloo stages through the host) train at global batch 32 (16 a
   rank) on the host path, ``preload_device`` and ``synthetic_online``:
   each rank's batches bit-equal to its rows of the one-card run's,
   parameters bit-equal across ranks after every step, the first step's
   total loss within 2e-5 and every term within 1e-3 of the one-card
   step's (another batch size rounds the GEMMs otherwise, and a near-tie
   merge may pick another neighbour, as in phase 3), equal eval means, one
   checkpoint, K1-K6 counted a rank; (d) ``eval --mesh 2`` on the 16
   converged clouds: the CSV within 1e-5 of phase 3's and 1e-3 of the JAX
   CPU CSV; (e) ``nearest_neighbor_sharded`` on (4,16384,3)² bit-equal to
   K4 unsplit, ``approx_match_cost_sharded`` within 1e-4 of the plain
   recurrence and of K6 (JAX's tolerance, ``tests/test_sharded.py``);
11. export and weights interop on the converged weights and phase 3's 16
   clouds: the weights written as a reference TF bundle, imported by the
   ref-import CLI into a workdir and served by the eval CLI from that
   directory (the CSV equal to phase 3's row for row), the ``.npz`` writer
   read back; the export CLI's card artifacts (batch 4, a symbolic batch,
   ``--bf16`` batch 4) loaded in a fresh process through ``load_forward``
   and run on the 16 clouds at batch 4, 1 and 16: each within 1e-6 of the
   live forward (expected equal) with K1 once and K2 three times a batch;
   the artifacts' and the live model's forwards timed at b4 and b32, with
   the export and load seconds and the artifacts' bytes; K1's and K2's
   wrapper time through their operators against the operators' bodies
   called directly (and K1 through ``torch.library.custom_op``);
12. the run-level tools at full width: ``tools/protocol_drive_torch.py
   --synthetic`` (4 b32 steps on batches made on the card, 16 held-out
   clouds scored at steps 2 and 4, the eval CLI on the best record), again
   with ``--skip_train`` and its own CSV as the baseline (compare exits 0);
   ``tools/make_synthetic_evalset_torch.py`` dumps the 16 held-out clouds
   and the eval CLI serves them with the run's ``bestrecord/`` (mean cd the
   log's best held-out cd to 1e-5 relative); ``tools/eval_curve_torch.py``
   over the workdir (held-out column = the log's ``eval @ N`` lines) and on
   the converged weights over run_r4's 64 held-out clouds (mean cd within
   1 % of run_r4's 0.023168); the drive's stages count their launches
   through ``kernels.LAUNCH_LOG_ENV``, and the phase's counts are checked
   exactly ("protocol" in ``launches_by_path``);
13. the measurement entry points at full width, each in its own
   interpreter: ``bench_torch.py`` (one JSON line: the card's name and
   power limit, every breakdown key, a positive headline, no batch out of
   memory, the forward's matmul FLOPs equal to the layer closed form and
   the kernels' to ``_kernel_train_flops``), ``tools/verify_onchip_torch.py``
   (every one of its 15 checks ok) and each profiler once with ``--iters
   3``; the launches of the first two counted through
   ``kernels.LAUNCH_LOG_ENV`` and checked exactly ("bench" and "verify" in
   ``launches_by_path``);
14. the study path: K9 (``csrc/nn_variant.cu``, the NN variant kernel of
   ``tools/bench_chamfer_variants.py``) in its four variants against
   ``nn_variant_plain`` at (32,16384,3)², whose plans have 8 queries a
   thread, and at (4,3000,3)x(4,16384,3) and (2,700,3)x(2,1100,3), of 4
   (the targets split over warps and CTAs), on uniform clouds and, at the
   first two, on tie-heavy ones (``VARIANT_CASES``): every variant bit for
   bit, distances and indices, v0 also equal to K4, v2 to v0 and v3 to v1,
   v1 not to v0 on uniform clouds; then the study tools
   (``STUDY_TOOLS``: the variant study at (32,16384)², the backend study
   on the random init and on the converged weights, K3 against K8, K3
   against dense, the sort microbench, K3 on model outputs, the backward's
   pieces and the three loss-stack profiles) in this process with ``--iters
   3``, each one's JSON line parsed and K9's launches checked exactly; K9's
   row of the JSON line comes from the variant study's numbers, with each
   variant's plan, live warps an SM (at least the plan's design), SASS
   slots a pair and issue floor;
15. K10 (``csrc/knn.cu``, SnowflakeNet's top-16 k-NN) bit for bit against
   its plain version at every shape of the model's forward at batch 32
   (``SNOWFLAKE_KNN``), on uniform clouds and on a 1/8 grid (exact ties),
   timed beside the plain version and ``torch.cdist`` + ``topk``
   (``knn_run``, callable alone);
16. K11 (``csrc/attn.cu``, SnowflakeNet's k-NN vector attention after the
   k-NN) against its plain version at the five blocks of a forward at
   batch 32 on the benchmark's weights, within ``ATTN_ATOL``, and the plain
   version with TF32 operands outside it, timed beside the plain version
   (``attn_run``, callable alone);
17. prints whether the native .pcd codec was built and how often it read,
   the per-kernel JSON line (with the converged b32 step's times; each
   kernel's launches on every path, the preload, online, pipeline, bf16,
   mesh, export, protocol, bench, verify, study, knn and attn ones among them; "mesh"
   is rank 0's of the W=2 host-path run, "export" the b4 artifact's 4
   batches), then ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no result.
It needs the rest of the repository: alone, or without a card, it fails.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
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


def device_ms(fn, iters: int, kernel: str | tuple) -> float | None:
    """Device time a call of ``fn`` spends in the kernels whose name contains
    ``kernel`` (or one of a tuple of names), from ``torch.profiler``: what the
    card takes, however long the
    host needs to launch. None where the profiler recorded no device event
    in two tries (its tracing may be unavailable on a machine): the number
    is a side reading, and no check rests on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in e.key for k in names))
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


def library_ms(q, t, iters: int) -> tuple[float, int]:
    """The yardstick ``torch.cdist(q, t).min(-1)`` timed: one call where its
    (b, n, m) matrix stays within 8 GiB, else in chunks of queries as K9's
    row times it (``tools/bench_chamfer_variants_torch.py``:
    ``library_chunk``, ``cdist_min``). Returns its ms and the queries a
    call."""
    import torch

    from tools.bench_chamfer_variants_torch import cdist_min, library_chunk

    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    chunk = library_chunk(b, n, m)
    if chunk >= n:
        return cuda_ms(lambda: torch.cdist(q, t).min(-1), iters), n
    return cuda_ms(lambda: cdist_min(q, t, chunk), iters), chunk


def fmt_library(ms: float, chunk: int, n: int) -> str:
    return f"{ms:.4f} ms" + ("" if chunk >= n else f" ({chunk} queries a call)")


def check_k3(name: str, qs, ts) -> dict:
    """K3 on z-sorted clouds against the full plain scan and against K7 on
    the same inputs, bit for bit on distances and indices; returns its row.
    The yardstick ``cdist(q, t).min(-1)`` is :func:`library_ms`'s."""
    import torch

    from rfnet_tpu_torch.ops import chamfer, chamfer_pruned
    from tools.sim_prune_stats_torch import k3_block_pairs, k3_windows

    kd, ki = chamfer.nn_dyn(qs, ts)
    pd, pi = chamfer._nn_sorted_plain(qs, ts)
    sd, si = chamfer_pruned.nn_pruned(qs, ts)
    torch.cuda.synchronize()
    err = float((kd - pd).abs().max())
    agree = float((ki == pi).float().mean())
    check(torch.equal(kd, pd), f"K3 {name}: distances differ from the full plain scan by {err}")
    check(torch.equal(ki, pi), f"K3 {name}: indices agree with the plain scan on only "
          f"{agree:.6f}")
    check(torch.equal(kd, sd) and torch.equal(ki, si), f"K3 {name}: differs from K7")
    b, nq, m = qs.shape[0], qs.shape[1], ts.shape[1]
    # pairs any exact z-slab walk must visit: targets with (qz-tz)^2 <= best
    lo, hi = k3_windows(qs, ts, kd)
    pairs = float((hi - lo).sum())
    block_pairs = k3_block_pairs(lo, hi, m)
    ms = cuda_ms(lambda: chamfer.nn_dyn(qs, ts), 20)
    dev_ms = device_ms(lambda: chamfer.nn_dyn(qs, ts), 10, "nn_dyn_kernel")
    plain_ms = cuda_ms(lambda: chamfer._nn_sorted_plain(qs, ts), 3, warmup=1)
    lib_ms, lib_q = library_ms(qs, ts, 5)
    b_ms, b_by = bound(9.0 * pairs, 4.0 * b * (3 * nq + 3 * m + 2 * nq))
    lib = fmt_library(lib_ms, lib_q, nq)
    print(f"K3 nn_dyn {name} ({b},{nq},3)x({b},{m},3): distances and indices bit-equal to the "
          f"full plain scan and to K7; slab pairs {pairs:.0f} "
          f"({pairs / (b * nq * m):.4%} of dense), pairs of the slabs the blocks must load "
          f"{block_pairs:.0f} ({block_pairs / (b * nq * m):.4%} of dense, "
          f"{block_pairs / max(pairs, 1.0):.2f}x the slab pairs); kernel {ms:.4f} ms "
          f"({fmt_ms(dev_ms)} on the card alone), plain {plain_ms:.4f} ms, cdist.min {lib}, "
          f"bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_queries=lib_q, device_ms=dev_ms,
                slab_pairs_share=pairs / (b * nq * m),
                block_pairs_share=block_pairs / (b * nq * m))


def record(rows: dict, name: str, shape: str, row: dict, main: bool = False) -> None:
    """Keep ``row`` under ``rows[name]["shapes"]``; the kernel's own numbers
    in the JSON line are those of its ``main`` shape."""
    entry = rows.setdefault(name, {"shapes": []})
    entry["shapes"].append({"shape": shape, **row})
    if main:
        entry.update(row)


def cluster_chain_us(dev, b: int, cluster: int, exchange: bool) -> float:
    """One round of K1's chain across ``b`` clusters of ``cluster`` CTAs, in
    microseconds: its probe kernel timed with 20 000 rounds against none. A
    round is K1's exchange (every warp stores one slot into every CTA with
    st.async, every thread waits on its mbarrier) or, without ``exchange``,
    one cluster barrier."""
    import ctypes

    import torch

    from rfnet_tpu_torch import kernels

    probe = kernels._library().rfnet_cluster_chain_probe
    probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    probe.restype = ctypes.c_int

    def run(iters: int) -> None:
        err = probe(b, cluster, iters, int(exchange), torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"cluster chain probe failed: error {err}")

    many, none = cuda_ms(lambda: run(20000), 3), cuda_ms(lambda: run(0), 3)
    return (many - none) * 1e3 / 20000


def check_k1(x, npoint: int, iters: int) -> dict:
    """K1 against the plain loop: identical indices required. Beside the
    operation bound it gives the chain bound: npoint - 1 rounds of the
    kernel's exchange across the cluster, each at the round trip measured on
    this card (and, for comparison, of one cluster barrier)."""
    import torch

    from rfnet_tpu_torch.ops import fps

    b, n = x.shape[0], x.shape[1]
    cluster, per_thread = fps._fps_plan(b, n, fps._sm_count(x.device))
    form = f"{per_thread} points a thread in registers" if per_thread else "streaming"
    k_idx = fps.farthest_point_sample(npoint, x)
    p_idx = fps._fps_plain(x, npoint)
    torch.cuda.synchronize()
    check(torch.equal(k_idx, p_idx), f"K1 FPS ({b},{n},3)->{npoint}: indices differ from the "
          f"plain version at {int((k_idx != p_idx).sum())} of {k_idx.numel()} picks")
    ms = cuda_ms(lambda: fps.farthest_point_sample(npoint, x), iters)
    dev_ms = device_ms(lambda: fps.farthest_point_sample(npoint, x), 10, "fps_kernel")
    plain_ms = cuda_ms(lambda: fps._fps_plain(x, npoint), 3, warmup=1)
    b_ms, b_by = bound(8.0 * b * n * npoint, 4.0 * b * (3 * n + npoint))
    exchange_us = cluster_chain_us(x.device, b, cluster, True)
    barrier_us = cluster_chain_us(x.device, b, cluster, False)
    chain_ms = (npoint - 1) * exchange_us / 1e3
    print(f"K1 fps ({b},{n},3)->{npoint}: clusters of {cluster} CTAs x {fps._FPS_THREADS} "
          f"threads, {form}; indices identical; kernel {ms:.4f} ms ({fmt_ms(dev_ms)} on the "
          f"card alone), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), chain bound "
          f"{chain_ms:.6f} ms ({npoint - 1} exchanges of {exchange_us:.4f} us; a cluster barrier "
          f"takes {barrier_us:.4f} us)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, cluster=cluster, points_a_thread=per_thread,
                chain_bound_ms=chain_ms, exchange_us=exchange_us, cluster_barrier_us=barrier_us)


_SASS_LOOPS: dict = {}


def _sass_innermost(kernel: str) -> dict:
    """For each instantiation of ``kernel`` (its template arguments, as the
    mangled name's ``Lb``/``Li`` values) in the built library: the
    innermost loops, those with the most fp32 multiplies, adds and fused
    multiply-adds first, each as (fp32 multiplies and adds, instructions,
    fused multiply-adds, instructions a forward branch inside the loop
    skips), read with ``cuobjdump -sass``. Empty where the toolkit has no
    cuobjdump."""
    from rfnet_tpu_torch import kernels

    if not _SASS_LOOPS:
        tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
        if not os.path.exists(tool):
            return {}
        sass = subprocess.run([tool, "-sass", kernels.build()], capture_output=True, text=True,
                              check=True).stdout
        for head, body in zip(*[iter(re.split(r"Function : (\S+)", sass)[1:])] * 2):
            key = re.search(r"([A-Za-z_]+kernel)I((?:L[bi]\d+E)+)E", head)
            if not key:
                continue
            ins = {int(a, 16): op for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)}
            branches = [(at, int(to, 16)) for at, op in ins.items()
                        for to in re.findall(r"BRA (?:!?P\d, )?0x([0-9a-f]+)", op)]
            loops = [(to, at) for at, to in branches if to <= at]
            found = []
            for lo, hi in loops:
                if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops):
                    continue  # not innermost
                body = [a for a in sorted(ins) if lo <= a <= hi]
                ops = [ins[a].split()[1 if ins[a].startswith("@") else 0].split(".")[0]
                       for a in body]
                flops = sum(o in ("FMUL", "FADD") for o in ops)
                fmas = ops.count("FFMA")
                skipped = {a for at, to in branches if lo <= at < to <= hi
                           for a in body if at < a < to}
                found.append((flops + fmas, len(ops), flops, fmas, len(skipped)))
            args = tuple(int(v) for v in re.findall(r"L[bi](\d+)E", key.group(2)))
            _SASS_LOOPS.setdefault(key.group(1), {})[args] = [
                (flops, n, fmas, skipped)
                for _, n, flops, fmas, skipped in sorted(found, reverse=True)]
    return _SASS_LOOPS.get(kernel, {})


def sass_slots_a_pair(coords: bool, per_thread: int) -> float | None:
    """Issue slots a pair of K2's (``coords``) or K4's scan at
    ``per_thread`` queries a thread: the instructions of the scan's innermost
    loop that holds the most fp32 multiplies and adds (its unrolled body)
    over the pairs that loop computes (7 FMUL or FADD a pair). None where
    the toolkit has no cuobjdump."""
    loops = _sass_innermost("nn_scan_kernel").get((int(coords), per_thread))
    return None if not loops else loops[0][1] / (loops[0][0] / 7)


def sass_variant_slots_a_pair(fma: bool, eq: bool, per_thread: int) -> float | None:
    """Issue slots a pair of K9 in the variant (``fma``, ``eq``) at
    ``per_thread`` queries a thread. v0 is K4's kernel
    (:func:`sass_slots_a_pair`). For v1-v3, the unrolled chunk loop of
    ``nn_variant_kernel``: its instructions but those a forward branch skips
    (the re-find blocks, taken on a small share of chunks) over the pairs it
    computes (3 FFMA a pair under ``fma``, else 3 FMUL and 2 FADD). None
    where the toolkit has no cuobjdump."""
    if not fma and not eq:
        return sass_slots_a_pair(False, per_thread)
    loops = _sass_innermost("nn_variant_kernel").get((per_thread, int(fma), int(eq)))
    if not loops:
        return None
    flops, n, fmas, skipped = loops[0]
    return (n - skipped) / (fmas / 3 if fma else flops / 5)


def sass_tiles_slots_a_pair(best_first: bool) -> float | None:
    """Issue slots a pair of K8's (``best_first``) or K7's chunk loop: every
    instruction of the loop (the chunk's box test and vote, its 32 unrolled
    targets, the merge) over the 32 x 2 pairs a chunk it scans holds at two
    queries a thread. None where the toolkit has no cuobjdump."""
    from rfnet_tpu_torch.ops import chamfer

    loops = _sass_innermost("nn_tiles_kernel").get((int(best_first),))
    return None if not loops else loops[0][1] / (32 * chamfer._NN_TILES_R)


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def check_scan(name: str, q, t) -> dict:
    """K2 (``name`` "nn_coords") or K4 ("nn_dense") against the plain dense
    scan on the card: distances bit for bit, indices wherever the card's
    plain min did not break an exact tie another way (there the two picks
    must be equally near), and K2's coordinates equal to target[idx]; returns
    its row, with the launch plan, the device time and the SASS issue slots
    a pair beside the operation bound and the issue floor (those slots at
    128 a cycle on every SM at the card's highest clock)."""
    import torch

    from rfnet_tpu_torch.ops import chamfer, fps

    coords = name == "nn_coords"
    label, fn = ("K2", chamfer.nn_coords) if coords else ("K4", chamfer.nn_dense)
    b, nq, m = q.shape[0], q.shape[1], t.shape[1]
    sms = fps._sm_count(q.device)
    plan = chamfer._nn_scan_plan(b, nq, m, sms)
    out = fn(q, t)
    pd, pi = chamfer._one_sided(q, t)
    torch.cuda.synchronize()
    kd, ki = out[0], out[1]
    shape = f"({b},{nq})->{m}"
    err = float((kd - pd).abs().max())
    check(err == 0.0, f"{label} {shape}: distances differ from the plain scan by {err}")
    picked = chamfer._gather_rows(t, ki)
    check(not coords or torch.equal(out[2], picked), f"{label} {shape}: coordinates differ")
    same = ki == pi
    tie_gap = ((picked - q).square().sum(-1)
               - (chamfer._gather_rows(t, pi) - q).square().sum(-1))[~same]
    check(tie_gap.numel() == 0 or float(tie_gap.abs().max()) <= 1e-6,
          f"{label} {shape}: a differing pick is not a tie")
    agree = float(same.float().mean())
    check(agree >= 0.999, f"{label} {shape}: indices agree on only {agree:.6f}")
    ms = cuda_ms(lambda: fn(q, t), 20)
    dev_ms = device_ms(lambda: fn(q, t), 10, f"nn_scan_kernel<{str(coords).lower()}")
    plain_ms = cuda_ms(lambda: chamfer._one_sided(q, t), 3)
    lib_ms = cuda_ms(lambda: torch.cdist(q, t).min(-1), 10)
    b_ms, b_by = bound(9.0 * b * nq * m, 4.0 * b * (3 * nq + 3 * m + (5 if coords else 2) * nq))
    slots = sass_slots_a_pair(coords, plan[0])
    floor_ms = None if slots is None else slots * b * nq * m / (sms * 128 * sm_clock_hz()) * 1e3
    print(f"{label} {name} ({b},{nq},3)x({b},{m},3): distances bit-equal, index agreement "
          f"{agree:.6f}{', coordinates = target[idx]' if coords else ''}; plan (R, G, W, C, "
          f"tiles) {plan}; kernel {ms:.4f} ms ({fmt_ms(dev_ms)} on the card alone), plain "
          f"{plain_ms:.4f} ms, cdist.min {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}); SASS "
          f"{'not measured' if slots is None else f'{slots:.3f}'} issue slots a pair, issue "
          f"floor {fmt_ms(floor_ms)} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, device_ms=dev_ms, plan=list(plan), index_agreement=agree,
                sass_slots_a_pair=slots, issue_floor_ms=floor_ms)


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
               check_scan("nn_coords", out[:, :nq].contiguous(), partial), main=nq == 16384)

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
    dev_ms = device_ms(lambda: emd.approx_match_cost(x1, x2), 3,
                       ("emd_", "run_boxes_kernel"))
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
    # a cloud larger than 8 CTAs hold in registers: the streaming form
    big = torch.rand((1, 70000, 3), generator=gen, device=dev)
    record(rows, "fps", "(1,70000,3)->64", check_k1(big, 64, 10))
    gt1 = fps.gather_point(gt, fps.farthest_point_sample(64, gt))
    gt2 = fps.gather_point(gt, fps.farthest_point_sample(1024, gt))
    # K2: the three merge scans of the forward, outputs into the input
    for nq in (64, 1024, 16384):
        record(rows, "nn_coords", f"(32,{nq},3)x(32,3000,3)",
               check_scan("nn_coords", out_a[:, :nq].contiguous(), partial))

    # K4: zero_groupnear's two scans, rawpts -> ptcens
    for q, t in ((gt2, gt1), (gt, gt2)):
        record(rows, "nn_dense", f"({q.shape[0]},{q.shape[1]},3)x({t.shape[0]},{t.shape[1]},3)",
               check_scan("nn_dense", q, t), main=q.shape[1] == 16384)

    # K3 at the loss's shapes: the pair (gt twice, out3 and out4 stacked)
    # both ways, and re_chamfer's slices folded into the batch both ways
    gts, _ = chamfer.sort_by_z_with_order(gt)
    outs, _ = chamfer.sort_by_z_with_order(torch.cat([out_a, out_b], 0))
    gt2x = torch.cat([gts, gts], 0)
    ps, _ = chamfer.sort_by_z_with_order(out_a.reshape(256, 2048, 3))
    gss, _ = chamfer.sort_by_z_with_order(gt.reshape(256, 2048, 3))
    for name, qs, ts in (("pair gt->out", gt2x, outs), ("pair out->gt", outs, gt2x),
                         ("re_chamfer pred->gt", ps, gss), ("re_chamfer gt->pred", gss, ps)):
        record(rows, "nn_dyn", f"{name} {tuple(qs.shape)}x{tuple(ts.shape)}",
               check_k3(name, qs, ts))

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
# (K10 and K11 run in SnowflakeNet's forward alone)
STEP_LAUNCHES = {"fps": 3, "nn_coords": 3, "nn_dyn": 4, "nn_dense": 2, "nn_grad": 2,
                 "emd_cost": 0, "nn_pruned": 0, "nn_tile": 0, "nn_variant": 0, "knn": 0,
                 "attn": 0}
EVAL_LAUNCHES = {"fps": 1, "nn_coords": 3, "nn_dyn": 2, "nn_dense": 0, "nn_grad": 0,
                 "emd_cost": 1, "nn_pruned": 0, "nn_tile": 0, "nn_variant": 0, "knn": 0,
                 "attn": 0}
# launches in one serving batch of 4: forward, CD both ways, fidelity
SERVE_LAUNCHES = {"fps": 1, "nn_coords": 3, "nn_dyn": 3, "nn_dense": 0, "nn_grad": 0,
                  "emd_cost": 0, "nn_pruned": 0, "nn_tile": 0, "nn_variant": 0, "knn": 0,
                  "attn": 0}


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


def run_eval(argv: list[str]) -> str:
    from rfnet_tpu_torch import eval as eval_mod

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_mod.main(argv)
    text = buf.getvalue()
    print(text, end="")
    return text


WEIGHTS = os.path.join(HERE, "weights", "rfnet_r4_105000.npz")
# the JAX eval CLI on the CPU with those weights over the same 16 clouds
# (tools/export_torch_weights.py), and the same eval of 64 clouds on a TPU
# whose MLPs truncate their inputs to bf16 (information only)
JAX_CPU_CSV = os.path.join(HERE, "weights", "rfnet_r4_105000.jax_cpu.csv")
# the same eval with --bf16 (bfloat16 feature MLPs)
JAX_CPU_BF16_CSV = os.path.join(HERE, "weights", "rfnet_r4_105000.jax_cpu_bf16.csv")
TPU_CSV = os.path.join(HERE, "run_r4", "results_synth", "results.csv")
NUM_SERVE = 16


def read_rows(path: str) -> list[list[str]]:
    """The rows of an ``id,cd,emd`` CSV (a directory: its results.csv)."""
    if os.path.isdir(path):
        path = os.path.join(path, "results.csv")
    with open(path) as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["id", "cd", "emd"], f"{path}: CSV header {rows[0]}")
    return rows[1:]


def max_rel(rows: list[list[str]], ref: list[list[str]]) -> float:
    return max(abs(float(a) - float(b)) / abs(float(b))
               for r, f in zip(rows, ref, strict=True) for a, b in zip(r[1:], f[1:]))


def average_time(text: str) -> float:
    avg = re.search(r"Average time: ([0-9.eE+-]+)", text)
    check(avg is not None, "no 'Average time' line")
    return float(avg.group(1))


def serve(dev):
    """Phase 3: the serving path end to end on the converged weights;
    returns the launch counts."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.data import native
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from tools.make_synthetic_evalset_torch import write_evalset

    ids = write_evalset(WORK, NUM_SERVE, pcn_layout=True)
    # the 16 clouds are the first of the 64-cloud held-out set the TPU CSV scored
    for (_, p16, g16), (_, p64, g64) in zip(synthetic_pairs(NUM_SERVE, seed=1234),
                                            synthetic_pairs(64, seed=1234)):
        check(np.array_equal(p16, p64) and np.array_equal(g16, g64),
              "synthetic_pairs(16, seed=1234) is not the prefix of synthetic_pairs(64)")
    jax_rows = read_rows(JAX_CPU_CSV)
    tpu_rows = read_rows(TPU_CSV)[:NUM_SERVE]
    check([r[0] for r in jax_rows] == ids, f"the JAX CPU CSV's ids {[r[0] for r in jax_rows]} "
          f"are not the served clouds' {ids}")
    check([r[0].split("/")[1] for r in jax_rows] == [r[0].split("/")[1] for r in tpu_rows]
          == [f"{i:06d}" for i in range(NUM_SERVE)], "the reference CSVs' rows are not the "
          "clouds 0-15 of the held-out set in order")
    with open(os.path.join(WORK, "ref.list"), "w") as f:
        f.write("\n".join(ids[:4]))
    common = ["--data_dir", os.path.join(WORK, "data"), "--checkpoint", WEIGHTS,
              "--num_gt_points", "16384", "--plot_freq", "8", "--batch_size", str(B)]

    torch.cuda.reset_peak_memory_stats(dev)
    reads = native.reads
    kernels.reset_launch_counts()
    text = run_eval(["--list_path", os.path.join(WORK, "test.list"),
                     "--results_dir", os.path.join(WORK, "gpu"), "--device", "cuda", *common])
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    native_reads = native.reads - reads
    n_batches = NUM_SERVE // B
    print(f"launches in the serving run: {counts} (expected fps {n_batches}, "
          f"nn_coords {3 * n_batches}, nn_dyn {3 * n_batches})")
    check(counts == {k: n_batches * v for k, v in SERVE_LAUNCHES.items()},
          f"launch counts {counts}")
    check("step 105000" in text, "the converged checkpoint's step was not printed")
    check(native.get_lib() is not None, "the native .pcd codec did not build")
    check(native_reads == 2 * NUM_SERVE, f"the native codec read {native_reads} of the "
          f"{2 * NUM_SERVE} .pcd files")
    avg = average_time(text)
    print(f"serving the converged weights (step 105000): Average time "
          f"{avg:.6f} s/cloud (batch {B}, models 12-15), max_memory_allocated "
          f"{peak} bytes")

    gpu_rows = read_rows(os.path.join(WORK, "gpu"))
    check([r[0] for r in gpu_rows] == ids, "CSV ids differ from the list")
    vals = [float(v) for r in gpu_rows for v in r[1:]]
    check(all(math.isfinite(v) and v > 0 for v in vals), "non-finite or non-positive metric")
    # the JAX CPU eval of the same weights and clouds: its metric expands
    # |t|^2 - 2 q.t (1e-4 relative off float64 on these weights), the port
    # sums squared differences, and near-tie merges may pick another
    # neighbour, so each cd and fidelity agrees to 1e-3 relative
    jax_rel = max_rel(gpu_rows, jax_rows)
    check(jax_rel <= 1e-3, f"the card's CSV is {jax_rel:.3g} relative off the JAX CPU CSV")
    mean_cd = sum(float(r[1]) for r in gpu_rows) / len(gpu_rows)
    print(f"serving: cd and fidelity of all {NUM_SERVE} clouds within {jax_rel:.3g} relative of "
          f"the JAX CPU eval (limit 1e-3); the TPU eval's rows (MLP inputs in bf16, information "
          f"only) {max_rel(gpu_rows, tpu_rows):.3g}; mean cd {mean_cd:.6f} (JAX CPU "
          f"{sum(float(r[1]) for r in jax_rows) / len(jax_rows):.6f}, TPU "
          f"{sum(float(r[1]) for r in tpu_rows) / len(tpu_rows):.6f})")

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
    print(f"serving: {NUM_SERVE} finite CSV rows; first 4 match the CPU reference within 1e-3 "
          f"relative; the native .pcd codec read all {native_reads} files")
    return counts, avg


def converged_model(dev):
    """The converged RFNet on ``dev``, in eval mode."""
    from rfnet_tpu_torch.eval import load_state

    with contextlib.redirect_stdout(io.StringIO()):
        return load_state(WEIGHTS).to(dev).eval()


def step_device_ms(fn, iters: int) -> tuple[float, dict]:
    """Device time of a call of ``fn`` from ``torch.profiler``: all its
    kernels, and those of K3 ("nn_dyn_kernel") and K8's walk and box pass
    ("nn_tiles_kernel", "run_boxes_kernel"), in ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in events) / 1e3 / iters
    check(total > 0, "the profiler recorded no device time for the train step")
    by = {name: sum(e.device_time_total for e in events if any(k in e.key for k in keys))
          / 1e3 / iters for name, keys in (("K3", ("nn_dyn_kernel",)),
                                           ("K8", TILED_KERNELS))}
    return total, by


def converged_kernels(dev, rows: dict) -> None:
    """Phase 3b: K3, K8, K7 and K6 on the converged model's outputs, bit for
    bit against their plain versions (K6 within 2e-4); then one b32 train
    step from the converged weights under "dyn" and under "tile", timed on
    the card: the input to the sorted-space backend decision."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.ops import chamfer

    pairs = list(synthetic_pairs(32, seed=1234))  # the held-out set's first 32
    partial = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)
    gt = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)
    model = converged_model(dev)
    with torch.inference_mode():
        res = model(partial)
    out3, out4 = res.out3.clone(), res.out4.clone()
    p4, g4, o4 = (x[:B].contiguous() for x in (partial, gt, out4))
    gt2, pair = torch.cat([gt, gt], 0), torch.cat([out3, out4], 0)
    z = lambda x: chamfer.sort_by_z_with_order(x.contiguous())[0]  # noqa: E731
    cases = [("converged out->gt", o4, g4), ("converged gt->out", g4, o4),
             ("converged partial->out", p4, o4), ("converged pair gt->out", gt2, pair),
             ("converged pair out->gt", pair, gt2)]
    for name, q, t in cases:
        record(rows, "nn_dyn", name, check_k3(name, z(q), z(t)))
        record(rows, "nn_tile", name, check_tiled("nn_tile", name, q.contiguous(),
                                                   t.contiguous()))
    record(rows, "nn_pruned", "converged op API out->partial",
           check_tiled("nn_pruned", "converged op API out->partial", o4, p4))
    record(rows, "emd_cost", "converged (4,16384,3)x(4,16384,3)", check_k6("converged", g4, o4))

    # one b32 train step from the converged weights under each backend
    config = train.TrainConfig(batch_size=32)
    n1, n2 = 2 * config.n_seed, 2 * config.n_seed * config.up_ratio
    state_dict = model.state_dict()
    res = {}
    try:
        for backend in ("dyn", "tile"):
            chamfer._NN_SORTED_BACKEND = backend
            state = train.create_state(config, dev)
            state.model.load_state_dict(state_dict)
            kernels.reset_launch_counts()
            lb, _ = train.train_step(state, partial, gt, n1=n1, n2=n2)
            torch.cuda.synchronize(dev)
            counts = dict(kernels.launches)
            step = lambda: train.train_step(state, partial, gt, n1=n1, n2=n2)  # noqa: E731
            wall = cuda_ms(step, 3, warmup=1)
            dev_ms, by = step_device_ms(step, 3)
            res[backend] = ({k: float(v) for k, v in lb._asdict().items()}, counts, wall,
                            dev_ms, by)
    finally:
        chamfer._NN_SORTED_BACKEND = "dyn"
    (ld, cd_, wd, dd, byd), (lt, ct, wt, dt, byt) = res["dyn"], res["tile"]
    check(cd_ == STEP_LAUNCHES and ct == under_tile_backend(STEP_LAUNCHES),
          f"converged step launch counts: dyn {cd_}, tile {ct}")
    check(all(math.isfinite(v) for v in ld.values()), f"converged step losses {ld}")
    worst = max(abs(ld[k] - lt[k]) / max(abs(ld[k]), 1e-30) for k in ld)
    check(worst <= 1e-5, f"converged step: tile loss terms {lt} vs dyn {ld}")
    print(f"converged b32 train step (first loss {ld['total']:.6f}; tile within {worst:.3g} "
          f"relative): dyn {wd:.3f} ms to synchronize, {dd:.3f} ms on the card, K3 "
          f"{byd['K3']:.3f} ms; tile {wt:.3f} ms, {dt:.3f} ms on the card, K8 (walk and box "
          f"pass) {byt['K8']:.3f} ms")
    rows["converged_step"] = {"dyn": {"ms": wd, "device_ms": dd, "k3_device_ms": byd["K3"]},
                              "tile": {"ms": wt, "device_ms": dt, "k8_device_ms": byt["K8"]}}


def lmdb_train_run(dev) -> dict:
    """Phase 4b: the trainer's CLI on a tensorpack LMDB of 64 full-width
    synthetic pairs at batch 32, 2 steps, one eval of the 64 items and one
    checkpoint; its first loss held to a step from the same initial weights
    on the synthetic dataflow's first batch over the same items. Returns the
    launch counts."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.data.convert import write_tensorpack_lmdb
    from rfnet_tpu_torch.data.dataset import synthetic_dataflow, synthetic_pairs

    db = os.path.join(WORK, "pcn.lmdb")
    t0 = time.time()
    n = write_tensorpack_lmdb(db, synthetic_pairs(64, 6000, 16384, seed=0))
    print(f"LMDB: {n} pairs (6000-point partials, 16384-point gts) written, "
          f"{os.path.getsize(db)} bytes, {time.time() - t0:.2f} s")
    root = os.path.join(WORK, "lmdb_run")
    workdir = os.path.join(root, "model")
    taken = []
    step_fn = train.train_step

    def recording_step(state, partial, gt, **kw):
        out = step_fn(state, partial, gt, **kw)
        taken.append((partial.cpu(), gt.cpu(), {k: float(v) for k, v in out[0]._asdict().items()}))
        return out

    train.train_step = recording_step
    buf = io.StringIO()
    try:
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            train.main(["--train_path", db, "--val_path", db, "--batch_size", "32", "--steps",
                        "2", "--ckpt_every", "2", "--workdir", workdir, "--device", "cuda"])
        torch.cuda.synchronize(dev)
        counts = dict(kernels.launches)
    finally:
        train.train_step = step_fn
    print(buf.getvalue(), end="")
    want = expected_launches(2, 64 // 4)
    check(counts == want, f"LMDB train launch counts {counts} (expected {want}: 2 steps and "
          f"16 eval batches at the synthetic run's rates)")
    check(len(taken) == 2 and all(math.isfinite(v) for _, _, lb in taken for v in lb.values()),
          f"LMDB steps {[lb for _, _, lb in taken]}")
    check(sorted(os.listdir(workdir)) == ["ckpt_2.pt"], "LMDB run checkpoint")
    check(sorted(os.listdir(os.path.join(root, "bestrecord"))) == ["best.json", "model.pt"],
          "LMDB run best record")
    check("eval @ 2:" in buf.getvalue(), "LMDB run eval")

    # the synthetic dataflow over the same 64 items, from the same initial weights
    df, _ = synthetic_dataflow(64, 32, 3000, 16384)
    it = iter(df)
    _, sp, _, sg = next(it)
    it.close()
    lp, lg, llb = taken[0]
    check(np.array_equal(lp.numpy(), sp) and np.array_equal(lg.numpy(), sg),
          "the LMDB dataflow's first batch differs from the synthetic dataflow's")
    config = train.TrainConfig(batch_size=32)
    state = train.create_state(config, dev)
    slb, _ = step_fn(state, torch.from_numpy(sp).to(dev), torch.from_numpy(sg).to(dev),
                     n1=2 * config.n_seed, n2=2 * config.n_seed * config.up_ratio)
    stotal = float(slb.total)
    rel = abs(llb["total"] - stotal) / abs(stotal)
    check(rel <= 1e-6, f"LMDB first loss {llb['total']} vs synthetic {stotal} (rel {rel:.3g})")
    print(f"LMDB train: 2 steps (losses {llb['total']:.6f}, {taken[1][2]['total']:.6f}), one "
          f"eval of 16 batches, checkpoint and best record written; launches {counts}; first "
          f"batch equal to the synthetic dataflow's, first loss within {rel:.3g} relative of "
          f"the synthetic-fed step's ({stotal:.6f})")
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


# the box pass and the walk of K7 and K8 (csrc/nn_tiles.cuh)
TILED_KERNELS = ("run_boxes_kernel", "nn_tiles_kernel")


def check_tiled(kernel: str, name: str, q, t) -> dict:
    """K7 or K8 on the clouds ``q`` -> ``t`` (sorted here as the kernel wants
    them) against the full plain scan, bit for bit on distances and indices,
    K7 also against K3; timed (the wrapper's call, and the card alone: the
    box pass and the walk in ``torch.profiler``) beside K3 on the same
    clouds z-sorted. The bound counts the pairs no exact rule over 32-target
    runs can skip (``tools/sim_prune_stats_torch.py:tiled_needed_pairs``)."""
    import torch

    from rfnet_tpu_torch.ops import chamfer, chamfer_pruned, chamfer_tile
    from tools.sim_prune_stats_torch import tiled_needed_pairs

    label, sort_fn, fn, plan = {
        "nn_pruned": ("K7", chamfer.sort_by_z_with_order, chamfer_pruned.nn_pruned,
                      chamfer_pruned._PLAN),
        "nn_tile": ("K8", chamfer_tile.sort_by_morton_with_order, chamfer_tile.nn_tile,
                    chamfer_tile._PLAN),
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
    warps, tile_m = chamfer._nn_tiles_fit(kernel, nq, m, plan)
    r = chamfer._NN_TILES_R
    mt = -(-m // tile_m)
    _, _, visited = chamfer._nn_tiled(kernel, qs, ts, plan)
    loaded = float(visited.float().mean()) / mt
    pairs, union = tiled_needed_pairs(qs, ts, kd, 32 * r)
    ms = cuda_ms(lambda: fn(qs, ts), 20)
    dev_ms = device_ms(lambda: fn(qs, ts), 10, TILED_KERNELS)
    k3_ms = cuda_ms(lambda: chamfer.nn_dyn(qz, tz), 10)
    plain_ms = cuda_ms(lambda: chamfer._nn_sorted_plain(qs, ts), 2, warmup=1)
    lib_ms, lib_q = library_ms(qs, ts, 5)
    b_ms, b_by = bound(9.0 * pairs, 4.0 * b * (3 * nq + 3 * m + 2 * nq))
    slots = sass_tiles_slots_a_pair(kernel == "nn_tile")
    lib = fmt_library(lib_ms, lib_q, nq)
    print(f"{label} {kernel} {name} ({b},{nq},3)x({b},{m},3), plan (warps, tile) "
          f"{(warps, tile_m)}: distances and indices bit-equal to the plain scan; tiles "
          f"staged {loaded:.4%}, pairs no 32-target box rule can skip {pairs / (b * nq * m):.4%} "
          f"of dense ({union / (b * nq * m):.4%} in the union of a warp's {32 * r} queries at "
          f"their final bests); kernel {ms:.4f} ms ({fmt_ms(dev_ms)} on the card alone), K3 on "
          f"the same clouds {k3_ms:.4f} ms, plain {plain_ms:.4f} ms, cdist.min {lib}, bound {b_ms:.6f} ms "
          f"({b_by}); SASS {'not measured' if slots is None else f'{slots:.3f}'} issue slots a "
          f"pair of the chunk loop")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_queries=lib_q, device_ms=dev_ms, k3_ms=k3_ms,
                plan=[warps, tile_m],
                tiles_staged=loaded, needed_pairs_share=pairs / (b * nq * m),
                warp_union_share=union / (b * nq * m),
                sass_slots_a_pair=slots)


def k3_random_init_cases(gt, gt2, rnd_a, rnd_b, pair_rnd) -> list:
    """(name, sorted queries, sorted targets) of K3 on a random-init
    model's outputs, which lie far from the ground truth: the metrics' scans
    at batch 4 and the losses' pair and re_chamfer scans."""
    from rfnet_tpu_torch.ops import chamfer

    z = lambda x: chamfer.sort_by_z_with_order(x.contiguous())[0]  # noqa: E731
    g4, r4, g2, p2 = z(gt[:4]), z(rnd_b[:4]), z(gt2), z(pair_rnd)
    return [("random-init out->gt", r4, g4), ("random-init gt->out", g4, r4),
            ("random-init pair gt->out", g2, p2), ("random-init pair out->gt", p2, g2),
            ("random-init re_chamfer pred->gt", z(rnd_a.reshape(256, 2048, 3)),
             z(gt.reshape(256, 2048, 3)))]


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
    # K3 on the random-init outputs at the metrics' and the losses' shapes
    for name, q, t in k3_random_init_cases(gt, gt2, rnd_a, rnd_b, pair_rnd):
        record(rows, "nn_dyn", name, check_k3(name, q, t))
    cases = [
        ("completion-like out->gt", out_a[:4], gt[:4]),
        ("random-init out->gt", rnd_b[:4], gt[:4]),
        ("random-init gt->out", gt[:4], rnd_b[:4]),
        ("completion-like pair gt->out", gt2, pair_like),
        ("completion-like pair out->gt", pair_like, gt2),
        ("random-init pair gt->out", gt2, pair_rnd),
        ("random-init pair out->gt", pair_rnd, gt2),
        ("completion-like re_chamfer pred->gt", out_a.reshape(256, 2048, 3),
         gt.reshape(256, 2048, 3)),
        ("random-init re_chamfer pred->gt", rnd_a.reshape(256, 2048, 3),
         gt.reshape(256, 2048, 3)),
        ("ragged partial->out", partial[:3], out_a[:3]),
        ("op API gt->partial", gt[:4], partial[:4]),
    ]
    # the shape whose numbers stand for the kernel in the JSON line: the one
    # its main path gives it (K7 the op API, K8 the tile backend's eval batch)
    main = {"nn_pruned": "op API gt->partial", "nn_tile": "random-init out->gt"}
    for kernel in ("nn_pruned", "nn_tile"):
        for name, q, t in cases:
            record(rows, kernel, name, check_tiled(kernel, name, q.contiguous(), t.contiguous()),
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
    times = [(cuda_ms(lambda f=f: f(q, t), 10), device_ms(lambda f=f: f(q, t), 10, TILED_KERNELS))
             for f in (ops.nearest_neighbor_pruned, ops.nearest_neighbor_tile)]
    print("op API: nearest_neighbor_pruned and nearest_neighbor_tile (4,16384,3)x(4,3000,3) "
          "unsorted: distances bit-equal to nearest_neighbor_dyn, every index a nearest target; "
          + "; ".join(f"{k} {ms:.4f} ms with its sorts ({fmt_ms(dev)} in the kernel on the card "
                      f"alone)" for k, (ms, dev) in zip(("K7", "K8"), times)))

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


def serve_variants(dev, sync_avg: float) -> tuple[dict, dict]:
    """Phases 3c and 3d: the 16 clouds of phase 3 served again with the
    converged weights, with ``--pipeline`` (the CSV identical to the
    synchronous one, row for row) and with ``--bf16`` (the mean cd within
    0.5 % of the JAX CPU eval with ``--bf16``); returns the two runs'
    launch counts."""
    from rfnet_tpu_torch import kernels

    common = ["--list_path", os.path.join(WORK, "test.list"), "--data_dir",
              os.path.join(WORK, "data"), "--checkpoint", WEIGHTS, "--num_gt_points", "16384",
              "--plot_freq", "1000", "--batch_size", str(B), "--device", "cuda"]
    want = {k: NUM_SERVE // B * v for k, v in SERVE_LAUNCHES.items()}
    sync_rows = read_rows(os.path.join(WORK, "gpu"))
    counts = {}
    for tag in ("pipeline", "bf16"):
        kernels.reset_launch_counts()
        text = run_eval([*common, "--results_dir", os.path.join(WORK, tag), f"--{tag}"])
        counts[tag] = dict(kernels.launches)
        check(counts[tag] == want, f"--{tag} launch counts {counts[tag]} (expected {want})")
        if tag == "pipeline":
            check(read_rows(os.path.join(WORK, tag)) == sync_rows,
                  "the pipelined CSV differs from the synchronous one")
            print(f"pipeline: CSV identical to the synchronous path's, row for row; Average "
                  f"time {average_time(text):.6f} s/cloud (amortized wall between read-backs, "
                  f"models 12-15) against {sync_avg:.6f} synchronous (forward to "
                  f"synchronize()); launches {counts[tag]}")
    rows = read_rows(os.path.join(WORK, "bf16"))
    ref = read_rows(JAX_CPU_BF16_CSV)
    check([r[0] for r in rows] == [r[0] for r in ref] == [r[0] for r in sync_rows],
          "the bf16 CSVs' ids differ")
    mean = lambda rs: sum(float(r[1]) for r in rs) / len(rs)  # noqa: E731
    rel = abs(mean(rows) - mean(ref)) / mean(ref)
    check(rel <= 5e-3, f"--bf16 mean cd {mean(rows)} vs the JAX CPU bf16 eval's {mean(ref)} "
          f"({rel:.3g} relative, limit 5e-3)")
    check(all(math.isfinite(float(v)) for r in rows for v in r[1:]), "non-finite bf16 metric")
    print(f"bf16: mean cd {mean(rows):.6f} against the JAX CPU bf16 eval's {mean(ref):.6f} "
          f"({rel:.3g} relative, limit 5e-3) and the card's float32 {mean(sync_rows):.6f}; "
          f"largest row deviation from the JAX CPU bf16 CSV {max_rel(rows, ref):.3g} relative, "
          f"from the float32 CSV {max_rel(rows, sync_rows):.3g}; launches {counts['bf16']}")
    return counts["pipeline"], counts["bf16"]


PRELOAD_SET = 256  # pairs in the preloaded training set


def preload_run(dev, rows: dict) -> dict:
    """Phase 4c: K1 at the pyramid precompute's shapes (64,16384)->64 and
    ->1024 held to its plain version; a b32 trainer with ``preload_device``
    on a 256-pair synthetic set: its pyramids equal an on-step FPS of each
    row bit for bit, and its first step's loss terms the host path's first
    step on the same batch. Returns the launch counts of the preload run."""
    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.data.dataset import synthetic_dataflow
    from rfnet_tpu_torch.ops import fps

    t0 = time.time()
    df, _ = synthetic_dataflow(PRELOAD_SET, 32, 3000, 16384)
    vdf, vn = synthetic_dataflow(4, 4, 3000, 16384, is_training=False, seed=1234)
    config = train.TrainConfig(iters=2, batch_size=32, log_every=1, ckpt_every=100,
                               workdir=os.path.join(WORK, "preload", "model"))
    partials, gts, _ = train.preload_device_data(df, config, dev)
    print(f"preload: {PRELOAD_SET} pairs made and uploaded in {time.time() - t0:.2f} s, "
          f"{partials.nbytes + gts.nbytes} bytes on the card")
    for npoint, iters in ((64, 20), (1024, 5)):
        record(rows, "fps", f"(64,16384,3)->{npoint} preload", check_k1(gts[:64], npoint, iters))
    g1s, g2s = train._precompute_pyramids(gts, 64, 1024)
    for lo in range(0, PRELOAD_SET, 32):
        g = gts[lo:lo + 32]
        check(torch.equal(g1s[lo:lo + 32], fps.gather_point(g, fps.farthest_point_sample(64, g)))
              and torch.equal(g2s[lo:lo + 32],
                              fps.gather_point(g, fps.farthest_point_sample(1024, g))),
              f"preload pyramids of rows {lo}-{lo + 31} differ from the on-step FPS")
    del partials, gts, g1s, g2s

    kernels.reset_launch_counts()
    train.train(config, df, vdf, vn, device=dev, preload_device=True)
    torch.cuda.synchronize(dev)
    counts = dict(kernels.launches)
    chunks = -(-PRELOAD_SET // 64)
    want = {k: 2 * v for k, v in STEP_LAUNCHES.items()}
    want["fps"] = 2 * 1 + 2 * chunks  # the model's seeds a step; two pyramids a chunk, once
    check(counts == want, f"preload launch counts {counts} (expected {want})")
    host = dataclasses.replace(config, iters=1, workdir=os.path.join(WORK, "host", "model"))
    train.train(host, df, vdf, vn, device=dev)
    first = read_jsonl(os.path.join(WORK, "preload", "logs", "metrics.jsonl"))
    ref = read_jsonl(os.path.join(WORK, "host", "logs", "metrics.jsonl"))
    check([x["step"] for x in first] == [0, 1] and all(
        math.isfinite(v) for x in first for v in x.values()), f"preload metrics {first}")
    check(first[0] == ref[0], f"preload first step {first[0]} differs from the host path's "
          f"{ref[0]}")
    print(f"preload: pyramids of all {PRELOAD_SET} rows bit-equal to the on-step FPS; first "
          f"step's loss terms bit-equal to the host path's (total {first[0]['total']:.6f}), "
          f"second {first[1]['total']:.6f}; launches {counts} (K1: {chunks} chunks x 2 "
          f"pyramids once, then the model's seeds a step)")
    return counts


def h2d_copies(trace_path: str) -> list[int]:
    """Bytes of each host-to-device copy on the card in a Chrome trace of
    ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if "memcpy" in e.get("cat", "").lower()
              and "htod" in e.get("name", "").lower()]
    check(all("bytes" in e.get("args", {}) for e in copies),
          f"a host-to-device copy without its size in the trace: {copies[:2]}")
    return [int(e["args"]["bytes"]) for e in copies]


def online_copy_check(dev) -> None:
    """Phase 4e, run before any other profiling in this process: one online
    train step at batch 32 under ``torch.profiler`` copies nothing over 64
    KB from the host; as the control, the trace of a step fed from the host
    shows its batch's copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rfnet_tpu_torch import train
    from rfnet_tpu_torch.data import online

    config = train.TrainConfig(batch_size=32)
    state = train.create_state(config, dev)
    hp, hg = train_batch(32, seed=51)

    def online_step():
        p, g = online.synthetic_batch(config.seed, state.step, 32, 3000, 16384, dev)
        train.train_step(state, p, g, n1=64, n2=1024)

    def host_step():
        train.train_step(state, hp.to(dev), hg.to(dev), n1=64, n2=1024)

    copies = {}
    for name, step in (("online", online_step), ("host", host_step)):
        step()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize(dev)
        trace = os.path.join(WORK, f"{name}_step.json")
        prof.export_chrome_trace(trace)
        copies[name] = h2d_copies(trace)
    check(sum(copies["host"]) >= hp.nbytes + hg.nbytes, f"the control: the host-fed step's "
          f"trace shows host-to-device copies {copies['host']}, less than its "
          f"{hp.nbytes + hg.nbytes}-byte batch")
    largest = max(copies["online"], default=0)
    check(largest <= 65536, f"an online step copied {largest} bytes from the host")
    gen_ms = cuda_ms(lambda: online.synthetic_batch(1, 0, 32, 3000, 16384, dev), 10)
    gen_dev = device_ms(lambda: online.synthetic_batch(1, 0, 32, 3000, 16384, dev), 10, "")
    print(f"online step b32 under the profiler: host-to-device copies "
          f"{len(copies['online'])}, the largest {largest} bytes (limit 65536; the host-fed "
          f"control step's: {sorted(copies['host'])}); generating a b32 batch takes "
          f"{gen_ms:.4f} ms ({fmt_ms(gen_dev)} on the card)")


def online_run(dev) -> dict:
    """Phase 4d: ``--synthetic_online`` through the CLI at batch 32: 3 steps,
    a checkpoint and an eval, then a resume that takes step 3 on the batch
    a straight-through stream gives at step 3, bit for bit. Returns the
    launch counts of the first run."""
    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.data import online

    workdir = os.path.join(WORK, "online", "model")
    seen = []
    make = online.synthetic_batch

    def recording(seed, step, *args):
        batch = make(seed, step, *args)
        seen.append((seed, step, batch))
        return batch

    argv = ["--synthetic_online", "--synthetic_val_size", "4", "--batch_size", "32",
            "--ckpt_every", "3", "--workdir", workdir, "--device", "cuda"]
    online.synthetic_batch = recording
    buf = io.StringIO()
    try:
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            train.main([*argv, "--steps", "3"])
        torch.cuda.synchronize(dev)
        counts = dict(kernels.launches)
        check([(s, t) for s, t, _ in seen] == [(1, 0), (1, 1), (1, 2)], "online steps")
        seen.clear()
        with contextlib.redirect_stdout(buf):
            train.main([*argv, "--steps", "4"])
    finally:
        online.synthetic_batch = make
    text = buf.getvalue()
    print(text, end="")
    check(counts == expected_launches(3, 1), f"online launch counts {counts}")
    check("eval @ 3:" in text and "restored checkpoint at step 3" in text, "online run")
    check([(s, t) for s, t, _ in seen] == [(1, 3)], f"resumed steps {[t for _, t, _ in seen]}")
    stream = online.batch_stream(1, 0, 32, 3000, 16384, dev)
    straight = [next(stream) for _ in range(4)][3]
    check(all(torch.equal(a, b) for a, b in zip(seen[0][2], straight)),
          "the resumed run's batch at step 3 differs from the straight-through stream's")

    print(f"online: 3 steps, checkpoint and eval, resumed at step 3 on the straight-through "
          f"stream's batch, bit for bit; launches {counts}")
    return counts


def diagnostics(dev) -> None:
    """Phase 9: ``--debug_nans`` stops a b2 step with a NaN weight with
    ``FloatingPointError``; ``--profile_dir`` writes a trace of a short
    eval and of a short train run, the latter naming K3's and K2's
    kernels."""
    import torch

    from rfnet_tpu_torch import checkpoints, train

    workdir = os.path.join(WORK, "nan", "model")
    state = train.create_state(train.TrainConfig(batch_size=2), dev)
    with torch.no_grad():
        state.model.cell.state_mlp.l0.weight[0, 0] = float("nan")
    checkpoints.save_checkpoint(state, workdir, 1)
    small = ["--synthetic", "--synthetic_size", "4", "--batch_size", "2", "--steps", "1",
             "--device", "cuda"]
    raised = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train.main([*small, "--workdir", workdir, "--debug_nans"])
    except FloatingPointError as exc:
        raised = str(exc)
    check(raised is not None and "step 0" in raised,
          "--debug_nans did not stop the step with a NaN weight")
    print(f"debug_nans: FloatingPointError at the NaN weight's first step: {raised}")

    traces = {}
    for tag in ("eval", "train"):
        prof = os.path.join(WORK, "prof_" + tag)
        with contextlib.redirect_stdout(io.StringIO()):
            if tag == "eval":
                run_eval(["--list_path", os.path.join(WORK, "ref.list"), "--data_dir",
                          os.path.join(WORK, "data"), "--checkpoint", WEIGHTS,
                          "--results_dir", os.path.join(WORK, "prof_results"), "--batch_size",
                          str(B), "--plot_freq", "1000", "--device", "cuda",
                          "--profile_dir", prof])
            else:
                train.main([*small, "--workdir", os.path.join(WORK, "prof_run", "model"),
                            "--profile_dir", prof])
        path = os.path.join(prof, "trace.json")
        check(os.path.getsize(path) > 0, f"--profile_dir wrote an empty {tag} trace")
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        for kernel in ("nn_dyn_kernel", "nn_scan_kernel<true"):
            check(any(kernel in n for n in names), f"the {tag} trace does not name {kernel}")
        traces[tag] = (os.path.getsize(path), len(h2d_copies(path)))
    print(f"profile_dir: eval trace {traces['eval'][0]} bytes, train trace "
          f"{traces['train'][0]} bytes, both naming K3 (nn_dyn_kernel) and K2 "
          f"(nn_scan_kernel<true>); host-to-device copies in them {traces['eval'][1]}, "
          f"{traces['train'][1]}")


# ---------------------------------------------------------------------------
# Phase 10: data parallelism (train --mesh / --distributed, eval --mesh,
# ops/sharded.py). The machine has one card: two ranks share it through a
# gloo group, which checks correctness only (gloo stages through the host),
# and the NCCL path runs as a world of 1.
# ---------------------------------------------------------------------------

MESH_RUN = dict(iters=2, batch_size=32, eval_size=4, log_every=1, ckpt_every=2)
MESH_SET = 64  # synthetic pairs of the mesh phase's training set


@contextlib.contextmanager
def recording_steps(train, seen: list, with_hash: bool = False):
    """Record each ``train_step_pyr`` call while the block runs: the batch's
    partial and ground truth (on the CPU), the step's wall time to a
    synchronize and, with ``with_hash``, a SHA-1 of the parameters after it."""
    import hashlib

    import torch

    step_pyr = train.train_step_pyr

    def recording(state, partial, gt, *rest, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = step_pyr(state, partial, gt, *rest, **kw)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        digest = None
        if with_hash:
            flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
            digest = hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest()
        seen.append({"partial": partial.cpu(), "gt": gt.cpu(), "ms": ms, "hash": digest})
        return out

    train.train_step_pyr = recording
    try:
        yield
    finally:
        train.train_step_pyr = step_pyr


def mesh_train(mesh, mode: str, root: str) -> dict:
    """A b32 ``train.train`` run (2 steps, an eval of one batch of 4, a
    checkpoint) on ``mode``'s batch source ("host", "preload" or "online")
    with ``mesh`` (None: one process): the steps it took, the eval means and
    times, the launch counts and the files written."""
    import torch

    from rfnet_tpu_torch import kernels, train
    from rfnet_tpu_torch.data.dataset import synthetic_dataflow

    config = train.TrainConfig(workdir=os.path.join(root, "model"), **MESH_RUN)
    df = None if mode == "online" else synthetic_dataflow(MESH_SET, 32, 3000, 16384)[0]
    vdf, vn = synthetic_dataflow(4, 4, 3000, 16384, is_training=False, seed=1234)
    seen, evals = [], []
    evaluate = train.evaluate

    def timed_eval(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        means = evaluate(*args, **kw)
        evals.append((means, (time.time() - t0) * 1e3))
        return means

    train.evaluate = timed_eval
    kernels.reset_launch_counts()
    try:
        with recording_steps(train, seen, with_hash=True), \
                contextlib.redirect_stdout(io.StringIO()):
            train.train(config, df, vdf, vn, "cuda", mesh=mesh,
                        preload_device=mode == "preload", synthetic_online=mode == "online")
    finally:
        train.evaluate = evaluate
    torch.cuda.synchronize()
    out = {"seen": seen, "evals": evals, "launches": dict(kernels.launches),
           "files": sorted(os.listdir(config.workdir)) if os.path.isdir(config.workdir) else []}
    if mesh is None or mesh.is_lead:
        out["metrics"] = read_jsonl(os.path.join(root, "logs", "metrics.jsonl"))
    return out


def mesh_eval(mesh, argv: list) -> dict:
    """``eval.main(argv)`` on this rank: its standard output and launches."""
    import torch

    from rfnet_tpu_torch import eval as eval_mod
    from rfnet_tpu_torch import kernels

    kernels.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_mod.main(argv)
    torch.cuda.synchronize()
    return {"stdout": buf.getvalue(), "launches": dict(kernels.launches)}


def mesh_sharded(mesh, path: str) -> dict:
    """``ops.sharded`` on the clouds saved at ``path``: the NN both ways
    and the approx-EMD cost, each timed once warm, with the launches of K4
    and this rank's peak memory."""
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.ops import sharded

    x1, x2 = (t.to(mesh.device) for t in torch.load(path, weights_only=True))
    out = {}
    torch.cuda.reset_peak_memory_stats(mesh.device)
    for name, fn in (("nn", lambda: sharded.nearest_neighbor_sharded(x1, x2, mesh)),
                     ("emd", lambda: sharded.approx_match_cost_sharded(x1, x2, mesh))):
        fn()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.time() - t0) * 1e3, "launches": dict(kernels.launches),
                     "result": [t.cpu() for t in res] if isinstance(res, tuple) else res.cpu()}
    out["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    return out


def mesh_worker(rank: int, world: int, work: str, tasks: dict) -> None:
    """One rank of phase 10's gloo group on cuda:0: ``tasks`` {name: (worker
    function's name, args)} in order; their results saved for the parent.
    A failure is written down and ends the process at once (no cleanup that
    could wait on the other rank)."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                                world_size=world, timeout=timedelta(seconds=300))
        from rfnet_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world, "cuda:0")
        out = {}
        for name, (fn, args) in tasks.items():
            mesh.barrier()
            out[name] = globals()[fn](mesh, *args)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_ranks(world: int, work: str, tasks: dict, timeout: float = 600) -> list:
    """``mesh_worker`` on ``world`` spawned ranks sharing cuda:0; their
    results in rank order. Fails at once when a rank fails, and kills the
    others."""
    import torch
    import torch.multiprocessing as mp

    os.makedirs(work)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_worker, args=(r, world, work, tasks)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    errors = []
    for r in range(world):
        path = os.path.join(work, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    check(not errors and all(p.exitcode == 0 for p in procs),
          f"the gloo ranks failed (exit codes {[p.exitcode for p in procs]}):\n"
          + "\n".join(errors))
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_w1_cli(dev) -> None:
    """Phase 10a: the trainer's CLI under torchrun as a world of 1 with NCCL
    (``--mesh``), 2 b32 steps, an eval and a checkpoint, against the same
    run without ``--mesh``: the checkpoint (parameters and Adam state) and
    the eval line bit-equal."""
    import torch

    from rfnet_tpu_torch import train

    argv = ["--synthetic", "--synthetic_size", str(MESH_SET), "--batch_size", "32",
            "--steps", "2", "--ckpt_every", "2"]
    runs = {}
    for tag in ("plain", "mesh"):
        workdir = os.path.join(WORK, "w1_" + tag, "model")
        t0 = time.time()
        if tag == "plain":
            with contextlib.redirect_stdout(io.StringIO()):
                train.main([*argv, "--workdir", workdir])
        else:
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1", "-m", "rfnet_tpu_torch.train", "--mesh", *argv,
                 "--workdir", workdir], cwd=HERE, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"torchrun --mesh failed:\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}")
            check("mesh: rank 0 of 1 on cuda:0" in proc.stdout, "the torchrun run had no mesh")
        wall = time.time() - t0
        check(sorted(os.listdir(workdir)) == ["ckpt_2.pt"], f"{tag} checkpoints")
        ckpt = torch.load(os.path.join(workdir, "ckpt_2.pt"), map_location="cpu",
                          weights_only=True)
        lines = read_jsonl(os.path.join(WORK, "w1_" + tag, "logs", "metrics.jsonl"))
        runs[tag] = (ckpt, lines, wall)
    (pc, pl, pw), (mc, ml, mw) = runs["plain"], runs["mesh"]
    check(pl == ml, f"the eval lines differ: plain {pl}, mesh {ml}")
    check(all(torch.equal(pc["model"][k], mc["model"][k]) for k in pc["model"]),
          "the W=1 NCCL --mesh run's parameters differ from the plain run's")
    po, mo = pc["optimizer"]["state"], mc["optimizer"]["state"]
    check(po.keys() == mo.keys() and all(
        torch.equal(po[i][k], mo[i][k]) for i in po for k in po[i]),
          "the W=1 NCCL --mesh run's Adam state differs from the plain run's")
    print(f"mesh W=1 (torchrun, NCCL, --mesh): 2 b32 steps + eval + checkpoint; parameters, "
          f"Adam state and eval line {ml[0]} bit-equal to the run without --mesh (walls "
          f"{pw:.1f} s in this process, {mw:.1f} s under torchrun with its start)")


def mesh_w1_step_ms(dev) -> None:
    """Phase 10b: a full-width b32 step's card time with and without a
    1-rank NCCL group (the gradient all_reduce of 3 827 611 float32
    parameters), in turns, in this process."""
    import torch
    import torch.distributed as dist

    from rfnet_tpu_torch import train
    from rfnet_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_mesh(1, dev)
        state = train.create_state(train.TrainConfig(), dev)
        n_params = sum(p.numel() for p in state.model.parameters())
        partial, gt = (x.to(dev) for x in train_batch(32, seed=31))
        times = {"plain": [], "mesh": []}
        for tag in ("plain", "mesh", "mesh", "plain"):
            m = mesh if tag == "mesh" else None
            card, _ = step_device_ms(lambda: train.train_step(state, partial, gt, n1=64, n2=1024,
                                                              mesh=m), 3)
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(3):
                train.train_step(state, partial, gt, n1=64, n2=1024, mesh=m)
            torch.cuda.synchronize()
            times[tag].append((card, (time.time() - t0) / 3 * 1e3))
    finally:
        dist.destroy_process_group()
    print(f"mesh W=1 step b32 ({n_params} parameters, {4 * n_params} bytes all-reduced a "
          f"step): card ms plain {[round(c, 3) for c, _ in times['plain']]}, mesh "
          f"{[round(c, 3) for c, _ in times['mesh']]}; wall ms plain "
          f"{[round(w, 3) for _, w in times['plain']]}, mesh "
          f"{[round(w, 3) for _, w in times['mesh']]}")


def mesh_run(dev) -> dict:
    """Phase 10c-e: two gloo ranks sharing cuda:0 (a correctness check, not
    a scaling number). The trainer at global batch 32 on each batch source
    against the one-process run; eval ``--mesh 2`` on the 16 converged
    clouds against phase 3's CSV and the JAX CPU CSV; ``ops.sharded`` on
    (4,16384,3)² against K4 and K6 unsplit. Returns rank 0's launch counts
    of the host-path run (the "mesh" path of the kernels line)."""
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.ops import chamfer, emd

    gen = torch.Generator(device=dev).manual_seed(41)
    _, gt = train_batch(4, seed=43)
    x1 = gt.to(dev)
    x2 = (x1 + 0.005 * torch.randn(x1.shape, generator=gen, device=dev)).contiguous()
    sharded_in = os.path.join(WORK, "sharded_in.pt")
    torch.save((x1.cpu(), x2.cpu()), sharded_in)
    eval_argv = ["--list_path", os.path.join(WORK, "test.list"), "--data_dir",
                 os.path.join(WORK, "data"), "--checkpoint", WEIGHTS, "--num_gt_points",
                 "16384", "--plot_freq", "1000", "--batch_size", str(B), "--device", "cuda:0",
                 "--results_dir", os.path.join(WORK, "mesh_eval"), "--mesh", "2"]
    tasks = {mode: ("mesh_train", (mode, os.path.join(WORK, "mesh_" + mode)))
             for mode in ("host", "preload", "online")}
    tasks["eval"] = ("mesh_eval", (eval_argv,))
    tasks["sharded"] = ("mesh_sharded", (sharded_in,))
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = run_ranks(2, os.path.join(WORK, "ranks"), tasks)
    wall = time.time() - t0

    refs = {mode: mesh_train(None, mode, os.path.join(WORK, "one_" + mode))
            for mode in ("host", "preload", "online")}
    for mode, ref in refs.items():
        r0, r1 = ranks[0][mode], ranks[1][mode]
        for r, res in enumerate((r0, r1)):
            check(len(res["seen"]) == 2, f"{mode}: rank {r} took {len(res['seen'])} steps")
            for s, (got, want) in enumerate(zip(res["seen"], ref["seen"])):
                rows = slice(16 * r, 16 * r + 16)
                check(torch.equal(got["partial"], want["partial"][rows])
                      and torch.equal(got["gt"], want["gt"][rows]),
                      f"{mode}: rank {r}'s batch of step {s} is not rows {rows} of one card's")
        check([a["hash"] for a in r0["seen"]] == [b["hash"] for b in r1["seen"]],
              f"{mode}: the ranks' parameters differ after a step")
        check([m for m, _ in r0["evals"]] == [m for m, _ in r1["evals"]],
              f"{mode}: the ranks' eval means differ {r0['evals']} {r1['evals']}")
        check(r0["files"] == ["ckpt_2.pt"], f"{mode}: checkpoints {r0['files']}")
        # batches of 16 and 32 round the MLPs' GEMMs otherwise, and a near-tie
        # merge may then pick another neighbour: each term within phase 3's
        # 1e-3, the total within JAX's 2e-5 (tests/test_multiprocess.py)
        first, want = r0["metrics"][0], ref["metrics"][0]
        check(first["step"] == want["step"] == 0, f"{mode}: metrics {r0['metrics']}")
        rels = {k: abs(first[k] - v) / max(abs(v), 1e-30) for k, v in want.items() if k != "step"}
        rel = max(rels.values())
        check(rels["total"] <= 2e-5 and rel <= 1e-3,
              f"{mode}: the first step's loss terms {first} vs one card's {want}")
        want_l = expected_launches(2, 1)
        if mode == "preload":  # the seeds a step, the eval's, the rank's 32-row shard once
            want_l["fps"] = 2 * 1 + EVAL_LAUNCHES["fps"] + 2
        for r, res in enumerate((r0, r1)):
            check(res["launches"] == want_l, f"{mode}: rank {r}'s launches {res['launches']} "
                  f"(expected {want_l})")
        print(f"mesh W=2 gloo {mode}: both ranks stepped on their 16 rows of one card's b32 "
              f"batches, bit for bit; parameters bit-equal across ranks after each step; "
              f"first step's loss terms within {rel:.3g} of one card's, the total "
              f"{rels['total']:.3g} ({first['total']:.6f}); eval means equal on both ranks "
              f"{r0['evals'][0][0]}; "
              f"one checkpoint; launches a rank {r0['launches']}; step wall ms rank 0 "
              f"{[round(x['ms'], 3) for x in r0['seen']]}, one card "
              f"{[round(x['ms'], 3) for x in ref['seen']]}; eval wall ms rank 0 "
              f"{round(r0['evals'][0][1], 3)}, one card {round(ref['evals'][0][1], 3)}")

    # eval --mesh 2 on the 16 converged clouds
    rows, single = read_rows(os.path.join(WORK, "mesh_eval")), read_rows(os.path.join(WORK, "gpu"))
    check([r[0] for r in rows] == [r[0] for r in single], "eval --mesh 2: CSV ids")
    one_rel = max_rel(rows, single)
    jax_rel = max_rel(rows, read_rows(JAX_CPU_CSV))
    check(one_rel <= 1e-5, f"eval --mesh 2's CSV is {one_rel:.3g} relative off one process's")
    check(jax_rel <= 1e-3, f"eval --mesh 2's CSV is {jax_rel:.3g} relative off the JAX CPU CSV")
    check("Average time" in ranks[0]["eval"]["stdout"]
          and "Average time" not in ranks[1]["eval"]["stdout"],
          "eval --mesh 2: rank 0 alone prints the results")
    n_batches = NUM_SERVE // B
    for r in (0, 1):
        want_l = {k: n_batches * v for k, v in SERVE_LAUNCHES.items()}
        check(ranks[r]["eval"]["launches"] == want_l,
              f"eval --mesh 2: rank {r}'s launches {ranks[r]['eval']['launches']}")
    print(f"mesh W=2 gloo eval --mesh 2 (16 converged clouds, batch 4, 2 a rank): CSV within "
          f"{one_rel:.3g} of one process's (limit 1e-5) and {jax_rel:.3g} of the JAX CPU CSV "
          f"(limit 1e-3); 'Average time' "
          f"{average_time(ranks[0]['eval']['stdout']):.6f} s/cloud")

    # ops.sharded against the unsplit K4 and K6 (and the plain recurrence)
    sh = ranks[0]["sharded"]
    for r in (0, 1):
        check(all(torch.equal(a, b) for a, b in zip(ranks[r]["sharded"]["nn"]["result"],
                                                     sh["nn"]["result"])),
              "the ranks' sharded NN results differ")
    kernels.reset_launch_counts()
    d, i = chamfer.nearest_neighbor(x1, x2)
    check(kernels.launches["nn_dense"] == 1, "the unsplit NN did not run K4")
    sd, si = sh["nn"]["result"]
    check(torch.equal(sd, d.cpu()) and torch.equal(si, i.cpu()),
          "nearest_neighbor_sharded differs from K4 unsplit")
    k6 = emd.approx_match_cost(x1, x2).cpu()
    plain = emd._approx_match_cost_plain(x1, x2).cpu()
    cost = sh["emd"]["result"]
    rel_plain = float(((cost - plain).abs() / plain.abs()).max())
    rel_k6 = float(((cost - k6).abs() / k6.abs()).max())
    # JAX's tolerance for the sharded cost (tests/test_sharded.py)
    check(rel_plain <= 1e-4, f"approx_match_cost_sharded {cost} vs the plain recurrence {plain}")
    check(rel_k6 <= 1e-4, f"approx_match_cost_sharded {cost} vs K6 {k6}")
    print(f"mesh W=2 gloo ops.sharded (4,16384,3)^2: nearest_neighbor_sharded bit-equal to K4 "
          f"unsplit (distances and indices; {sh['nn']['launches'].get('nn_dense', 0)} K4 launch "
          f"a rank, {sh['nn']['ms']:.3f} ms); approx_match_cost_sharded within {rel_plain:.3g} "
          f"of the plain recurrence and {rel_k6:.3g} of K6 ({sh['emd']['ms']:.3f} ms); peak "
          f"memory a rank {sh['peak']} bytes; the whole W=2 spawn {wall:.1f} s")
    return {"mesh": ranks[0]["host"]["launches"],
            "mesh_ranks": [ranks[r]["host"]["launches"] for r in (0, 1)]}

# phase 11: the exported artifacts, at these batch sizes (the 16 clouds in
# batches of each), checked in a fresh process
EXPORTS = {"b4": dict(batch_size=4, bf16=False, batches=(4,)),
           "symbolic": dict(batch_size=0, bf16=False, batches=(1, 16)),
           "bf16": dict(batch_size=4, bf16=True, batches=(4,))}
EXPORT_ITERS = 20  # forwards a timing takes


def _forward_ms(fn, x, iters: int) -> tuple[float, float]:
    """(card ms, wall ms) a call of ``fn(x)``: CUDA events over ``iters``
    calls, and the host clock around each call to ``synchronize()``."""
    import torch

    card = cuda_ms(lambda: fn(x), iters)
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return card, sum(walls) / iters * 1e3


def export_worker(spec_path: str) -> None:
    """Phase 11's fresh process: loads each artifact through
    ``export.load_forward``, runs the 16 clouds at each of its batch sizes
    against the live model of the same weights (at most 1e-6 apart) with K1
    once and K2 three times a batch and no other kernel, then times the
    artifacts' and the live model's forwards at b4 and b32 in turns; writes
    its readings as JSON to the spec's ``out``."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.eval import load_state
    from rfnet_tpu_torch.export import load_forward

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda", 0)
    parts = torch.from_numpy(np.load(spec["clouds"])).to(dev)
    n = parts.shape[0]
    result, forwards, lives = {}, {}, {}
    for name, art in spec["artifacts"].items():
        t0 = time.time()
        forwards[name] = load_forward(art["path"])
        load_s = time.time() - t0
        with contextlib.redirect_stdout(io.StringIO()):
            model = load_state(WEIGHTS, torch.bfloat16 if art["bf16"] else None).to(dev).eval()
        lives[name] = torch.inference_mode()(lambda x, m=model: m(x).out4)
        row = {"load_s": load_s}
        for b in art["batches"]:
            kernels.reset_launch_counts()
            outs = [forwards[name](parts[i:i + b]) for i in range(0, n, b)]
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            want = {k: {"fps": n // b, "nn_coords": 3 * n // b}.get(k, 0) for k in counts}
            check(counts == want, f"artifact {name} at batch {b}: launches {counts}, expected "
                  f"{want} (K1 once and K2 three times a batch)")
            err = max(float((o.float() - lives[name](parts[i:i + b]).float()).abs().max())
                      for o, i in zip(outs, range(0, n, b)))
            check(err <= 1e-6, f"artifact {name} at batch {b}: {err} from the live forward")
            check(all(bool(torch.isfinite(o).all()) and o.shape == (b, 16384, 3) for o in outs),
                  f"artifact {name} at batch {b}: output shape or values")
            row[f"b{b}"] = {"max_abs_err": err, "launches": counts}
        result[name] = row
    x32 = torch.cat([parts, parts])
    cases = {"live b4": (lives["b4"], parts[:4]), "artifact b4": (forwards["b4"], parts[:4]),
             "symbolic b4": (forwards["symbolic"], parts[:4]),
             "live b32": (lives["symbolic"], x32), "symbolic b32": (forwards["symbolic"], x32)}
    timings = {label: [] for label in cases}
    for fn, x in cases.values():
        fn(x)  # warm
    for label in list(cases) + list(cases)[::-1]:  # in turns, forth and back
        timings[label].append(_forward_ms(*cases[label], EXPORT_ITERS))
    result["timings"] = timings
    with open(spec["out"], "w") as f:
        json.dump(result, f)


def op_overhead(dev) -> dict:
    """K1 and K2 at the serving shapes (b4): the wrapper's time through its
    operator (``rfnet::fps``, ``rfnet::nn_coords``, registered with
    ``torch.library.Library``), the operator's body called directly, and K1
    through the same body registered with ``torch.library.custom_op``, in
    turns; CUDA events over 200 calls each (bound by the host here)."""
    import numpy as np
    import torch

    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.ops import chamfer, fps

    smoke_fps = torch.library.custom_op("rfnet_smoke::fps", fps._fps_cuda, mutates_args=(),
                                        device_types="cuda",
                                        schema="(Tensor xyz, int npoint) -> Tensor")
    pairs = list(synthetic_pairs(B, seed=7))
    partial = torch.from_numpy(np.stack([p for _, p, _ in pairs])).to(dev)
    gt = torch.from_numpy(np.stack([g for _, _, g in pairs])).to(dev)
    cases = {"K1 (4,3000)->32": {
        "wrapper": lambda: fps.farthest_point_sample(32, partial),
        "body": lambda: fps._fps_cuda(partial, 32),
        "op": lambda: torch.ops.rfnet.fps(partial, 32),
        "custom_op": lambda: smoke_fps(partial, 32)}}
    for nq in (64, 1024, 16384):
        q = gt[:, :nq].contiguous()
        cases[f"K2 ({B},{nq})x3000"] = {
            "wrapper": lambda q=q: chamfer.nn_coords(q, partial),
            "body": lambda q=q: chamfer._nn_coords_cuda(q, partial),
            "op": lambda q=q: torch.ops.rfnet.nn_coords(q, partial)}
    out = {}
    for case, fns in cases.items():
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cuda_ms(fns[k], 200, warmup=5))
        out[case] = {k: sum(v) / len(v) for k, v in ms.items()}
        print(f"{case}: ms a call (mean of two in turns) " + ", ".join(
            f"{k} {v:.4f}" for k, v in out[case].items())
            + f"; the operator adds {(out[case]['op'] - out[case]['body']) * 1e3:.1f} us"
            + (f", custom_op {(out[case]['custom_op'] - out[case]['body']) * 1e3:.1f} us"
               if "custom_op" in out[case] else ""))
    return out


def export_run(dev) -> dict:
    """Phase 11, export and weights interop, on the converged weights and
    phase 3's 16 clouds: (1) the weights through a reference TF bundle and
    back (``export_reference_checkpoint``, the ref-import CLI into a
    workdir), served by the eval CLI from that directory: the CSV equal to
    phase 3's row for row; the ``.npz`` writer read back equal; (2) the
    export CLI's card artifacts (b4, a symbolic batch, ``--bf16`` b4),
    loaded and checked in a fresh process (``export_worker``); (3) the
    operators' host cost (``op_overhead``). Returns the b4 artifact's launch
    counts (the "export" path)."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import export, kernels
    from rfnet_tpu_torch.compat import ref_import
    from rfnet_tpu_torch.compat.convert import save_npz
    from rfnet_tpu_torch.data.dataset import synthetic_pairs
    from rfnet_tpu_torch.eval import load_state

    root = os.path.join(WORK, "export")
    os.makedirs(root)
    with contextlib.redirect_stdout(io.StringIO()):
        model = load_state(WEIGHTS)
    weights = model.state_dict()
    t0 = time.time()
    prefix = os.path.join(root, "ref", "model-105000")
    ref_import.export_reference_checkpoint(prefix, weights, step=105000)
    t_bundle = time.time() - t0
    workdir = os.path.join(root, "workdir")
    ref_import.main(["--ref_prefix", prefix, "--workdir", workdir])
    t_import = time.time() - t0 - t_bundle
    ckpt = torch.load(os.path.join(workdir, "ckpt_105000.pt"), map_location="cpu",
                      weights_only=True)
    check(ckpt["step"] == 105000 and all(torch.equal(ckpt["model"][k], v)
                                         for k, v in weights.items()),
          "the ref-import CLI's checkpoint is not the converged weights at step 105000")
    kernels.reset_launch_counts()
    text = run_eval(["--list_path", os.path.join(WORK, "test.list"), "--data_dir",
                     os.path.join(WORK, "data"), "--checkpoint", workdir, "--num_gt_points",
                     "16384", "--plot_freq", "1000", "--batch_size", str(B), "--device", "cuda",
                     "--results_dir", os.path.join(root, "csv")])
    check("step 105000" in text and "WARNING" not in text,
          "the eval CLI did not serve the workdir's checkpoint")
    want = {k: NUM_SERVE // B * v for k, v in SERVE_LAUNCHES.items()}
    check(dict(kernels.launches) == want, f"serving the workdir: launches {kernels.launches}")
    check(read_rows(os.path.join(root, "csv")) == read_rows(os.path.join(WORK, "gpu")),
          "the CSV served from the TF round trip's workdir differs from phase 3's")
    save_npz(os.path.join(root, "port.npz"), weights, 105000)
    with contextlib.redirect_stdout(io.StringIO()):
        back = load_state(os.path.join(root, "port.npz")).state_dict()
    check(all(torch.equal(back[k], v) for k, v in weights.items()),
          "the .npz writer's file does not load back to the same weights")
    print(f"TF round trip: bundle {os.path.getsize(prefix + '.data-00000-of-00001')} bytes "
          f"written in {t_bundle:.2f} s, the ref-import CLI {t_import:.2f} s, eval --checkpoint "
          f"<workdir>: CSV identical to phase 3's row for row; .npz writer read back equal")

    clouds = os.path.join(root, "clouds.npy")
    np.save(clouds, np.stack([p for _, p, _ in synthetic_pairs(NUM_SERVE, seed=1234)]))
    spec = {"clouds": clouds, "out": os.path.join(root, "worker.json"), "artifacts": {}}
    for name, art in EXPORTS.items():
        path = os.path.join(root, f"{name}.pt2")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            export.main(["--checkpoint", WEIGHTS, "--out", path, "--batch_size",
                         str(art["batch_size"]), "--platforms", "cuda",
                         *(["--bf16"] if art["bf16"] else [])])
        print(f"export {name}: {time.time() - t0:.1f} s, {os.path.getsize(path)} bytes; "
              + buf.getvalue().strip().splitlines()[-1])
        spec["artifacts"][name] = {"path": path, **art}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           "chip_smoke.export_worker(sys.argv[1])",
                           os.path.join(root, "spec.json")], cwd=HERE, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"the export worker failed:\n{proc.stdout}\n{proc.stderr}")
    with open(spec["out"]) as f:
        got = json.load(f)
    print(f"fresh process: {time.time() - t0:.1f} s")
    for name in EXPORTS:
        print(f"artifact {name}: loaded in {got[name]['load_s']:.2f} s; " + "; ".join(
            f"{b}: max abs diff {r['max_abs_err']} from the live forward, launches "
            f"fps {r['launches']['fps']}, nn_coords {r['launches']['nn_coords']}"
            for b, r in got[name].items() if b != "load_s"))
    for label, runs in got["timings"].items():
        print(f"forward {label}: card ms " + ", ".join(f"{c:.3f}" for c, _ in runs)
              + "; wall ms " + ", ".join(f"{w:.3f}" for _, w in runs))
    op_overhead(dev)
    return got["b4"]["b4"]["launches"]


DRIVE = os.path.join("tools", "protocol_drive_torch.py")
PROTOCOL_VAL = 16  # held-out clouds of phase 12's training run
CONVERGED_NUM = 64  # held-out clouds of run_r4's evals
# run_r4's held-out CD at step 105000 (its best record) and the parity band
# of tools/compare_results.py's default
CONVERGED_RECORD = os.path.join(HERE, "run_r4", "bestrecord", "best.json")
PARITY_BAND = 0.01


def run_tool(argv: list[str], log: str, timeout: float = 600) -> str:
    """A script of the repository in its own interpreter, as a user runs
    it, its launches appended to ``log``; fails unless it exits 0. Returns
    its standard output."""
    from rfnet_tpu_torch import kernels

    proc = subprocess.run([sys.executable, *argv], cwd=HERE, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, kernels.LAUNCH_LOG_ENV: log})
    check(proc.returncode == 0, f"{argv} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def logged_launches(log: str) -> dict:
    """The launches the processes that wrote ``log`` made, summed."""
    counts = {k: 0 for k in STEP_LAUNCHES}
    for line in read_jsonl(log):
        for k, v in line["launches"].items():
            counts[k] += v
    return counts


def protocol_run(dev) -> dict:
    """Phase 12, the run-level tools at full width: (1) the parity drill
    ``tools/protocol_drive_torch.py --synthetic`` (4 b32 steps on batches
    made on the card, 16 held-out clouds scored at steps 2 and 4, the best
    record, the eval CLI on it over the 3-model fixture), then again with
    ``--skip_train`` and its own CSV as the baseline (compare exits 0); (2)
    ``tools/make_synthetic_evalset_torch.py`` dumps the 16 held-out clouds
    and the eval CLI serves them with the run's ``bestrecord/``: the CSV's
    mean cd is the log's best held-out cd to 1e-5 relative; (3)
    ``tools/eval_curve_torch.py`` over the workdir: the held-out column is
    the log's ``eval @ N`` lines; (4) the same tool on the converged weights
    and run_r4's 64 held-out clouds: within 1 % of run_r4's record. Returns
    the launch counts of all of it, the drive's stages' read from
    ``kernels.LAUNCH_LOG_ENV``."""
    from rfnet_tpu_torch import kernels
    from tools import eval_curve_torch, make_synthetic_evalset_torch
    from tools.protocol_drive_torch import FIXTURE_IDS

    root = os.path.join(WORK, "protocol")
    workdir = os.path.join(root, "run", "modelvv_recon")
    log_path = os.path.join(root, "launches.jsonl")
    os.makedirs(root)
    kernels.reset_launch_counts()
    t0 = time.time()
    out = run_tool([DRIVE, "--synthetic", "--steps", "4", "--ckpt_every", "2", "--workdir",
                    workdir, "--results_dir", os.path.join(root, "results"), "--train_extra",
                    "--synthetic_online", "--synthetic_val_size", str(PROTOCOL_VAL)], log_path)
    t_drive = time.time() - t0
    drill = run_tool([DRIVE, "--synthetic", "--skip_train", "--workdir", workdir,
                      "--results_dir", os.path.join(root, "results2"),
                      "--baseline_csv", os.path.join(root, "results", "results.csv")], log_path)
    check("PARITY" in drill, "the drive's compare stage did not find its own CSV in the band")
    check(read_rows(os.path.join(root, "results")) == read_rows(os.path.join(root, "results2")),
          "two evals of one best record over one fixture differ")
    evals = {int(m.group(1)): m.group(2)
             for m in re.finditer(r"eval @ (\d+): mean cd ([0-9.]+)", out)}
    check(sorted(evals) == [2, 4], f"the drive's training log has evals at {sorted(evals)}")
    with open(os.path.join(root, "run", "bestrecord", "best.json")) as f:
        best = json.load(f)
    check(f"{best['cd']:.6f}" == evals[best["step"]], f"best.json {best} against the log {evals}")
    staged = len(read_jsonl(log_path))
    check(staged == 3, f"{staged} stage processes counted launches, expected 3")

    evalset = os.path.join(root, "evalset")
    make_synthetic_evalset_torch.main(["--out", evalset, "--num", str(PROTOCOL_VAL)])
    run_eval(["--list_path", os.path.join(evalset, "test.list"), "--data_dir",
              os.path.join(evalset, "data"), "--checkpoint", os.path.join(root, "run", "bestrecord"),
              "--results_dir", os.path.join(root, "served"), "--batch_size", str(B),
              "--plot_freq", "1000", "--device", "cuda"])
    served = read_rows(os.path.join(root, "served"))
    served_cd = sum(float(r[1]) for r in served) / len(served)
    rel = abs(served_cd - best["cd"]) / best["cd"]
    check(len(served) == PROTOCOL_VAL and rel <= 1e-5,
          f"serving the dump with the best record: mean cd {served_cd} against the log's "
          f"{best['cd']} (rel {rel:.3g}, limit 1e-5)")

    curve = eval_curve_torch.main([workdir, str(PROTOCOL_VAL)])
    check([r["step"] for r in curve] == [2, 4]
          and all(f"{r['heldout_cd']:.6f}" == evals[r["step"]] for r in curve),
          f"eval_curve_torch's held-out column {curve} is not the log's {evals}")
    with open(CONVERGED_RECORD) as f:
        record = json.load(f)
    (conv,) = eval_curve_torch.main([WEIGHTS, str(CONVERGED_NUM)])
    conv_rel = (conv["heldout_cd"] - record["cd"]) / record["cd"]
    check(conv["step"] == record["step"] and abs(conv_rel) <= PARITY_BAND,
          f"the converged weights on the {CONVERGED_NUM} held-out clouds: cd "
          f"{conv['heldout_cd']} against run_r4's {record['cd']} (rel {conv_rel:.3g})")

    counts = {k: v + kernels.launches[k] for k, v in logged_launches(log_path).items()}
    batches = PROTOCOL_VAL // 4
    # train: 4 steps, 2 evals; eval_curve: 2 checkpoints and the converged
    # weights, each on two sets; the fixture served twice at batch 1
    want = expected_launches(4, 2 * batches + 2 * 2 * batches + 2 * CONVERGED_NUM // 4)
    want = {k: v + (2 * len(FIXTURE_IDS) + PROTOCOL_VAL // B) * SERVE_LAUNCHES[k]
            for k, v in want.items()}
    check(counts == want, f"protocol launch counts {counts}, expected {want}")
    print(f"protocol: the drive (train 4 steps, eval, compare) {t_drive:.1f} s; served the dump "
          f"of {PROTOCOL_VAL} held-out clouds with the best record (step {best['step']}): mean cd "
          f"{served_cd:.8f} against the log's {best['cd']:.8f} (rel {rel:.3g}); eval_curve "
          f"held-out {[round(r['heldout_cd'], 6) for r in curve]} = the log's; converged "
          f"weights on {CONVERGED_NUM} held-out clouds: cd {conv['heldout_cd']:.6f} (in-sample "
          f"{conv['in_cd']:.6f}) against run_r4's {record['cd']:.6f} ({100 * conv_rel:+.3f} %); "
          f"launches {counts}")
    return counts


# launches of one forward: K1 the model's FPS, K2 its three merges
FORWARD_LAUNCHES = {"fps": 1, "nn_coords": 3}
# launches of tools/verify_onchip_torch.py's full sweep: K4 in nn_distance
# (2), the three sorted checks (3 each) and the coordinates check (1); K3 in
# its check (3) and the backward check (2 for the indices, 2 in the
# forward); K5 twice there; K1 in its check; K2 in its check; K6 in the two
# EMD checks; the export round trip's two forwards; the model check's
# forward and 3 train steps
VERIFY_LAUNCHES = {k: v + 3 * FORWARD_LAUNCHES.get(k, 0) + 3 * STEP_LAUNCHES[k]
                   for k, v in {"fps": 1, "nn_coords": 1, "nn_dyn": 7, "nn_dense": 12,
                                "nn_grad": 2, "emd_cost": 2, "nn_pruned": 3,
                                "nn_tile": 3, "nn_variant": 0, "knn": 0, "attn": 0}.items()}
VERIFY_CHECKS = 15
# bench.py's _component_breakdown keys, and those bench_torch.py adds; the
# sweep's keys besides (fwd_[bf16_]b<N>_ms, _clouds_per_sec, _peak_gb)
BENCH_KEYS = (
    "fwd_b32_ms", "cd34_fb_b32_ms", "cd34_fb_real_b32_ms", "emd_fb_b32_ms", "recd_fb_b32_ms",
    "fps_pyramids_b32_ms", "eval_emd_16k_b4_ms", "train_step_b32_ms", "cd34_fb_indist_b32_ms",
    "train_step_indist_b32_ms", "train_gflops_per_cloud", "train_achieved_tflops",
    "train_mfu_vs_h100_fp32_peak67", "headline_batch", "fwd_gflops_per_cloud",
    "achieved_tflops", "mfu_vs_h100_fp32_peak67", "roofline", "train_matmul_flops",
    "train_kernel_flops", "fwd_scan_gflops_per_cloud", "fwd_activation_gb_per_cloud",
    "bf16_headline_batch", "bf16_achieved_tflops", "mfu_vs_h100_bf16_peak989", "roofline_bf16")


def bench_launches() -> dict:
    """The launches ``bench_torch.py`` makes at full width, from its
    constants: the two sweeps' forwards (a checked one, timeit's first, its
    warm-ups and the timed ones a batch), the breakdown's components (a
    first call, one warm-up, the timed ones each), the model's outputs for
    the two cd34 regimes, the forward and the train step FlopCounterMode
    counts."""
    import bench_torch

    calls = 2 + bench_torch.BREAKDOWN_ITERS
    forwards = 2 * sum(2 + bench_torch.SWEEP_WARMUPS + it for _, it in bench_torch.SWEEP)
    forwards += calls + 2 + 1
    steps = 2 * calls + 1
    want = {k: steps * v + forwards * FORWARD_LAUNCHES.get(k, 0)
            for k, v in STEP_LAUNCHES.items()}
    # cd34 on three regimes and re_chamfer: K3 both ways, K5 for the outputs
    want["nn_dyn"] += 4 * calls * 2
    want["nn_grad"] += 4 * calls
    want["fps"] += 2 * calls  # the two pyramids
    want["emd_cost"] += calls  # the eval EMD
    return want


def measure_run(smi: str) -> tuple[dict, dict]:
    """Phase 13, the measurement entry points at full width: (1)
    ``bench_torch.py`` prints one JSON line on the card named by
    ``nvidia-smi`` (``smi``), with every breakdown key, a positive headline,
    no batch out of memory, the forward's matmul FLOPs equal to the layer
    closed form and the kernels' to ``_kernel_train_flops``; (2)
    ``tools/verify_onchip_torch.py`` passes all its checks; (3) each profiler
    runs once. Returns the launches of (1) and (2), checked exactly."""
    import bench_torch

    from rfnet_tpu_torch.models import RFNet
    from rfnet_tpu_torch.train import TrainConfig

    root = os.path.join(WORK, "measure")
    os.makedirs(root)
    t0 = time.time()
    bench_log = os.path.join(root, "bench.jsonl")
    lines = run_tool(["bench_torch.py"], bench_log).strip().splitlines()
    t_bench = time.time() - t0
    check(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines on stdout, not one")
    line = json.loads(lines[0])
    br = line["breakdown"]
    name, limit = (v.strip() for v in smi.rsplit(",", 1))
    check(line["device"] == {"name": name, "power_limit_w": float(limit.split()[0]),
                             "count": 1}, f"bench_torch.py's device {line['device']} on {smi}")
    check(line["metric"] == bench_torch.METRIC and math.isfinite(line["value"])
          and line["value"] > 0, f"bench_torch.py's headline {line['value']}")
    sweep = [f"fwd_{t}b{b}_{k}" for t in ("", "bf16_") for b, _ in bench_torch.SWEEP
             for k in ("ms", "clouds_per_sec", "peak_gb")]
    missing = [k for k in (*BENCH_KEYS, *sweep) if k not in br]
    check(not missing, f"bench_torch.py's breakdown lacks {missing}")
    check(not [k for k in br if "oom" in k], f"a batch of the sweep ran out of memory: {br}")
    mm, _ = bench_torch.forward_layer_costs(RFNet(), TrainConfig().innum)
    b = bench_torch.BREAKDOWN_BATCH
    check(br["fwd_gflops_per_cloud"] == mm / 1e9,
          f"forward matmul {br['fwd_gflops_per_cloud']} GFLOP a cloud, closed form {mm / 1e9}")
    check(br["train_kernel_flops"] == bench_torch._kernel_train_flops(b, TrainConfig()),
          f"kernel FLOPs of a step {br['train_kernel_flops']}")
    check(br["train_matmul_flops"] >= 2 * b * mm,
          f"a b{b} step's matmul FLOPs {br['train_matmul_flops']} < twice its forward's")
    bench_counts = logged_launches(bench_log)
    check(bench_counts == bench_launches(),
          f"bench launch counts {bench_counts}, expected {bench_launches()}")
    print(f"bench_torch.py ({t_bench:.1f} s): {json.dumps(line)}")

    t0 = time.time()
    verify_log = os.path.join(root, "verify.jsonl")
    out = os.path.join(root, "onchip.json")
    run_tool(["tools/verify_onchip_torch.py", "--out", out], verify_log)
    with open(out) as f:
        artifact = json.load(f)
    checks = artifact["checks"]
    check(artifact["ok"] and len(checks) == VERIFY_CHECKS and all(c["ok"] for c in checks.values()),
          f"verify_onchip_torch.py: {checks}")
    check(artifact["device"]["name"] == name, f"verify's device {artifact['device']}")
    verify_counts = logged_launches(verify_log)
    check(verify_counts == VERIFY_LAUNCHES,
          f"verify launch counts {verify_counts}, expected {VERIFY_LAUNCHES}")
    print(f"verify_onchip_torch.py ({time.time() - t0:.1f} s): {len(checks)} checks ok: "
          + "; ".join(f"{k} {v['seconds']} s" for k, v in checks.items()))

    for script in ("tools/profile_forward_torch.py", "tools/profile_trainstep_torch.py"):
        t0 = time.time()
        text = run_tool([script, "--iters", "3"], os.path.join(root, "profile.jsonl"))
        print(f"{script} --iters 3 ({time.time() - t0:.1f} s): "
              + "; ".join(" ".join(ln.split()) for ln in text.strip().splitlines()[1:]))
    return bench_counts, verify_counts


# phase 14: the study tools (tools 2-9 of the port's study path), each run
# once in this process at full width with few timed calls: (module in tools/,
# arguments); the backend study twice, on the random init and on the
# converged weights
STUDY_ITERS = 3
STUDY_TOOLS = (
    ("bench_chamfer_variants_torch", []),
    ("bench_chamfer_backend_torch", []),
    ("bench_chamfer_backend_torch", ["--checkpoint", WEIGHTS]),
    ("bench_chamfer_tile_torch", []),
    ("bench_chamfer_dyn_torch", []),
    ("bench_chamfer_dyn2_torch", []),
    ("bench_dyn_realdata_torch", []),
    ("bench_bwd_pieces_torch", []),
    ("profile_step_gap_torch", []),
    ("profile_loss_ablate_torch", []),
    ("profile_loss_composites_torch", []),
)
# K9's cases of phase 14's checks: uniform clouds at the variant study's
# timed shape (plans of 8 queries a thread, K9's in 8 tiles), a ragged
# (4,3000)->16384 (plans of 4, the targets split over 2 warps and 8 CTAs)
# and the JAX tool's parity shape; and tie-heavy clouds (``tie_clouds``: a
# 1/64 grid, ties planted inside chunks and across chunks, tiles, warps and
# CTAs) at the first two
VARIANT_CASES = (("uniform", (32, 16384, 16384)), ("uniform", (4, 3000, 16384)),
                 ("uniform", (2, 700, 1100)), ("ties", (32, 16384, 16384)),
                 ("ties", (4, 3000, 16384)))


def check_variant(kind: str, q, t) -> float:
    """K9 in its four variants against ``nn_variant_plain`` on the card, by
    the variant study's ``hold_variants``: every variant bit for bit,
    distances and indices; v2 equal to v0, v3 to v1 and, on uniform clouds,
    v1 not v0; and v0 bit-equal to K4. Returns the largest distance
    difference (0)."""
    import torch

    from rfnet_tpu_torch.ops import chamfer, fps
    from tools.bench_chamfer_variants_torch import VARIANTS, hold_variants, nn_variant, plan_of

    outs = {name: nn_variant(q, t, fma=fma, eq_argmin=eq) for name, fma, eq in VARIANTS}
    k4 = chamfer.nn_dense(q, t)
    torch.cuda.synchronize()
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    shape = f"{kind} ({b},{n},3)x({b},{m},3)"
    check(all(torch.equal(a, b) for a, b in zip(outs[VARIANTS[0][0]], k4)),
          f"K9 v0 {shape}: differs from K4")
    held = hold_variants(q, t, outs, fma_differs=kind == "uniform")
    sms = fps._sm_count(q.device)
    plans = {name: plan_of(fma, eq, b, n, m, sms) for name, fma, eq in VARIANTS}
    print(f"K9 nn_variant {shape}: every variant bit-equal to its plain version (distances "
          f"and indices), v0 to K4, v2 to v0, v3 to v1; plans (R, G, W, C, tiles) "
          + ", ".join(f"{k} {p}" for k, p in plans.items()))
    return max(v["max_abs_err"] for v in held.values())


def study_run(dev, smi: str, rows: dict) -> dict:
    """Phase 14, the study path: K9 held to its plain version at
    ``VARIANT_CASES``; then the tools of ``STUDY_TOOLS``, each with
    ``--iters STUDY_ITERS`` in this process (a tool that stops fails the
    phase), the last line of each parsed as its JSON result on this card.
    Records K9's row from the variant study's numbers (its ``ms``, plain
    version and bound the fastest variant's), with each variant's plan, live
    warps an SM, SASS slots a pair, issue floor and bound (its own
    operations a pair); returns the launches of the tools' run, K9's checked
    exactly."""
    import importlib

    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.ops import fps
    from tools import bench_chamfer_variants_torch as variants

    sms = fps._sm_count(dev)
    errs, per_thread = {}, set()
    for kind, (b, n, m) in VARIANT_CASES:
        plans = [variants.plan_of(f, e, b, n, m, sms) for _, f, e in variants.VARIANTS]
        if kind == "ties":
            q, t = variants.tie_clouds(b + n + m, b, n, m, [(plans[0], 1)] + [
                (plans[k], variants.variant_chunk(plans[k], fma)) for k, fma in ((1, True),
                                                                                  (2, False))])
        else:
            gen = torch.Generator().manual_seed(b + n + m)
            q, t = (torch.rand(b, k, 3, generator=gen) for k in (n, m))
        errs[kind, b, n, m] = check_variant(kind, q.to(dev), t.to(dev))
        per_thread.update(p[0] for p in plans)
    check(per_thread == {4, 8}, f"K9's checks cover {per_thread} queries a thread, not 4 and 8")
    name = smi.rsplit(",", 1)[0].strip()
    kernels.reset_launch_counts()
    results = {}
    for module, argv in STUDY_TOOLS:
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"tools.{module}").main(["--iters", str(STUDY_ITERS), *argv])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(line["device"]["name"] == name, f"{module}: device {line['device']} on {smi}")
        results.setdefault(module, line)
        print(f"{module} {' '.join(argv)} ({time.time() - t0:.1f} s): {json.dumps(line)}")
    counts = dict(kernels.launches)
    want = variants.expected_launches(STUDY_ITERS)
    check(counts["nn_variant"] == want, f"study: K9 launched {counts['nn_variant']} times, "
          f"expected {want}")
    for k in ("fps", "nn_coords", "nn_dyn", "nn_dense", "nn_grad", "nn_tile"):
        check(counts[k] > 0, f"{k} was not launched on the study path")
    v = results["bench_chamfer_variants_torch"]
    b, n, m = v["shape"]
    check(("uniform", b, n, m) in errs and ("ties", b, n, m) in errs,
          f"K9 was not held to its plain version at ({b},{n})x({m})")
    clock = sm_clock_hz()
    slots, floor, bounds = {}, {}, {}
    for k, f, e in variants.VARIANTS:
        bounds[k] = bound(variants.OPS_A_PAIR[f, e] * b * n * m,
                          4.0 * b * (3 * n + 3 * m + 2 * n))
        slots[k] = sass_variant_slots_a_pair(f, e, v["plans"][k][0])
        floor[k] = None if slots[k] is None else slots[k] * b * n * m / (sms * 128 * clock) * 1e3
        want = variants.variant_live_warps(m, v["plans"][k], e) if f or e else 8
        check(v["live_warps"][k] >= want,
              f"K9 {k}: {v['live_warps'][k]} live warps an SM, fewer than {want}")
    best = v["best"]
    row = dict(max_abs_err=max(errs.values()), ms=v["variants_ms"][best], best=best,
               plain_ms=v["plain_ms"], bound_ms=bounds[best][0], bound_by=bounds[best][1],
               library_ms=v["library_ms"], variants_ms=v["variants_ms"], k4_ms=v["k4_ms"],
               bounds_ms={k: x[0] for k, x in bounds.items()}, plans=v["plans"],
               live_warps=v["live_warps"], sass_slots_a_pair=slots, issue_floor_ms=floor,
               four_scans_ms=v["four_scans_ms"], batched_ms=v["batched_ms"])
    record(rows, "nn_variant", f"({b},{n},3)x({b},{m},3)", row, main=True)
    for k, f, e in variants.VARIANTS:
        ms, (b_ms, b_by) = v["variants_ms"][k], bounds[k]
        print(f"K9 {k} at ({b},{n})x({m}): {ms:.4f} ms ({b_ms / ms:.1%} of its bound "
              f"{b_ms:.4f} ms, {b_by}, {variants.OPS_A_PAIR[f, e]} ops a pair), SASS "
              f"{fmt_ms(slots[k])} issue slots a pair, issue floor {fmt_ms(floor[k])} ms, "
              f"{v['live_warps'][k]} live warps an SM, plan {tuple(v['plans'][k])}")
    print(f"K9 beside: K4 {v['k4_ms']:.4f} ms, {best}'s plain {v['plain_ms']:.4f} ms, "
          f"cdist.min {v['library_ms']:.4f} ms ({v['library_chunk']} queries a call)")
    return counts


# (queries, targets) of every k-NN of SnowflakeNet's forward at its
# published PCN widths, at batch 32 (benchmark/flops_snowflake.py:knn_calls)
SNOWFLAKE_KNN = ((512, 2048), (512, 512), (128, 512), (128, 128), (2048, 2048))


def knn_run(dev) -> tuple[dict, dict]:
    """Phase 15: K10 (SnowflakeNet's top-16 k-NN, ``csrc/knn.cu``) against
    its plain version at every shape of the model's forward at batch 32,
    bit for bit in distances and indices, on uniform clouds and on a
    1/8 grid (exact ties: the lower index first; each point its own first
    neighbour at 0); times the wrapper, the card's kernel alone, the plain
    version and ``torch.cdist`` + ``topk`` (the library's k-NN). Returns
    (K10's row, the phase's launches)."""
    import numpy as np
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.ops import knn

    kernels.reset_launch_counts()
    rng = np.random.RandomState(15)
    shapes, row = [], {}
    for nq, m in SNOWFLAKE_KNN:
        t = torch.from_numpy(rng.rand(32, m, 3).astype(np.float32)).to(dev)
        q = t[:, :nq].contiguous() if nq < m else t
        for cloud, (qq, tt) in (("uniform", (q, t)), ("grid", ((q * 8).floor() / 8,
                                                              (t * 8).floor() / 8))):
            kd, ki = knn.knn(16, tt, qq)
            pd, pi = knn._knn_plain(16, tt, qq)
            check(torch.equal(kd, pd) and torch.equal(ki, pi),
                  f"K10 ({nq}, {m}) {cloud}: differs from the plain version")
            check(bool((kd[..., 0] == 0).all()), f"K10 ({nq}, {m}) {cloud}: self not first at 0")
        ms = cuda_ms(lambda: knn.knn(16, t, q), 20)
        dev_ms = device_ms(lambda: knn.knn(16, t, q), 10, "knn_kernel")
        plain_ms = cuda_ms(lambda: knn._knn_plain(16, t, q), 3)
        lib_ms = cuda_ms(lambda: torch.cdist(q, t).topk(16, largest=False), 10)
        b_ms, b_by = bound(8.0 * 32 * nq * m, 32 * (12.0 * (nq + m) + 8 * 16 * nq))
        shape = f"(32,{nq},3)x(32,{m},3)"
        print(f"K10 knn {shape}: bit-equal to the plain version (uniform and grid clouds); "
              f"wrapper {ms:.4f} ms, card {fmt_ms(dev_ms)} ms, plain {plain_ms:.4f} ms, "
              f"cdist+topk {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        shapes.append(dict(shape=shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        row = dict(max_abs_err=0.0, **shapes[-1])  # the largest, stage 2's, last
    row["shapes"] = shapes
    return row, dict(kernels.launches)


# K11's tolerance against its plain version on the card, in the units of
# the blocks' outputs (|out| <= 0.61 on the benchmark's weights): the most
# that float32 reordering moved them in attn_run's readings is 1.79e-7, the
# least that the plain version with TF32 operands moved them 6.82e-5
# (PERF.md §6), so 2e-6 is 11x above the one and 34x below the other
ATTN_ATOL = 2e-6


def snowflake_attn_inputs(dev, seed: int = 22, batch: int = 32) -> tuple[list[tuple], dict]:
    """The arguments of the five ``vector_attention`` calls of a SnowflakeNet
    forward at ``batch`` on the benchmark's weights (``weights_seed`` 1 in
    the published shapes, BatchNorm far from its init) and partials of the
    benchmark's traffic generator: (pos, idx, query, key, value, mlps,
    packed) each, at n = 512, 128, 512, 512, 2 048; and the forward's
    kernel launches, which must hold 5 of K11 and 7 of K10."""
    import torch

    from rfnet_tpu_torch import kernels
    from rfnet_tpu_torch.models import snowflakenet as snow

    model, partial = snowflake_model(dev), snowflake_partials(dev, batch, seed)
    calls, real = [], snow.vector_attention

    def record(*args):
        calls.append(args)
        return real(*args)

    snow.vector_attention = record
    try:
        with torch.inference_mode():
            kernels.reset_launch_counts()
            model(partial)
            launches = dict(kernels.launches)
    finally:
        snow.vector_attention = real
    check(launches["attn"] == 5 and launches["knn"] == 7,
          f"a SnowflakeNet forward launched K11 {launches['attn']} times (5 expected) and K10 "
          f"{launches['knn']} times (7 expected)")
    return calls, launches


def snowflake_model(dev):
    """SnowflakeNet at the published widths on the benchmark's weights
    (``weights_seed`` 1 in the published shapes), on ``dev``, for serving."""
    from benchmark.reference import snowflakenet as ref
    from rfnet_tpu_torch.models.snowflakenet import SnowflakeNet

    model = SnowflakeNet()
    model.load_state_dict(ref.draw_weights(ref.published_shapes(), 1))
    return model.to(dev).eval()


def snowflake_partials(dev, batch: int = 32, seed: int = 22):
    """``batch`` partials of 2 048 points from the benchmark's traffic
    generator, on ``dev``."""
    import numpy as np
    import torch

    from benchmark.traffic import synthetic

    partial = np.stack([p for p, _ in synthetic.pairs(batch, 2048, 16384, seed)])
    return torch.from_numpy(partial).to(dev)


def attn_run(dev) -> tuple[dict, dict]:
    """Phase 16: K11 (SnowflakeNet's k-NN vector attention, ``csrc/attn.cu``)
    against its plain version at the five blocks of a forward at batch 32 on
    the benchmark's weights (:func:`snowflake_attn_inputs`), within
    :data:`ATTN_ATOL`, and the plain version with TF32 operands (the
    control) outside it; times the wrapper, the card's kernel alone and the
    plain version, which is the eager attention the model ran before K11
    (so it is also the row's library time: no one PyTorch call computes the
    block). Returns (K11's row, the launches of the model's forward, not of
    the phase's timing loops)."""
    import torch

    calls, launches = snowflake_attn_inputs(dev)
    shapes, worst, control = [], 0.0, []
    with torch.inference_mode():  # as the model serves: no autograd graph
        for block, args in enumerate(calls):
            shapes.append(_attn_block(block, *args))
            worst = max(worst, shapes[-1]["max_abs_err"])
            control.append(shapes[-1]["tf32_err"])
    check(worst <= ATTN_ATOL, f"K11: {worst:.3e} from the plain version, over {ATTN_ATOL}")
    check(min(control) > ATTN_ATOL, f"K11: the TF32 control ({min(control):.3e}) is within "
          f"{ATTN_ATOL}")
    row = dict(shapes[-1], max_abs_err=worst, shapes=shapes)  # the largest, stage 2's, last
    return row, launches


def _attn_block(block: int, pos, idx, q, k, v, mlps, packed) -> dict:
    """One block of :func:`attn_run`: its readings and times."""
    import torch

    from rfnet_tpu_torch.ops import vector_attention as va

    b, n = q.shape[:2]
    got = va.vector_attention(pos, idx, q, k, v, mlps, packed)
    want = va._attention_plain(pos, idx, q, k, v, mlps)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = va._attention_plain(pos, idx, q, k, v, mlps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    err = float((got - want).abs().max())
    tf32_err = float((tf32 - want).abs().max())
    scale = float(want.abs().max())
    print(f"K11 attn block {block} ({b},{n}): |K11 - plain| {err:.3e}, |plain TF32 - plain| "
          f"{tf32_err:.3e}, |plain| <= {scale:.3f}")
    ms = cuda_ms(lambda: va.vector_attention(pos, idx, q, k, v, mlps, packed), 20)
    dev_ms = device_ms(lambda: va.vector_attention(pos, idx, q, k, v, mlps, packed), 10,
                       "attn_gemm_kernel")
    plain_ms = cuda_ms(lambda: va._attention_plain(pos, idx, q, k, v, mlps), 5)
    pairs = b * n * va.ATTN_KERNEL_K
    b_ms, b_by = bound(2.0 * pairs * (3 * 64 + 64 * 64 + 64 * 256 + 256 * 64),
                       b * n * (12 + 4 * 16 + 4 * 64 * 4) + 4 * va.PACKED_FLOATS)
    shape = f"({b},{n},16) pairs, block {block}"
    print(f"K11 attn {shape}: wrapper {ms:.4f} ms, card {fmt_ms(dev_ms)} ms, plain (the "
          f"eager attention) {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(shape=shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, tf32_err=tf32_err)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from rfnet_tpu_torch import kernels  # absent when run outside the repository
    from rfnet_tpu_torch.data import native

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
        online_copy_check(dev)
        rows = check_kernels(dev)
        check_train_kernels(dev, rows)
        check_tiled_kernels(dev, rows)
        serve_counts, sync_avg = serve(dev)
        pipeline_counts, bf16_counts = serve_variants(dev, sync_avg)
        converged_kernels(dev, rows)
        train_counts = train_run(dev)
        lmdb_counts = lmdb_train_run(dev)
        preload_counts = preload_run(dev, rows)
        online_counts = online_run(dev)
        cross_check_step(dev)
        forward_throughput(dev)
        ops_counts = op_api(dev)
        tile_counts = tile_backend(dev)
        diagnostics(dev)
        t_mesh = time.time()
        mesh_w1_cli(dev)
        mesh_w1_step_ms(dev)
        mesh_counts = mesh_run(dev)
        print(f"phase 10 (data parallelism): {time.time() - t_mesh:.1f} s")
        t_export = time.time()
        export_counts = export_run(dev)
        print(f"phase 11 (export and weights interop): {time.time() - t_export:.1f} s")
        t_protocol = time.time()
        protocol_counts = protocol_run(dev)
        print(f"phase 12 (protocol): {time.time() - t_protocol:.1f} s")
        t_measure = time.time()
        bench_counts, verify_counts = measure_run(smi)
        print(f"phase 13 (measure): {time.time() - t_measure:.1f} s")
        t_study = time.time()
        study_counts = study_run(dev, smi, rows)
        print(f"phase 14 (study): {time.time() - t_study:.1f} s")
        t_knn = time.time()
        rows["knn"], knn_counts = knn_run(dev)
        print(f"phase 15 (K10): {time.time() - t_knn:.1f} s")
        t_attn = time.time()
        rows["attn"], attn_counts = attn_run(dev)
        print(f"phase 16 (K11): {time.time() - t_attn:.1f} s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    src = {"fps": ("fps.cu", "rfnet_tpu/ops/pallas/fps.py:73", "serve"),
           "nn_coords": ("nn_coords.cu", "rfnet_tpu/ops/pallas/chamfer.py:153", "serve"),
           "nn_dyn": ("nn_dyn.cu", "rfnet_tpu/ops/pallas/chamfer_dyn.py:170", "serve"),
           "nn_dense": ("nn_dense.cu", "rfnet_tpu/ops/pallas/chamfer.py:222", "train"),
           "nn_grad": ("nn_grad.cu", "rfnet_tpu/ops/pallas/nn_grad.py:81", "train"),
           "emd_cost": ("emd_cost.cu", "rfnet_tpu/ops/pallas/emd.py:347", "train"),
           "nn_pruned": ("nn_pruned.cu", "rfnet_tpu/ops/pallas/chamfer_pruned.py:128", "ops"),
           "nn_tile": ("nn_tile.cu", "rfnet_tpu/ops/pallas/chamfer_tile.py:214", "tile"),
           "nn_variant": ("nn_variant.cu", "tools/bench_chamfer_variants.py:42", "study"),
           "knn": ("knn.cu", "none: SnowflakeNet's k-NN, new in the port", "knn"),
           "attn": ("attn.cu", "none: SnowflakeNet's vector attention, new in the port",
                    "attn")}
    by_path = {"serve": serve_counts, "train": train_counts, "lmdb": lmdb_counts,
               "ops": ops_counts, "tile": tile_counts, "preload": preload_counts,
               "online": online_counts, "pipeline": pipeline_counts, "bf16": bf16_counts,
               "mesh": mesh_counts["mesh"], "export": export_counts, "protocol": protocol_counts,
               "bench": bench_counts, "verify": verify_counts, "study": study_counts,
               "knn": knn_counts, "attn": attn_counts}
    for name, (_, _, path) in src.items():
        check(by_path[path][name] > 0, f"{name} was not launched on the {path} path")
    for name in ("fps", "nn_coords"):
        check(export_counts[name] > 0, f"{name} was not launched on the export path")
    for name in src:  # K9 runs on the study path alone, K10 and K11 on SnowflakeNet's
        check(name in ("nn_variant", "knn", "attn") or verify_counts[name] > 0,
              f"{name} was not launched on the verify path")
    for name in ("fps", "nn_coords", "nn_dyn", "nn_dense", "nn_grad", "emd_cost"):
        check(protocol_counts[name] > 0, f"{name} was not launched on the protocol path")
        check(bench_counts[name] > 0, f"{name} was not launched on the bench path")
        check(all(c[name] > 0 for c in mesh_counts["mesh_ranks"]),
              f"{name} was not launched on every rank of the mesh path")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": "rfnet_tpu_torch/csrc/" + file,
         "replaces": replaces, "launches": by_path[path][name],
         "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
         "pass": True, **rows[name]}
        for name, (file, replaces, path) in src.items()
    ], "converged_step": rows["converged_step"]}
    lib = native.get_lib()
    check(lib is not None, "the native .pcd codec did not build")
    print(f"native .pcd codec: built ({lib._name}), used for {native.reads} reads in this run")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

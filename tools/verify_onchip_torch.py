"""On-card validation sweep of the PyTorch port: every hand-written CUDA
kernel and the paths around them against an oracle the port did not write,
in one bounded run, with a machine-readable artifact (the counterpart of
``tools/verify_onchip.py``).

    python3 tools/verify_onchip_torch.py [--out FILE] [--only NAME,...]
    python3 tools/verify_onchip_torch.py --tiny --device cpu   # logic smoke

On the card it writes ``ONCHIP_VALIDATION_H100.json`` at the repo root (per
check: pass/fail, errors, seconds; the card's name and power limit) and
exits non-zero on any failure. ``--tiny`` runs the same checks at toy
shapes, ``--device cpu`` on the kernels' plain versions; neither writes
the artifact, nor does a partial sweep (``--only``). Without ``--device
cpu`` a missing card is an error. Imports no JAX.

The oracles, chosen so that no check holds a kernel to code it shares:
  - K4 (dense NN) against a float64 numpy brute force;
  - K3 (early-exit scan), K8 (best-first box-tile scan) and K7 (box-pruned
    scan, which ``verify_onchip.py`` leaves out) against a float32 numpy
    brute force in their op order, (dx² + dy²) + dz² rounded at each op:
    distances bit-equal; against K4, whose |t|² − 2q·t + |q|² rounds
    otherwise, within 2e-6; every returned index realises its distance; on
    three distributions, the all-z-equal worst case and model-like blobs
    among them;
  - K5 (the chamfer backward scatter) against autograd through a plain
    gather at the indices the forward picked;
  - K1 (FPS) against a float32 numpy loop in the plain version's op order:
    exact index parity;
  - K2 (NN + coordinates) against K4's index and a gather: distances
    bit-equal (one scan code), coordinates realising them;
  - K6 (plan-free approx-EMD cost) and ``losses.earth_mover_eval`` against
    the composed ``match_cost(approx_match)``, 1e-4 relative;
  - the train EMD's value and gradients against ``match_cost`` at a fixed
    plan; the auction on a noised permutation and at the 4096-point
    contract; ``query_ball_point``/``three_nn`` against numpy; the export
    round trip; the model's parameter count, a finite forward and a loss
    falling over 3 train steps.
The tolerances are ``verify_onchip.py``'s; the card keeps every strict one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools._common_torch import device_info, resolve_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "ONCHIP_VALIDATION_H100.json")
SEED = 20260818  # verify_onchip.py's
# K4 against the sorted scans: two roundings of one squared distance
DENSE_TOL = 2e-6


def _clouds(rng, shape, kind):
    """Test distributions: uniform, all-z-equal (the z-slab scan's worst
    case) and gaussian blobs (model-output-like clustering)."""
    if kind == "uniform":
        return rng.rand(*shape).astype(np.float32)
    if kind == "flatz":
        x = rng.rand(*shape).astype(np.float32)
        x[..., 2] = 0.5
        return x
    if kind == "blobs":
        b, n, _ = shape
        k = 8
        centers = rng.rand(b, k, 3).astype(np.float32)
        assign = rng.randint(0, k, size=(b, n))
        base = np.take_along_axis(centers, assign[..., None], axis=1)
        return (base + 0.03 * rng.randn(b, n, 3)).astype(np.float32)
    raise ValueError(kind)


def sorted_scan_numpy(q: np.ndarray, t: np.ndarray, chunk: int = 256) -> np.ndarray:
    """(b, n) float32 least ((dx² + dy²) + dz²) of each query over the
    targets, every op rounded to float32 as numpy does (no fused
    multiply-add)."""
    out = np.empty(q.shape[:2], np.float32)
    for bi in range(q.shape[0]):
        for lo in range(0, q.shape[1], chunk):
            d = q[bi, lo:lo + chunk, None, :] - t[bi, None, :, :]
            out[bi, lo:lo + chunk] = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                                      + d[..., 2] * d[..., 2]).min(axis=1)
    return out


def fps_numpy(x: np.ndarray, npoint: int) -> np.ndarray:
    """FPS indices of one (n, 3) float32 cloud, in the plain version's op
    order: start at 0; running min of ((dx² + dy²) + dz²) from 1e38; the
    first index of the max next."""
    mind = np.full(x.shape[0], 1e38, np.float32)
    picks = [0]
    for _ in range(npoint - 1):
        d = x - x[picks[-1]]
        mind = np.minimum(mind, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        picks.append(int(np.argmax(mind)))
    return np.asarray(picks, np.int32)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, 3))


class Sweep:
    def __init__(self, only=None):
        self.results = {}
        self.ok = True
        self.only = only  # check-name substrings; None = every check

    def run(self, name, fn):
        if self.only is not None and not any(s in name for s in self.only):
            return
        t0 = time.perf_counter()
        try:
            detail = fn() or {}
            entry = {"ok": True, **detail}
        except AssertionError as e:
            entry = {"ok": False, "error": str(e)[:500]}
        except Exception as e:  # a build or launch failure fails its check, not the sweep
            entry = {"ok": False, "error": f"{type(e).__name__}: {e}"[:500]}
        entry["seconds"] = round(time.perf_counter() - t0, 1)
        self.results[name] = entry
        self.ok &= entry["ok"]
        status = "PASS" if entry["ok"] else "FAIL"
        detail = entry.get("error", "") if not entry["ok"] else " ".join(
            f"{k}={v}" for k, v in entry.items() if k not in ("ok", "seconds"))
        print(f"[{status}] {name} ({entry['seconds']}s) {detail}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--tiny", action="store_true", help="toy shapes (a logic smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=ARTIFACT, help="where the card's full sweep writes")
    ap.add_argument("--only", default=None,
                    help="comma-separated check-name substrings to run; a partial sweep "
                         "never writes the artifact")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from rfnet_tpu_torch import losses, ops
    from rfnet_tpu_torch.ops.chamfer import chamfer_means, nearest_neighbor_dyn

    if args.tiny:
        n_dyn, b_dyn = 256, 2      # the sorted scans' and the backward's clouds
        n_fps, k_fps = 512, 64     # FPS source and sample sizes
        n_emd = 128                # square EMD check
        n_eval_emd, b_eval = 256, 1
    else:
        n_dyn, b_dyn = 4096, 2
        n_fps, k_fps = 16384, 1024
        n_emd = 1024
        n_eval_emd, b_eval = 4096, 1

    rng = np.random.RandomState(SEED)
    sweep = Sweep(only=args.only.split(",") if args.only else None)

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(dev)

    def host(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    # ---- K4 dense NN vs float64 numpy brute force --------------------------
    def check_dense_vs_numpy():
        x1 = _clouds(rng, (2, 384, 3), "uniform")
        x2 = _clouds(rng, (2, 512, 3), "uniform")
        d1, i1, d2, i2 = (host(v) for v in ops.nn_distance(put(x1), put(x2)))
        a1, a2 = x1.astype(np.float64), x2.astype(np.float64)
        full = ((a1[:, :, None] - a2[:, None]) ** 2).sum(-1)  # (b, n, m)
        err = max(np.abs(d1 - full.min(2)).max(), np.abs(d2 - full.min(1)).max())
        assert err < 1e-5, f"dist err {err}"
        mism = int((i1 != full.argmin(2)).sum() + (i2 != full.argmin(1)).sum())
        assert mism == 0, f"{mism} argmin index mismatches"
        return {"max_dist_err": float(err)}

    sweep.run("nn_dense_vs_numpy", check_dense_vs_numpy)

    # ---- K3, K8, K7 vs the float32 brute force and K4 ----------------------
    def make_sorted_check(nn_fn):
        def check():
            worst_np = worst_dense = 0.0
            for kind in ("uniform", "flatz", "blobs"):
                qn = _clouds(rng, (b_dyn, n_dyn, 3), kind)
                tn = _clouds(rng, (b_dyn, n_dyn, 3), kind)
                q, t = put(qn), put(tn)
                dd, _ = ops.nearest_neighbor(q, t)
                ds, si = nn_fn(q, t)
                err_np = float(np.abs(host(ds) - sorted_scan_numpy(qn, tn)).max())
                worst_np = max(worst_np, err_np)
                assert err_np == 0.0, f"{kind}: dist differs from the float32 brute force " \
                                      f"(max {err_np})"
                derr = float((ds - dd).abs().max())
                worst_dense = max(worst_dense, derr)
                assert derr <= DENSE_TOL, f"{kind}: dist vs K4 {derr} (tol {DENSE_TOL})"
                # a tie may route to another equally near index; every
                # returned index must still realise the returned distance
                d_re = ((q - _gather(t, si)) ** 2).sum(-1)
                ierr = float((d_re - ds).abs().max())
                assert ierr < 1e-5, f"{kind}: idx does not realize dist ({ierr})"
            return {"max_dist_err": worst_np, "max_dist_err_vs_dense": worst_dense}

        return check

    sweep.run("nn_dyn_vs_dense", make_sorted_check(nearest_neighbor_dyn))
    sweep.run("nn_tile_vs_dense", make_sorted_check(ops.nearest_neighbor_tile))
    sweep.run("nn_pruned_vs_dense", make_sorted_check(ops.nearest_neighbor_pruned))

    # ---- K5 chamfer backward vs autograd through a plain gather -----------
    def check_chamfer_bwd():
        p1 = put(_clouds(rng, (b_dyn, n_dyn, 3), "blobs"))
        p2 = put(_clouds(rng, (b_dyn, n_dyn, 3), "uniform"))
        # the oracle takes the indices the forward itself picked: two scans
        # may route a near tie differently, and this check is about the
        # scatter given one choice
        _, i12 = nearest_neighbor_dyn(p1, p2)
        _, i21 = nearest_neighbor_dyn(p2, p1)

        def fast(a, b):
            return sum(chamfer_means(a, b))

        def oracle(a, b):
            d1 = ((a - _gather(b, i12)) ** 2).sum(-1)
            d2 = ((b - _gather(a, i21)) ** 2).sum(-1)
            return losses._safe_sqrt(d1).mean() + losses._safe_sqrt(d2).mean()

        def value_grads(f):
            a, b = p1.clone().requires_grad_(), p2.clone().requires_grad_()
            v = f(a, b)
            return float(v.detach()), torch.autograd.grad(v, (a, b))

        v1, g_fast = value_grads(fast)
        v2, g_ref = value_grads(oracle)
        err = max(float((a - b).abs().max()) for a, b in zip(g_fast, g_ref))
        assert err < 1e-5, f"grad err {err}"
        assert abs(v1 - v2) < 1e-6, f"value {v1} vs {v2}"
        return {"max_grad_err": err}

    sweep.run("chamfer_bwd_vs_autograd", check_chamfer_bwd)

    # ---- K1 FPS vs the numpy loop (exact index parity) ---------------------
    def check_fps():
        x = _clouds(rng, (2, n_fps, 3), "blobs")
        idx_k = host(ops.farthest_point_sample(k_fps, put(x)))
        idx_s = np.stack([fps_numpy(c, k_fps) for c in x])
        mism = int((idx_k != idx_s).sum())
        assert mism == 0, f"{mism} index mismatches of {idx_s.size}"
        return {"npoint": k_fps, "n": n_fps}

    sweep.run("fps_vs_numpy", check_fps)

    # ---- K2 merge coordinates vs K4 + gather -------------------------------
    def check_coords():
        q = put(_clouds(rng, (2, n_dyn, 3), "blobs"))
        t = put(_clouds(rng, (2, 3000, 3), "uniform"))
        d_f, c_f = ops.nearest_neighbor_coords(q, t)
        d_r, i_r = ops.nearest_neighbor(q, t)
        c_r = _gather(t, i_r)
        derr = float((d_f - d_r).abs().max())
        assert derr == 0.0, f"dist err {derr}"
        # tie-agnostic: each coordinate realises the reported least distance,
        # and a divergence from K4's pick stays at tie rarity
        rerr = float((((q - c_f) ** 2).sum(-1) - d_f).abs().max())
        assert rerr < 1e-6, f"coords do not realize min dist (err {rerr})"
        mismatch = float((c_f != c_r).any(-1).float().mean())
        assert mismatch < 1e-3, f"coords diverge beyond tie rarity: {mismatch:.2%}"
        return {"tie_divergence_frac": mismatch}

    sweep.run("merge_coords_vs_gather", check_coords)

    # ---- K6 plan-free EMD cost vs the composed full-matrix path -----------
    def check_emd_cost():
        x1 = put(_clouds(rng, (2, n_emd, 3), "uniform"))
        x2 = put(_clouds(rng, (2, n_emd, 3), "blobs"))
        fused = ops.approx_match_cost(x1, x2)
        composed = ops.match_cost(x1, x2, ops.approx_match(x1, x2))
        rel = float((fused - composed).abs().max() / composed.abs().max().clamp(min=1e-12))
        # one recurrence with its fp32 sums in another order
        assert rel < 1e-4, f"rel err {rel}"
        return {"rel_err": rel}

    sweep.run("emd_fused_vs_composed", check_emd_cost)

    def check_emd_eval():
        g = put(_clouds(rng, (b_eval, n_eval_emd, 3), "uniform"))
        o = put(_clouds(rng, (b_eval, n_eval_emd, 3), "blobs"))
        v = float(losses.earth_mover_eval(g, o))
        ref = float(ops.match_cost(g, o, ops.approx_match(g, o)).mean() / n_eval_emd)
        rel = abs(v - ref) / max(abs(ref), 1e-12)
        assert rel < 1e-4, f"rel err {rel} ({v} vs {ref})"
        return {"rel_err": rel}

    sweep.run("emd_eval_vs_composed", check_emd_eval)

    # ---- the train EMD: value and gradients --------------------------------
    def check_emd_diff():
        x1 = put(_clouds(rng, (2, n_emd // 4, 3), "uniform"))
        x2 = put(_clouds(rng, (2, n_emd // 2, 3), "uniform"))
        plan = ops.approx_match(x1, x2)

        def value_grads(f):
            a, b = x1.clone().requires_grad_(), x2.clone().requires_grad_()
            v = f(a, b).sum()
            return float(v.detach()), torch.autograd.grad(v, (a, b))

        v1, g1 = value_grads(ops.approx_match_cost_diff)
        v2, g2 = value_grads(lambda a, b: ops.match_cost(a, b, plan))
        rel = abs(v1 - v2) / max(abs(v2), 1e-12)
        assert rel < 1e-5, f"value rel err {rel}"
        gerr = max(float((a - b).abs().max()) for a, b in zip(g1, g2))
        # relative to the gradient's scale: both paths sum thousands of fp32
        # exp/mul/add chains over 10 levels in different orders
        gscale = max(float(g.abs().max()) for g in g2)
        grel = gerr / max(gscale, 1e-12)
        assert grel < 2e-4, f"grad rel err {grel} (abs {gerr}, scale {gscale})"
        return {"value_rel_err": rel, "max_grad_err": gerr, "grad_rel_err": grel}

    sweep.run("emd_diff_value_and_grad", check_emd_diff)

    # ---- the auction: noised-permutation recovery, the 4096 contract -------
    def noised_permutation(b, n):
        x1 = _clouds(rng, (b, n, 3), "uniform")
        perms = np.stack([rng.permutation(n) for _ in range(b)])
        x2 = np.take_along_axis(x1, perms[..., None], axis=1)
        return x1, (x2 + 1e-4 * rng.randn(b, n, 3)).astype(np.float32), perms

    def check_auction():
        # the reference op's own acceptance test (tf_auctionmatch.py:40-50):
        # each point pairs with its noised twin
        n, b = (64 if args.tiny else 256), 2
        x1, x2, perms = noised_permutation(b, n)
        ml, mr = (host(v) for v in ops.auction_match(put(x1), put(x2)))
        for bi in range(b):
            assert sorted(ml[bi]) == list(range(n)), "matchl not a permutation"
            np.testing.assert_array_equal(mr[bi][ml[bi]], np.arange(n))
        matched = np.take_along_axis(x2, ml[..., None].astype(np.int64), axis=1)
        mean_d = float(np.mean(np.linalg.norm(x1 - matched, axis=-1)))
        assert mean_d < 5e-4, f"mean matched dist {mean_d} >> noise"
        recovered = float(np.mean(ml == np.argsort(perms, axis=-1)))
        assert recovered > 0.99, f"recovered only {recovered:.1%} of the permutation"
        return {"mean_matched_dist": mean_d, "recovered_frac": recovered}

    sweep.run("auction_noised_permutation", check_auction)

    def check_auction_4096():
        # the reference op refuses n > 4096 and n != m
        # (tf_auctionmatch.cpp:37-41); time it at that ceiling
        n = 128 if args.tiny else 4096
        for shapes in (((1, 4097, 3), (1, 4097, 3)), ((1, 64, 3), (1, 65, 3))):
            try:
                ops.auction_match(torch.zeros(shapes[0], device=dev),
                                  torch.zeros(shapes[1], device=dev))
            except ValueError:
                continue
            raise AssertionError(f"auction_match took {shapes}")
        x1, x2, _ = noised_permutation(1, n)
        a, b = put(x1), put(x2)
        ops.auction_match(a[:, :64], b[:, :64])  # first call
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ml = host(ops.auction_match(a, b)[0])
        ms = (time.perf_counter() - t0) * 1e3
        assert sorted(ml[0]) == list(range(n)), "matchl not a permutation"
        matched = np.take_along_axis(x2, ml[..., None].astype(np.int64), axis=1)
        mean_d = float(np.mean(np.linalg.norm(x1 - matched, axis=-1)))
        assert mean_d < 5e-4, f"mean matched dist {mean_d} >> noise"
        return {"n": n, "ms": round(ms, 1), "mean_matched_dist": mean_d}

    sweep.run("auction_4096_contract_timing", check_auction_4096)

    # ---- ball query + three_nn vs numpy ------------------------------------
    def check_grouping_interp():
        b, n, m, k, radius = 2, 128, 32, 16, 0.25
        pts = _clouds(rng, (b, n, 3), "blobs")
        qs = _clouds(rng, (b, m, 3), "uniform")
        idx, cnt = (host(v) for v in ops.query_ball_point(radius, k, put(pts), put(qs)))
        d = np.maximum(np.sqrt(((qs[:, :, None] - pts[:, None]) ** 2).sum(-1)), 1e-20)
        for bi in range(b):
            for qi in range(m):
                hits = np.nonzero(d[bi, qi] < radius)[0]
                c = min(len(hits), k)
                assert cnt[bi, qi] == c, f"cnt {cnt[bi, qi]} vs {c}"
                first = hits[0] if len(hits) else 0
                want = list(hits[:c]) + [first] * (k - c)
                assert list(idx[bi, qi]) == want, "ball idx row mismatch"
        dist3, idx3 = ops.three_nn(put(qs), put(pts))
        dist3, idx3 = host(dist3).astype(np.float64), host(idx3).astype(np.int64)
        d2 = ((qs.astype(np.float64)[:, :, None] - pts.astype(np.float64)[:, None]) ** 2).sum(-1)
        err = float(np.abs(dist3 - np.sort(d2, axis=-1)[..., :3]).max())
        assert err < 1e-5, f"three_nn dist err {err}"
        rerr = float(np.abs(np.take_along_axis(d2, idx3, axis=-1) - dist3).max())
        assert rerr < 1e-5, f"three_nn idx does not realize dist ({rerr})"
        return {"ball_rows": b * m, "three_nn_max_err": err}

    sweep.run("ball_query_three_nn_vs_numpy", check_grouping_interp)

    from rfnet_tpu_torch.train import TrainConfig, create_state, train_step

    def model_config():
        if args.tiny:
            return TrainConfig(batch_size=4, innum=64, ptnum=128, n_seed=4, up_ratio=4)
        return TrainConfig()

    # ---- export artifact: save -> load -> run ------------------------------
    def check_export_roundtrip():
        from rfnet_tpu_torch.export import export_forward, load_forward, save_exported

        config = model_config()
        model = create_state(config, dev).model.eval()
        exported = export_forward(model, 2, config.innum)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "rfnet.pt2")
            nbytes = save_exported(exported, path)
            served = load_forward(path)
            x = put(_clouds(rng, (2, config.innum, 3), "uniform"))
            y_art = served(x)
            with torch.no_grad():
                y_live = model(x).out4
            err = float((y_art - y_live).abs().max())
        # one trace, one device: equal expected; the bound covers kernel
        # selection by the loaded program
        assert err < 1e-6, f"artifact vs live err {err}"
        return {"bytes": nbytes, "max_err": err}

    sweep.run("export_roundtrip", check_export_roundtrip)

    # ---- model forward + parameter golden + train steps --------------------
    def check_model_and_step():
        config = model_config()
        state = create_state(config, dev)
        n_params = sum(p.numel() for p in state.model.parameters())
        if not args.tiny:  # the golden holds for the flagship widths only
            assert n_params == 3_827_611, f"param count {n_params}"
        b = 2 if args.tiny else 4
        partial = put(_clouds(rng, (b, config.innum, 3), "uniform"))
        gt = put(_clouds(rng, (b, config.ptnum, 3), "uniform"))
        with torch.no_grad():
            out4 = state.model(partial).out4
        assert out4.shape == (b, config.ptnum, 3), f"forward shape {tuple(out4.shape)}"
        assert bool(torch.isfinite(out4).all()), "non-finite forward output"
        n1, n2 = 2 * config.n_seed, 2 * config.n_seed * config.up_ratio
        tot = [float(train_step(state, partial, gt, n1=n1, n2=n2)[0].total) for _ in range(3)]
        assert all(np.isfinite(tot)), f"non-finite losses {tot}"
        assert tot[-1] < tot[0], f"loss did not decrease over 3 steps: {tot}"
        return {"param_count": n_params, "losses": [round(t, 4) for t in tot]}

    sweep.run("model_forward_and_train_step", check_model_and_step)

    info = device_info(dev)
    artifact = {
        "ok": sweep.ok,
        "device": {k: info[k] for k in ("name", "power_limit_w", "count")},
        "nvidia_smi": info["smi"],
        "torch": torch.__version__,
        "tiny": bool(args.tiny),
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "checks": sweep.results,
    }
    if dev.type == "cuda" and not args.tiny and args.only is None:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}", flush=True)
    print(json.dumps({"ok": sweep.ok, "passed": sum(r["ok"] for r in sweep.results.values()),
                      "total": len(sweep.results)}), flush=True)
    return 0 if sweep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

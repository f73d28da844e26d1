"""One-command parity drill with the PyTorch port: train → best checkpoint
→ eval → compare. The counterpart of ``tools/protocol_drive.py``.

    python tools/protocol_drive_torch.py \\
        --train_path dense_data/train.lmdb --val_path dense_data/valid.lmdb \\
        --list_path dense_data/test.list --data_dir dense_data/test \\
        --baseline_csv reference/results/recon/results.csv \\
        --steps 300000 --workdir run_pcn/modelvv_recon
    python tools/protocol_drive_torch.py --synthetic --steps 4 --ckpt_every 2 \\
        --workdir runs/modelvv_recon --results_dir runs/results

Stages, each in its own interpreter with the repository on ``PYTHONPATH``,
so a failure in one leaves the files of the earlier ones on disk and a rerun
resumes from the newest checkpoint:

  1. ``python -m rfnet_tpu_torch.train`` for ``--steps``: checkpoints in
     ``--workdir``, the best-by-eval-CD record in ``<workdir>/../bestrecord``,
     the logs in ``<workdir>/../logs`` (the JAX CLI writes ``./logs``);
  2. ``python -m rfnet_tpu_torch.eval --checkpoint <workdir>/../bestrecord``
     over the test list, writing ``<results_dir>/results.csv`` (``id,cd,emd``);
  3. ``tools/compare_results.py`` against ``--baseline_csv``: exit 0 where
     the overall mean CD is within ``--tolerance`` (its default, 1 %).

``--synthetic`` trains on synthetic clouds and serves a 3-model fixture of
random clouds written beside ``--results_dir``. ``--device`` (cuda unless
cpu is asked for) goes to both CLIs. A failed stage ends the drive with a
non-zero exit naming it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

FIXTURE_IDS = ("0001/a", "0001/b", "0002/c")


def _run(label: str, cmd: list[str]) -> None:
    print(f"[protocol_drive_torch] {label}: {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, env=env)
    if r.returncode != 0:
        sys.exit(f"[protocol_drive_torch] {label} failed with exit {r.returncode}")


def write_fixture(root: str) -> tuple[str, str]:
    """The ``--synthetic`` eval fixture: 3 models of uniform random clouds
    (3000 partial, 16384 complete points, ``RandomState(0)``) under
    ``root``. Returns (list path, data directory)."""
    import numpy as np

    from rfnet_tpu_torch.data.pcd_io import save_pcd

    rng = np.random.RandomState(0)
    data = os.path.join(root, "data")
    for mid in FIXTURE_IDS:
        for kind, n in (("partial", 3000), ("complete", 16384)):
            path = os.path.join(data, kind, mid + ".pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_pcd(path, rng.rand(n, 3).astype(np.float32))
    lst = os.path.join(root, "test.list")
    with open(lst, "w") as f:
        f.write("\n".join(FIXTURE_IDS))
    return lst, data


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--train_path", default="../../dense_data/train.lmdb")
    p.add_argument("--val_path", default="../../dense_data/valid.lmdb")
    p.add_argument("--list_path", default="../../dense_data/test.list")
    p.add_argument("--data_dir", default="../../dense_data/test")
    p.add_argument("--baseline_csv", default=None,
                   help="reference results.csv to compare against; omit to skip stage 3")
    p.add_argument("--steps", type=int, default=300_000)
    p.add_argument("--ckpt_every", type=int, default=None)
    p.add_argument("--workdir", default="./modelvv_recon")
    p.add_argument("--results_dir", default="results/recon")
    p.add_argument("--tolerance", type=float, default=None,
                   help="compare_results CD band in percent (its default: 1%%)")
    p.add_argument("--synthetic", action="store_true",
                   help="smoke mode: generated data end to end")
    p.add_argument("--skip_train", action="store_true",
                   help="evaluate an existing bestrecord only")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu, for both CLIs")
    p.add_argument("--train_extra", nargs=argparse.REMAINDER, default=[],
                   help="extra args forwarded verbatim to rfnet_tpu_torch.train")
    args = p.parse_args(argv)

    py = [sys.executable, "-m"]
    root = os.path.dirname(os.path.abspath(args.workdir))
    best_dir = os.path.join(root, "bestrecord")

    if not args.skip_train:
        cmd = py + ["rfnet_tpu_torch.train", "--workdir", args.workdir,
                    "--steps", str(args.steps), "--device", args.device]
        if args.ckpt_every:
            cmd += ["--ckpt_every", str(args.ckpt_every)]
        if args.synthetic:
            cmd += ["--synthetic"]
        else:
            cmd += ["--train_path", args.train_path, "--val_path", args.val_path]
        cmd += args.train_extra
        _run("train", cmd)
        print(f"[protocol_drive_torch] training logs in {os.path.join(root, 'logs')}")
    if not os.path.isfile(os.path.join(best_dir, "model.pt")):
        # checked for --skip_train too: the eval CLI would serve random weights
        sys.exit(f"[protocol_drive_torch] no best checkpoint at {best_dir}")

    cmd = py + ["rfnet_tpu_torch.eval", "--checkpoint", best_dir,
                "--results_dir", args.results_dir, "--device", args.device]
    if args.synthetic:
        lst, data = write_fixture(os.path.join(os.path.dirname(args.results_dir) or ".",
                                               "protocol_fixture"))
        cmd += ["--list_path", lst, "--data_dir", data]
    else:
        cmd += ["--list_path", args.list_path, "--data_dir", args.data_dir]
    _run("eval", cmd)

    ours = os.path.join(args.results_dir, "results.csv")
    print(f"[protocol_drive_torch] results at {ours}")
    if args.baseline_csv:
        cmd = [sys.executable, os.path.join(_REPO, "tools", "compare_results.py"), ours,
               args.baseline_csv]
        if args.tolerance is not None:
            cmd += ["--tolerance", str(args.tolerance)]
        _run("compare", cmd)
    else:
        print("[protocol_drive_torch] done (no baseline given)")


if __name__ == "__main__":
    main()

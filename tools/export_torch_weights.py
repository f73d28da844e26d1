"""Export the converged JAX weights in a form the PyTorch port loads without
JAX, and the JAX eval CLI's results on them as the port's reference.

    python tools/export_torch_weights.py

Runs where the JAX package runs (on the CPU is enough). It

1. loads ``run_r4/bestrecord`` (the best record, step 105000) with
   ``rfnet_tpu.eval.load_state`` (orbax, with the legacy shared-bias
   fallback), flattens ``params["params"]`` with the port's
   ``flatten_params`` and writes ``weights/rfnet_r4_105000.npz``:
   uncompressed, every leaf float32 under its flax path, plus ``__step__``
   and ``__cd__`` (the record's ``best.json``);
2. dumps the first 16 clouds of ``synthetic_pairs(64, seed=1234)`` in the
   PCN layout with ``tools/make_synthetic_evalset.py`` and runs the JAX eval
   CLI on them on the CPU (``JAX_PLATFORMS=cpu python -m rfnet_tpu.eval
   --batch_size 4``), keeping its ``results.csv`` as
   ``weights/rfnet_r4_105000.jax_cpu.csv``. ``chip_smoke.py`` holds the
   port's serving of the npz on the card to that CSV;
3. runs the same eval with ``--bf16`` (bfloat16 feature MLPs) and keeps its
   CSV as ``weights/rfnet_r4_105000.jax_cpu_bf16.csv``, the reference of
   the port's ``--bf16`` serving.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RECORD = os.path.join(REPO, "run_r4", "bestrecord")
OUT = os.path.join(REPO, "weights")
STEM = "rfnet_r4_105000"
NUM_CLOUDS = 16


def export_npz(path: str) -> int:
    """Write the record's params as a flat npz; returns the parameter count."""
    import jax

    from rfnet_tpu.eval import load_state
    from rfnet_tpu.train import TrainConfig
    from rfnet_tpu_torch.compat.convert import flatten_params

    with open(os.path.join(RECORD, "best.json")) as f:
        best = json.load(f)
    state = load_state(RECORD, TrainConfig())
    step = int(jax.device_get(state.step))
    if step != best["step"]:
        raise SystemExit(f"{RECORD}: restored step {step}, best.json says {best['step']}")
    flat = flatten_params(jax.device_get(state.params["params"]))
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}
    np.savez(path, __step__=np.int64(step), __cd__=np.float64(best["cd"]), **arrays)
    return sum(a.size for a in arrays.values())


def export_csv(path: str, bf16: bool = False) -> None:
    """The JAX eval CLI's results.csv over the first NUM_CLOUDS clouds, with
    bfloat16 feature MLPs where ``bf16``."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synthetic_evalset.py"),
                        "--out", tmp, "--num", str(NUM_CLOUDS), "--pcn_layout"],
                       check=True, cwd=REPO)
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        subprocess.run([sys.executable, "-m", "rfnet_tpu.eval", "--checkpoint", RECORD,
                        "--list_path", os.path.join(tmp, "test.list"),
                        "--data_dir", os.path.join(tmp, "data"),
                        "--results_dir", os.path.join(tmp, "results"),
                        "--batch_size", "4", *(["--bf16"] if bf16 else [])],
                       check=True, cwd=REPO, env=env)
        shutil.copyfile(os.path.join(tmp, "results", "results.csv"), path)


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    npz = os.path.join(OUT, STEM + ".npz")
    n = export_npz(npz)
    print(f"wrote {npz}: {n} parameters, {os.path.getsize(npz)} bytes")
    csv_path = os.path.join(OUT, STEM + ".jax_cpu.csv")
    export_csv(csv_path)
    print(f"wrote {csv_path}")
    bf16_path = os.path.join(OUT, STEM + ".jax_cpu_bf16.csv")
    export_csv(bf16_path, bf16=True)
    print(f"wrote {bf16_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

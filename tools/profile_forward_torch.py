"""Stage-level timing of the port's full-width forward on one CUDA card (the
counterpart of ``tools/profile_forward.py``).

    python3 tools/profile_forward_torch.py [--trained] [--iters 10]
    python3 tools/profile_forward_torch.py --device cpu --tiny   # logic smoke

Times each stage of ``RFNet.forward`` alone at batch 32, on
``RandomState(0)`` inputs of the stage's shape (``_common_torch.timeit``:
one first call, 2 warm-ups, ``--iters`` calls between CUDA events), then
the whole forward: where a forward's milliseconds go. The stages are the
JAX tool's: the 32-pick FPS, the shared encode cell on the partial alone
and beside 1024 points, the first recover cell, the two decode steps, the
merge layer at each of its three sizes, the last two refine layers, and the
dense NN both ways between the partial and a completion. Each runs once a
forward, except the encode cell (once a step, on 3000, 3064 and 4024
points) and the merge and the refine layers (once a size). ``--trained``
loads the converged weights (``weights/rfnet_r4_105000.npz``), which change
what the merge layers reroute and nothing else of a stage's work; the
default is the random init ``train.create_state`` draws. Without
``--device cpu`` a missing card is an error. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools._common_torch import TINY, WEIGHTS, device_info, resolve_device  # noqa: E402
from tools._common_torch import timeit, tool_model  # noqa: E402

B = 32
TINY_B = 4


def main(argv=None) -> dict:
    from rfnet_tpu_torch.models.rfnet import merge_layer
    from rfnet_tpu_torch.ops.chamfer import nn_distance
    from rfnet_tpu_torch.ops.fps import farthest_point_sample
    from rfnet_tpu_torch.train import TrainConfig

    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--trained", action="store_true", help="the converged weights")
    p.add_argument("--iters", type=int, default=10, help="timed calls a stage")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="tiny widths (the tests)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = TrainConfig(**TINY) if args.tiny else TrainConfig()
    b = TINY_B if args.tiny else B
    info = device_info(dev)
    print(f"device: {info['smi'] or info['name']}; batch {b}; "
          f"{'converged' if args.trained else 'random-init'} weights", flush=True)
    model = tool_model(config, dev, WEIGHTS if args.trained else None)

    n1, n2 = 2 * config.n_seed, 2 * config.n_seed * config.up_ratio
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.from_numpy(rng.rand(b, *shape).astype(np.float32)).to(dev)

    pc, pts1, pts2, pts3 = (rand(n, 3) for n in (config.innum, n1, n2, config.ptnum))
    code = rand(1, 256)
    st1, st2, st3 = (rand(n, 128) for n in (n1, n2, config.ptnum))
    decf = torch.ones(1, device=dev)

    ms = {}

    def stage(name, fn, *fn_args):
        ms[name] = timeit(name, fn, *fn_args, iters=args.iters, device=dev, width=34)

    with torch.inference_mode():
        stage("FULL forward", lambda x: model(x).out4, pc)
        stage(f"fps {config.n_seed}-of-{config.innum}",
              lambda x: farthest_point_sample(config.n_seed, x), pc)
        # step 0 picks the first per-step bias row (StepDense): the weights
        # are shared, so a stage costs the same at every step
        stage(f"encode_cell @{config.innum}", lambda x, s: model.cell(x, s, 0), pc, code)
        stage(f"encode_cell @{config.innum + n2}", lambda x, s: model.cell(x, s, 0),
              torch.cat([pc, pts2], dim=1), code)
        stage(f"recover @{config.innum}", model.recover1, code, pc)
        stage(f"decode {n1}->{n2}", lambda c, ce, s: model.decode_cell(c, ce, s, 0),
              code, pts1, st1)
        stage(f"decode {n2}->{config.ptnum}", lambda c, ce, s: model.decode_cell(c, ce, s, 1),
              code, pts2, st2)
        for pts in (pts1, pts2, pts3):
            stage(f"merge @{pts.shape[1]}", merge_layer, pc, pts, decf)
        stage(f"refine @{n2}", model.refine_layer2, pts2, code, st2)
        stage(f"refine @{config.ptnum}", model.refine_layer_final, pts3, code, st3)
        stage(f"nn_distance {config.innum}v{config.ptnum} both", nn_distance, pc, pts3)
    print(f"{'(full measured above)':34s}: {ms['FULL forward']:8.3f} ms", flush=True)
    return ms


if __name__ == "__main__":
    main()

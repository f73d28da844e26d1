"""The port's train step split into components, each timed alone on one
CUDA card (the counterpart of ``tools/profile_trainstep.py``).

    python3 tools/profile_trainstep_torch.py [--trained] [--iters 10]
    python3 tools/profile_trainstep_torch.py --device cpu --tiny   # logic smoke

Components at batch 32 and full width, on ``RandomState(0)`` clouds,
timed with ``_common_torch.timeit`` (one first call, 2 warm-ups,
``--iters`` calls between CUDA events):

  fwd            the model's forward, 3000 -> 16384 points
  fwd+bwd        forward and backward through a trivial loss (sum of out4²)
  cd34 fwd       chamfer_means_pair(gt, out3, out4): cd3 + cd4, one call
  cd34 f unfus   the same as two chamfer_means calls
  cd34 fb unfus  value and gradients in out3, out4 of the two calls
  cd34 fwd+bwd   value and gradients of the paired call
  emd fwd+bwd    earth_mover(gt1, p1) + earth_mover(gt2, p2) and gradients
  emd64 f+b      the 64-point term alone
  emd1024 f+b    the 1024-point term alone
  recd fwd+bwd   re_chamfer(gt, out3) (8 slices) and its gradient
  fps pyramids   the ground truth's 64- and 1024-point FPS pyramids
  full step      ``train.train_step``: all of the above, zero_groupnear and
                 the Adam update (on a copy of the model's weights)

``--trained`` loads the converged weights (``weights/rfnet_r4_105000.npz``);
the default is the random init ``train.create_state`` draws. The loss terms
run on random clouds here, not on the model's outputs, so their early-exit
scans see the stress regime (``bench_torch.py`` also times them on model
and in-distribution outputs). Without ``--device cpu`` a missing card is an
error. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools._common_torch import TINY, WEIGHTS, device_info, resolve_device  # noqa: E402
from tools._common_torch import grads, timeit, tool_model  # noqa: E402

B = 32
TINY_B = 4


def main(argv=None) -> dict:
    from rfnet_tpu_torch import losses
    from rfnet_tpu_torch.ops.chamfer import chamfer_means, chamfer_means_pair
    from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point
    from rfnet_tpu_torch.train import TrainConfig, create_state, train_step

    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--trained", action="store_true", help="the converged weights")
    p.add_argument("--iters", type=int, default=10, help="timed calls a component")
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

    def rand(n):
        return torch.from_numpy(rng.rand(b, n, 3).astype(np.float32)).to(dev)

    # profile_trainstep.py's draws, in its order
    partial, gt, gt1, gt2, out3, out4, p1, p2 = (
        rand(n) for n in (config.innum, config.ptnum, n1, n2, config.ptnum, config.ptnum,
                          n1, n2))
    params = list(model.parameters())
    ms = {}

    def component(name, fn, *fn_args):
        ms[name] = timeit(name, fn, *fn_args, iters=args.iters, device=dev, width=14)

    with torch.inference_mode():
        component("fwd", lambda x: model(x).out4, partial)
    # the final refine layer's feature head feeds nothing: no gradient
    component("fwd+bwd", lambda x: torch.autograd.grad((model(x).out4 ** 2).sum(), params,
                                                       allow_unused=True), partial)

    def cd34(g, a, c):
        return sum(chamfer_means_pair(g, a, c))

    def cd34_unfused(g, a, c):
        return sum(chamfer_means(g, a)) + sum(chamfer_means(g, c))

    with torch.no_grad():
        component("cd34 fwd", cd34, gt, out3, out4)
        component("cd34 f unfus", cd34_unfused, gt, out3, out4)
    component("cd34 fb unfus", lambda a, c: grads(lambda x, y: cd34_unfused(gt, x, y), a, c),
              out3, out4)
    component("cd34 fwd+bwd", lambda a, c: grads(lambda x, y: cd34(gt, x, y), a, c),
              out3, out4)
    component("emd fwd+bwd", lambda a, c: grads(
        lambda x, y: losses.earth_mover(gt1, x) + losses.earth_mover(gt2, y), a, c), p1, p2)
    component(f"emd{n1} f+b", lambda a: grads(lambda x: losses.earth_mover(gt1, x), a), p1)
    component(f"emd{n2} f+b", lambda c: grads(lambda y: losses.earth_mover(gt2, y), c), p2)
    component("recd fwd+bwd", lambda a: grads(lambda x: losses.re_chamfer(gt, x, part=8), a),
              out3)
    component("fps pyramids", lambda g: (gather_point(g, farthest_point_sample(n1, g)),
                                         gather_point(g, farthest_point_sample(n2, g))), gt)
    state = create_state(config, dev)
    state.model.load_state_dict(model.state_dict())
    component("full step", lambda x, g: train_step(state, x, g, n1=n1, n2=n2)[0].total,
              partial, gt)
    return ms


if __name__ == "__main__":
    main()

"""Farthest point sampling + gather (port of ``rfnet_tpu/ops/fps.py``).

Semantics of the reference ``FarthestPointSample`` / ``GatherPoint`` ops:
  * the first selected index is always 0;
  * each later pick is the argmax of the running minimum squared distance to
    the selected set, initialised to 1e38, the lowest index winning ties;
  * ``farthest_point_sample`` has no gradient; ``gather_point``'s gradient is
    autograd's scatter-add into the source cloud.

A CUDA tensor goes through kernel K1 (``csrc/fps.cu``); a CPU tensor through
the plain loop :func:`_fps_plain`, which computes the same distances in the
same order, so both give identical indices.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch import kernels

# K1 keeps 4 bytes a point in shared memory: 232 448 bytes a block, less its
# 272 bytes of static shared memory
_FPS_MAX_POINTS = (232_448 - 272) // 4


def _fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (b, npoint) int32; mirrors ``_fps_single`` batched."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    mind = torch.full((b, n), 1e38, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(npoint - 1):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(mind, dim=1)  # first (lowest) index of the max
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    b, n, _ = xyz.shape
    if n > _FPS_MAX_POINTS:
        raise ValueError(f"FPS kernel takes at most {_FPS_MAX_POINTS} points a cloud, got {n}")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    kernels.launch("fps", xyz.device, xyz, b, n, npoint, idx)
    return idx


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """(b, n, 3) float32 -> (b, npoint) int32 sample indices. Not differentiable."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"expected (b, n, 3) float32 points, got {tuple(xyz.shape)} {xyz.dtype}")
    if npoint < 1:
        raise ValueError(f"npoint must be >= 1, got {npoint}")
    xyz = xyz.detach().contiguous()
    if xyz.is_cuda:
        return _fps_cuda(xyz, npoint)
    if xyz.device.type != "cpu":
        raise ValueError(f"unsupported device {xyz.device}")
    return _fps_plain(xyz, npoint)


def gather_point(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (b, n, 3) at (b, npoint) -> (b, npoint, 3); grad scatter-adds."""
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, xyz.shape[-1]))


def sampling(npoint: int, xyz: torch.Tensor, use_type: str = "f", *,
             generator: torch.Generator | None = None):
    """Reference ``sampling`` helper: (idx (b, npoint) int32, points).

    'f' is farthest point sampling; 'r' one random index subset shared by
    every cloud of the batch (the reference shuffles a single index vector
    and tiles it across the batch), drawn from ``generator``, which takes the
    place of the JAX function's PRNG key and is required as the key is.
    """
    if use_type == "f":
        idx = farthest_point_sample(npoint, xyz)
        return idx, gather_point(xyz, idx)
    if use_type == "r":
        if generator is None:
            raise ValueError("random sampling requires an explicit torch.Generator")
        perm = torch.randperm(xyz.shape[1], generator=generator, device=generator.device)
        idx = perm[:npoint].to(device=xyz.device, dtype=torch.int32)
        idx = idx[None, :].expand(xyz.shape[0], npoint).contiguous()
        return idx, gather_point(xyz, idx)
    raise ValueError(f"unknown sampling type: {use_type!r}")

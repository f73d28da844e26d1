"""Farthest point sampling + gather (port of ``rfnet_tpu/ops/fps.py``).

Semantics of the reference ``FarthestPointSample`` / ``GatherPoint`` ops:
  * the first selected index is always 0;
  * each later pick is the argmax of the running minimum squared distance to
    the selected set, initialised to 1e38, the lowest index winning ties;
  * ``farthest_point_sample`` has no gradient; ``gather_point``'s gradient is
    autograd's scatter-add into the source cloud.

A CUDA tensor goes through kernel K1 (``csrc/fps.cu``), at any number of
points, as the custom operator ``rfnet::fps`` (so an exported forward holds
the kernel); a CPU tensor through the plain loop :func:`_fps_plain`, which
computes the same distances in the same order, so both give identical
indices.
"""

from __future__ import annotations

import functools

import torch

from rfnet_tpu_torch import kernels

# K1 takes a cloud in a cluster of up to 4 CTAs of 256 threads (up to 8
# where 4 cannot hold it), each thread holding up to 32 points in registers
# (the register forms the kernel has); a larger cloud takes the streaming
# form
_FPS_CLUSTER = 4
_FPS_MAX_CLUSTER = 8
_FPS_THREADS = 256
_FPS_PER_THREAD = (1, 2, 4, 8, 16, 32)


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


def _fps_plan(b: int, n: int, sms: int) -> tuple[int, int]:
    """K1's launch for ``b`` clouds of ``n`` points on a card with ``sms``
    SMs: (CTAs a cloud, points a thread in registers, 0 for the streaming
    form).

    The cluster is the largest power of two up to 4 whose ``b`` clusters
    take at most half the SMs, halved while half of it would give every
    thread a point; it grows again, up to 8, until the cloud fits in
    registers, and a cloud that does not fit 8 CTAs streams. (On an H100 a
    pick's exchange and merge grow with the cluster faster than its pass
    over the points shrinks: at (32, 16384) -> 1024, two CTAs a cloud beat
    four and eight.)"""
    cluster = _FPS_CLUSTER
    while cluster > 1 and (b * cluster > sms // 2 or cluster // 2 * _FPS_THREADS >= n):
        cluster //= 2
    while True:
        need = -(-n // (cluster * _FPS_THREADS))
        fits = [p for p in _FPS_PER_THREAD if p >= need]
        if fits:
            return cluster, fits[0]
        if cluster == _FPS_MAX_CLUSTER:
            return cluster, 0
        cluster *= 2


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fps_launch(xyz: torch.Tensor, npoint: int, cluster: int, per_thread: int) -> torch.Tensor:
    """Launch K1 on the contiguous CUDA tensor ``xyz`` with this plan."""
    b, n, _ = xyz.shape
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=xyz.device)
               if per_thread == 0 else None)
    kernels.launch("fps", xyz.device, xyz, b, n, npoint, cluster, per_thread, scratch, idx)
    return idx


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """K1 on a CUDA tensor: the body of ``rfnet::fps``. The plan reads the
    batch as a Python int, so it is chosen here, at run time, and never in
    a traced graph."""
    xyz = xyz.contiguous()
    b, n, _ = xyz.shape
    return _fps_launch(xyz, npoint, *_fps_plan(b, n, _sm_count(xyz.device)))


def _fps_fake(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


kernels.define_op("fps(Tensor xyz, int npoint) -> Tensor", _fps_cuda, _fps_fake)


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """(b, n, 3) float32 -> (b, npoint) int32 sample indices. Not differentiable."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"expected (b, n, 3) float32 points, got {tuple(xyz.shape)} {xyz.dtype}")
    if npoint < 1:
        raise ValueError(f"npoint must be >= 1, got {npoint}")
    xyz = xyz.detach().contiguous()
    if xyz.is_cuda:
        return torch.ops.rfnet.fps(xyz, npoint)
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

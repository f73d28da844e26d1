"""Infinite synthetic training data generated on the device.

Port of ``rfnet_tpu/data/online.py``: the distribution of
``data.dataset.synthetic_pairs`` (a mixture of ``NUM_BLOBS`` gaussian blobs,
the half of it on the far side of a random view, a uniform ``innum``-subset
of that half), generated where the model runs, so a train step copies no
batch from the host.

The JAX package folds the step into a PRNG key; PyTorch cannot reproduce
that stream, so here a batch is a pure function of (seed, step) through a
``torch.Generator`` on the batch's device seeded from both. The same
(seed, step, device) gives the same batch bit for bit, in any process, so a
run resumed at step S regenerates the batches a straight-through run would
have seen from S. The values differ from JAX's; the distribution is the same.
"""

from __future__ import annotations

from collections.abc import Iterator

import torch

NUM_BLOBS = 8
BLOB_SCALE = 0.3
NOISE_SCALE = 0.08


def _stream_seed(seed: int, step: int) -> int:
    """One generator seed for (seed, step): splitmix64 of ``seed`` and
    ``step`` in the high and low 32 bits, a bijection, so every (seed, step)
    below 2**32 each has its own seed (the CPU generator keeps the low 32
    bits, which the mix spreads over all of them)."""
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _take_best(keys: torch.Tensor, pts: torch.Tensor, k: int) -> torch.Tensor:
    """Rows of ``pts`` (b, n, 3) holding the ``k`` largest ``keys`` (b, n),
    largest first."""
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))


def synthetic_batch(seed: int, step: int, batch: int, innum: int, ptnum: int,
                    device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
    """One (partial (b, innum, 3), gt (b, ptnum, 3)) float32 batch, made on
    ``device``: gt = blob mixture; partial = a uniform ``innum``-subset,
    drawn without replacement by ranking uniforms, of the ``ptnum // 2``
    points of gt with the largest projection onto a random view."""
    if innum > ptnum // 2:
        raise ValueError(
            f"synthetic_batch needs innum <= ptnum//2 (got innum={innum}, "
            f"ptnum={ptnum}); the half-space crop keeps only ptnum//2 points"
        )
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(_stream_seed(seed, step))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    centers = BLOB_SCALE * torch.randn((batch, NUM_BLOBS, 3), **f32)
    which = torch.randint(0, NUM_BLOBS, (batch, ptnum), device=device, generator=g)
    gt = torch.gather(centers, 1, which[..., None].expand(-1, -1, 3))
    gt = gt + NOISE_SCALE * torch.randn((batch, ptnum, 3), **f32)
    view = torch.randn((batch, 1, 3), **f32)
    crop = _take_best((gt * view).sum(-1), gt, ptnum // 2)
    u = torch.rand((batch, ptnum // 2), **f32)
    return _take_best(u, crop, innum), gt


def batch_stream(seed: int, start_step: int, batch: int, innum: int, ptnum: int,
                 device: torch.device | str) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """The batches of steps ``start_step``, ``start_step + 1``, … ."""
    step = start_step
    while True:
        yield synthetic_batch(seed, step, batch, innum, ptnum, device)
        step += 1

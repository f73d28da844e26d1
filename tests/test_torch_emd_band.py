"""What K6's wrapper and skip rule do around the kernel, on the CPU.

The kernel (``csrc/emd_cost.cu``) runs only on a card; its sorts, boxes, skip
rule and weights are plain PyTorch in ``rfnet_tpu_torch/ops/emd.py`` and are
held here to the recurrence and to the JAX package's ``approx_match_cost`` on
the same numpy inputs. The bar is the kernel's own: rtol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfnet_tpu.ops import emd as jemd
from rfnet_tpu_torch.ops import emd
from rfnet_tpu_torch.ops.chamfer import _tile_boxes

RTOL = 2e-4


def _clouds(seed, n, m, b=2, extent=1.0, blobs=0):
    """Two (b, ·, 3) float32 clouds: uniform in a cube of ``extent``, or
    ``blobs`` Gaussian blobs of width 0.02·extent around centres in it."""
    rng = np.random.RandomState(seed)

    def one(k):
        if not blobs:
            return (extent * rng.rand(b, k, 3)).astype(np.float32)
        centres = extent * rng.rand(b, blobs, 3)
        pick = rng.randint(0, blobs, (b, k))
        pts = np.take_along_axis(centres, pick[..., None].repeat(3, -1), 1)
        return (pts + 0.02 * extent * rng.randn(b, k, 3)).astype(np.float32)

    return one(n), one(m)


@pytest.mark.parametrize("n,m,extent,blobs", [(300, 300, 1.0, 0), (520, 200, 2.0, 5),
                                              (130, 400, 0.04, 0)])
def test_cost_of_sorted_clouds_equals_unsorted_and_jax(n, m, extent, blobs):
    """The wrapper hands K6 Morton-sorted clouds: the cost is a sum over all
    pairs, so sorting moves it only by the order of fp32 sums."""
    x1, x2 = _clouds(0, n, m, extent=extent, blobs=blobs)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    s1, boxes1 = emd._sorted_with_boxes(t1)
    s2, _ = emd._sorted_with_boxes(t2)
    assert boxes1.shape == (2, -(-n // emd._TILE), 6)
    # a permutation of the same points
    np.testing.assert_array_equal(np.sort(s1.numpy(), axis=1), np.sort(x1, axis=1))
    unsorted = emd._approx_match_cost_plain(t1, t2).numpy()
    np.testing.assert_allclose(emd._approx_match_cost_plain(s1, s2).numpy(), unsorted, rtol=RTOL)
    want = np.asarray(jemd.approx_match_cost(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(emd._approx_match_cost_plain(s1, s2).numpy(), want, rtol=RTOL)


def _pairs_of_tiles(x, tile):
    """(b, t, tile) index of every point's tile slot, padded with -1."""
    n = x.shape[1]
    t = -(-n // tile)
    idx = torch.full((t * tile,), -1, dtype=torch.long)
    idx[:n] = torch.arange(n)
    return idx.view(t, tile)


@pytest.mark.parametrize("level", emd._levels())
@pytest.mark.parametrize("direction", ["row", "col"])
def test_skipped_tile_pairs_have_weight_exactly_zero(level, direction):
    """Every (64-point, 128-point) tile pair the rule skips holds only pairs
    whose weight, as the kernel takes it from the expansion d², is exactly 0:
    skipping is no approximation. The weight before the flush is under
    2^-126 there, and exp(λ·d²) itself under 1e-37."""
    x1, x2 = _clouds(1, 700, 450, extent=3.0, blobs=6)
    a, o = emd._sorted_with_boxes(torch.from_numpy(x1))[0], \
        emd._sorted_with_boxes(torch.from_numpy(x2))[0]
    if direction == "col":
        a, o = o, a
    skips = emd._band_skips(_tile_boxes(a, emd._WARP_TILE), _tile_boxes(o, emd._TILE), level)
    d2 = emd._sq_dists(a, o)  # the expansion, (b, own, other)
    w = emd._kernel_weight(level, d2)
    own_tiles, other_tiles = _pairs_of_tiles(a, emd._WARP_TILE), _pairs_of_tiles(o, emd._TILE)
    worst = 0.0
    for b, i, j in skips.nonzero().tolist():
        rows = own_tiles[i][own_tiles[i] >= 0]
        cols = other_tiles[j][other_tiles[j] >= 0]
        block = w[b][rows][:, cols]
        assert float(block.max()) == 0.0, (level, b, i, j)
        worst = max(worst, float(torch.exp(level * d2[b][rows][:, cols]).max()))
    assert worst < 1e-37
    share = float(skips.float().mean())
    if level <= -64.0:
        assert share > 0.1, (level, share)  # the rule is not vacuous on these clouds
    if level == 0.0:
        assert share == 0.0


def test_small_clouds_skip_nothing_and_far_clouds_everything():
    x1, x2 = _clouds(2, 300, 300, extent=0.04)
    a, o = (emd._sorted_with_boxes(torch.from_numpy(x))[0] for x in (x1, x2))
    assert emd._skipped_shares(a, o) == [0.0] * 10
    # 40 away: beyond sqrt(128 / (0.25 log2 e)) = 18.9, the widest band
    far = emd._skipped_shares(a, o + 40.0)
    assert far[:9] == [1.0] * 9 and far[9] == 0.0
    # a pair just inside the radius is kept: d² = 100/|λ·log2(e)| < 128/...
    box = torch.tensor([[[0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]])
    for level in emd._levels()[:9]:
        r = (100.0 / (-level * 1.4426950408889634)) ** 0.5
        near = box + torch.tensor([r, 0, 0, r, 0, 0], dtype=torch.float32)
        assert not bool(emd._band_skips(box, near, level))
        assert bool(emd._band_skips(box, box + torch.tensor([2 * r, 0, 0, 2 * r, 0, 0]), level))


@pytest.mark.parametrize("n,m,extent,blobs", [(300, 300, 1.0, 0), (400, 250, 2.0, 5),
                                              (200, 330, 0.04, 0)])
def test_kernel_weights_keep_the_cost_within_the_bar(n, m, extent, blobs):
    """The recurrence run with K6's weights — 2^(λ·log2(e)·d²) flushed below
    2^-126, and (w²)² of the next level's weight in delta — stays within the
    bar of the recurrence with exp, and of the JAX function."""
    x1, x2 = _clouds(3, n, m, extent=extent, blobs=blobs)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    model = emd._approx_match_cost_plain(t1, t2, emd._kernel_weight,
                                         emd._kernel_delta_weight).numpy()
    np.testing.assert_allclose(model, emd._approx_match_cost_plain(t1, t2).numpy(), rtol=RTOL)
    want = np.asarray(jemd.approx_match_cost(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(model, want, rtol=RTOL)


def test_pow4_of_the_next_levels_weight_is_this_levels_weight():
    d2 = torch.from_numpy(np.random.RandomState(4).rand(4096).astype(np.float32)) * 0.02
    for level in emd._levels()[:8]:
        direct = emd._kernel_weight(level, d2)
        pow4 = emd._kernel_delta_weight(level, d2)
        big = direct > 1e-30
        # four roundings and the argument's: a few ulps wherever the weight counts
        torch.testing.assert_close(pow4[big], direct[big], rtol=1e-5, atol=0)
        assert float(torch.cat([(pow4 - direct).abs()[~big], torch.zeros(1)]).max()) <= 1e-30
    # lambda = -0.25 takes its own exponential, lambda = 0 none
    torch.testing.assert_close(emd._kernel_delta_weight(-0.25, d2),
                               emd._kernel_weight(-0.25, d2), rtol=0, atol=0)
    assert bool((emd._kernel_delta_weight(0.0, d2) == 1).all())

"""Clouds that plant nearest-target ties where K7's and K8's walks
(``csrc/nn_tiles.cuh``) can get them wrong, shared by the card's tests
(``test_torch_gpu.py``) and the CPU model of the walks
(``test_torch_nn_sorted.py``). numpy only."""

import numpy as np


def planted_ties(tile_m: int):
    """(queries (1, 40, 3), target (1, 4 tile_m, 3), the index each query
    must get): nearest targets tied across a tile boundary, with the lower
    index in the tile both K7 and K8 visit later, and exact duplicates
    across a chunk boundary inside one tile.

    Queries 0-19 sit at (0.5, 0.5, 0.5); their two nearest targets lie at
    exactly 0.25 in z, below (index 5, tile 0) and above (index tile_m + 7,
    tile 1). Tile 0 holds only low z (its box's top z 0.25 < 0.5, and its
    bound 0.25² > 0); tile 1 spans the cloud's x/y/z (its box holds the
    queries: bound 0) and is the first whose top z reaches them. So both
    kernels scan tile 1 first, and tile 0's bound then equals the best: only
    the equality test reaches the lower index. Queries 20-39 sit on a point
    copied at indices 2 tile_m + 31 and 2 tile_m + 32 of tile 2 (z 0.9),
    whose lower copy ends the tile's first chunk. Tile 3 is far away."""
    rng = np.random.RandomState(80)
    t = np.empty((4 * tile_m, 3), np.float32)
    t[:tile_m] = np.c_[rng.rand(tile_m, 2), 0.2 * rng.rand(tile_m)]
    t[tile_m:2 * tile_m] = np.c_[rng.rand(tile_m, 2), np.where(
        rng.rand(tile_m) < 0.5, 0.2 * rng.rand(tile_m), 0.8 + 0.2 * rng.rand(tile_m))]
    t[tile_m:tile_m + 2] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]
    t[2 * tile_m:3 * tile_m] = np.c_[rng.rand(tile_m, 2), np.full(tile_m, 0.9)]
    t[3 * tile_m:] = 5.0 + rng.rand(tile_m, 3)
    lo, hi, dup = 5, tile_m + 7, 2 * tile_m + 31
    t[lo], t[hi] = [0.5, 0.5, 0.25], [0.5, 0.5, 0.75]
    t[dup + 1] = t[dup] = [0.3, 0.6, 0.9]
    q = np.concatenate([np.tile(np.float32([0.5, 0.5, 0.5]), (20, 1)),
                        np.tile(t[dup], (20, 1))]).astype(np.float32)
    want = np.array([lo] * 20 + [dup] * 20)
    return q[None], t[None], want

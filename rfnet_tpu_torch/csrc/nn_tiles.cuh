// Pieces shared by the two tile-pruned nearest-neighbour scans, K7
// (nn_pruned.cu) and K8 (nn_tile.cu).
//
// Both scan a sorted target cloud in tiles of `tile_m` consecutive points,
// each tile with an axis-aligned box [lo x y z, hi x y z] over its points
// (computed by the wrapper), one thread per query. Distances are sums of
// squared differences,
//     d = ((qx-tx)^2 + (qy-ty)^2) + (qz-tz)^2,
// each step rounded with no fused multiply-add: the chain of K3 (nn_dyn.cu)
// and of the plain version (ops/chamfer.py:_nn_sorted_plain). The lowest
// target index wins ties, whatever order the tiles are visited in.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace rfnet {

constexpr int kTileThreads = 256;  // most queries a block takes

// Squared distance from a point to a box, rounded as d is. For a target t
// inside the box, lo <= t <= hi on every axis, so where q < lo the rounded
// lo - q is <= the rounded t - q = |q - t| (rounding is monotone and negation
// is exact), likewise q - hi where q > hi, and 0 otherwise; squares of
// non-negative numbers and their sums, taken in d's order, are monotone too.
// So the bound never exceeds the rounded d of any target in the box: no slack.
__device__ __forceinline__ float point_box_bound(float qx, float qy, float qz,
                                                 const float* __restrict__ box) {
  const float gx = fmaxf(fmaxf(__fsub_rn(__ldg(box + 0), qx), __fsub_rn(qx, __ldg(box + 3))), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(__ldg(box + 1), qy), __fsub_rn(qy, __ldg(box + 4))), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(__ldg(box + 2), qz), __fsub_rn(qz, __ldg(box + 5))), 0.f);
  return sq3(gx, gy, gz);
}

// The block copies targets [base, base + cnt) of one cloud into shared memory.
__device__ __forceinline__ void load_tile(float4* __restrict__ tile, const float* __restrict__ t,
                                          int base, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
    const float* p = t + 3 * static_cast<size_t>(base + k);
    tile[k] = make_float4(p[0], p[1], p[2], 0.f);
  }
}

// One query against the tile in shared memory.
__device__ __forceinline__ void scan_tile(const float4* __restrict__ tile, int base, int cnt,
                                          float qx, float qy, float qz, float& best, int& best_j) {
  for (int k = 0; k < cnt; ++k) {
    const float4 p = tile[k];
    const float d = sq3(__fsub_rn(qx, p.x), __fsub_rn(qy, p.y), __fsub_rn(qz, p.z));
    const int j = base + k;
    if (d < best || (d == best && j < best_j)) {
      best = d;
      best_j = j;
    }
  }
}

}  // namespace rfnet

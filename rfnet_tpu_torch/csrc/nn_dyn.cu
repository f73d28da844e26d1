// K3: exact one-sided nearest-neighbour scan over z-sorted clouds, with
// early exit.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer_dyn.py:nn_dyn_pallas
// (body _make_kernel). Contract: both clouds are sorted by z; for every
// query it returns the least squared distance to the target cloud and the
// index (into the sorted target) of the nearest target, the lowest index
// winning ties.
//
// Distances are sums of squared differences,
//     d = ((qx-tx)^2 + (qy-ty)^2) + (qz-tz)^2,
// each step rounded with no fused multiply-add (not the |t|^2 - 2 q.t
// expansion of the TPU kernel). That makes the early exit exact with no
// slack: rounding is monotone and every term is >= 0, so the rounded d of a
// target is >= the rounded g = (qz-tz)^2 computed from the same rounded
// difference, and along a z-sorted cloud g only grows away from the query's
// z. (The expansion's absolute error, about eps*(|q|^2+|t|^2), can exceed a
// relative widening of the bound at small distances; this formulation has no
// such gap.) The plain version (ops/chamfer.py:_nn_sorted_plain) computes
// the same d for every pair, so distances and indices agree bit for bit.
//
// Design: one thread per query, 256 a block, grid (query blocks, b). A thread
// binary-searches its z among the sorted targets' z, then walks outward,
// always taking the side whose frontier gap g is smaller, and stops once
// that gap exceeds its best distance (equality keeps scanning, for ties).
// Neighbouring threads hold neighbouring z-sorted queries, so their walks
// read the same targets through the cache. Bound on the H100: about 9 fp32
// operations a visited pair; the visited pairs are the targets inside each
// query's z-slab of half-width sqrt(best), a data-dependent few percent of
// the dense scan on surface-like clouds.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nn_dyn_kernel(const float* __restrict__ query, const float* __restrict__ target,
              int n, int m, float* __restrict__ dist, int* __restrict__ idx) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* t = target + static_cast<size_t>(b) * m * 3;
  const float* q = query + (static_cast<size_t>(b) * n + i) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];

  // first target with tz >= qz
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t + 3 * mid + 2) < qz) lo = mid + 1;
    else hi = mid;
  }
  int up = lo, dn = lo - 1;
  const float inf = __int_as_float(0x7f800000);
  float best = inf;
  int best_j = 0x7fffffff;
  while (up < m || dn >= 0) {
    float g_up = inf, g_dn = inf;
    if (up < m) {
      const float dz = __fsub_rn(qz, __ldg(t + 3 * up + 2));
      g_up = __fmul_rn(dz, dz);
    }
    if (dn >= 0) {
      const float dz = __fsub_rn(qz, __ldg(t + 3 * dn + 2));
      g_dn = __fmul_rn(dz, dz);
    }
    const bool take_up = up < m && (dn < 0 || g_up <= g_dn);
    const float g = take_up ? g_up : g_dn;
    if (g > best) break;  // every target left on both sides is farther
    const int j = take_up ? up++ : dn--;
    const float dx = __fsub_rn(qx, __ldg(t + 3 * j));
    const float dy = __fsub_rn(qy, __ldg(t + 3 * j + 1));
    // g is this target's rounded (qz-tz)^2, the last term of d
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), g);
    if (d < best || (d == best && j < best_j)) {
      best = d;
      best_j = j;
    }
  }
  const size_t o = static_cast<size_t>(b) * n + i;
  dist[o] = best;
  idx[o] = best_j;
}

}  // namespace

extern "C" int rfnet_nn_dyn(const void* query, const void* target, int b, int n, int m,
                            void* dist, void* idx, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  nn_dyn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n, m,
      static_cast<float*>(dist), static_cast<int*>(idx));
  return cudaGetLastError();
}

// The dense one-sided nearest-neighbour scan shared by K2 (nn_coords.cu) and
// K4 (nn_dense.cu).
//
// For every query q of a cloud it scans all targets t of the same cloud for
// the least
//     e = |t|^2 - 2 q.t            (the query norm cannot change the argmin)
// under strict <, so the lowest index wins ties, then writes
//     dist = max(e_best + |q|^2, 0),  idx = argmin
// and, when kCoords, coords = t[idx] (exact). The operation order,
// (x*x + y*y) + z*z and (tx*qx + ty*qy) + tz*qz, each step rounded with no
// fused multiply-add, is the plain version's (ops/chamfer.py:_one_sided), so
// distances and indices agree bit for bit.
//
// Design: one thread per query, 256 queries a block, grid (query blocks, b).
// Targets stream through shared memory in tiles of 1024 points packed as
// float4 (x, y, z, |t|^2), so one 16-byte broadcast load feeds one pair.
// Bound on the H100: about 9 fp32 operations a pair outside the tensor cores,
// so the scan is compute-bound at every shape the model uses; bytes are 12
// per point read and 8 (20 with coords) per query written.
#pragma once

#include "common.cuh"

namespace rfnet {

constexpr int kScanThreads = 256;
constexpr int kScanTile = 1024;

template <bool kCoords>
__global__ void __launch_bounds__(kScanThreads)
nn_scan_kernel(const float* __restrict__ query, const float* __restrict__ target,
               int n, int m, float* __restrict__ dist, int* __restrict__ idx,
               float* __restrict__ coords) {
  __shared__ float4 tile[kScanTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  const float* t = target + static_cast<size_t>(b) * m * 3;
  const bool live = i < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* q = query + (static_cast<size_t>(b) * n + i) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int base = 0; base < m; base += kScanTile) {
    const int cnt = min(kScanTile, m - base);
    __syncthreads();  // the previous tile is fully scanned
    for (int k = threadIdx.x; k < cnt; k += kScanThreads) {
      const float x = t[3 * (base + k)], y = t[3 * (base + k) + 1], z = t[3 * (base + k) + 2];
      tile[k] = make_float4(x, y, z, sq3(x, y, z));
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < cnt; ++k) {
        const float4 p = tile[k];
        const float cross = dot3(p.x, p.y, p.z, qx, qy, qz);
        const float e = __fsub_rn(p.w, __fmul_rn(2.f, cross));
        if (e < best) {
          best = e;
          best_j = base + k;
        }
      }
    }
  }
  if (live) {
    const size_t o = static_cast<size_t>(b) * n + i;
    dist[o] = fmaxf(__fadd_rn(best, sq3(qx, qy, qz)), 0.f);
    idx[o] = best_j;
    if (kCoords) {
      coords[3 * o] = t[3 * best_j];
      coords[3 * o + 1] = t[3 * best_j + 1];
      coords[3 * o + 2] = t[3 * best_j + 2];
    }
  }
}

template <bool kCoords>
int nn_scan_launch(const void* query, const void* target, int b, int n, int m, void* dist,
                   void* idx, void* coords, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + kScanThreads - 1) / kScanThreads, b);
  nn_scan_kernel<kCoords><<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n, m,
      static_cast<float*>(dist), static_cast<int*>(idx), static_cast<float*>(coords));
  return cudaGetLastError();
}

}  // namespace rfnet

// The dense one-sided nearest-neighbour scan shared by K2 (nn_coords.cu) and
// K4 (nn_dense.cu).
//
// Contract. For every query q of a cloud it scans all targets t of the same
// cloud for the least
//     e = |t|^2 - 2 q.t            (the query norm cannot change the argmin)
// under strict < in target order, so the lowest index wins ties, then writes
//     dist = max(e_best + |q|^2, 0),  idx = argmin
// and, when kCoords, coords = t[idx] (exact). The operation order,
// (x*x + y*y) + z*z and (tx*qx + ty*qy) + tz*qz, each step rounded with no
// fused multiply-add, is the plain version's (ops/chamfer.py:_one_sided), so
// distances and indices agree bit for bit.
//
// Design. The launch plan (R, G, W, C, tiles) is ops/chamfer.py:_nn_scan_plan.
// - R queries a thread (4 or 8). One broadcast float4 (x, y, z, |t|^2) read
//   of a target from shared memory feeds R pairs, and one index register
//   serves all R; the inner loop is unrolled over kScanPairs / R targets.
//   A pair costs 10 issue slots (3 FMUL + 2 FADD for the dot product, the
//   doubling, the subtraction, the compare and two selects); the load and
//   the index add 2 / R.
// - A CTA has G query warps (32 * R queries each) times W warps that split
//   the target range. A thread-block cluster of C CTAs splits the cloud's
//   targets into C contiguous ranges, one a CTA. A CTA stages its range once
//   as float4s in shared memory with 4-byte cp.async copies of the cloud read
//   as a flat float array (coalesced, any alignment), then one pass adds
//   |t|^2. Where the range does not fit, it is staged in `tiles` tiles
//   through two buffers, the next tile's copies issued before the current
//   tile is scanned. Each of the W warps of a query group scans a contiguous
//   1/W of every tile.
// - Every warp keeps a partial (e, j) for each of its queries. The warps of
//   a query group merge in shared memory; then the CTAs of the cluster merge
//   through distributed shared memory, and rank 0 writes dist, idx and, for
//   K2, the argmin's coordinates, read from the CTA whose range holds it
//   (from global memory in the tiled form).
//
// Why the split equals the sequential scan. The strict-< scan in target
// order returns the lexicographic least (e_j, j): the least e, and of the
// targets that have it the lowest index. A warp scans its own targets in
// ascending order, so its partial is the lexicographic least over its set.
// The lexicographic min is associative and commutative, so the min over the
// partials, in any grouping and order, is the min over the union: the
// sequential result, however the targets are split and whichever CTA
// finishes first. Partials merge by e < be || (e == be && j < bj). A warp
// with no target, or whose every e is +inf, keeps (+inf, 0): any finite e
// beats it, and where every target's e is +inf the scan returns index 0, as
// the sequential scan does. e is never -0 (|t|^2 >= +0, and a - b is -0 only
// for a = -0), so the float compare orders e exactly.
//
// Bound on the H100: 9 fp32 operations a pair, none of which may fuse, so
// the scan is bound by the issue rate (10 slots a pair) at every shape the
// model uses; bytes are 12 per point read and 8 (20 with coords) per query
// written. Few queries against many targets (the merge layer's 64 and 1024)
// leave most SMs idle unless the targets are split, which W and C do.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace rfnet {

namespace scan_cg = cooperative_groups;

constexpr int kScanMaxWarps = 8;         // G * W warps a CTA at most
constexpr int kScanMaxCluster = 8;       // C, the portable cluster size
constexpr int kScanPairs = 32;           // pairs a thread computes in one unrolled step
constexpr int kScanMaxShared = 232448;   // bytes of shared memory a block may have

struct ScanPartial {
  float e;
  int j;
};

__device__ __forceinline__ bool scan_before(float e, int j, float be, int bj) {
  return e < be || (e == be && j < bj);
}

__device__ __forceinline__ void scan_cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Starts copying targets [base, base + cnt) of the cloud t into buf as the
// x, y, z of float4s.
__device__ __forceinline__ void scan_stage(float4* buf, const float* t, int base, int cnt) {
  const float* src = t + 3 * static_cast<size_t>(base);
  float* dst = reinterpret_cast<float*>(buf);
  for (int f = threadIdx.x; f < 3 * cnt; f += blockDim.x) {
    scan_cp_async4(dst + f / 3 * 4 + f % 3, src + f);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void scan_target(float4 p, int j, const float (&qx)[R],
                                            const float (&qy)[R], const float (&qz)[R],
                                            float (&best)[R], int (&best_j)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float cross = dot3(p.x, p.y, p.z, qx[r], qy[r], qz[r]);
    const float e = __fsub_rn(p.w, __fmul_rn(2.f, cross));
    if (e < best[r]) {
      best[r] = e;
      best_j[r] = j;
    }
  }
}

// The `count` targets from p on, whose first has index j in the cloud.
template <int R>
__device__ __forceinline__ void scan_range(const float4* p, int count, int j,
                                           const float (&qx)[R], const float (&qy)[R],
                                           const float (&qz)[R], float (&best)[R],
                                           int (&best_j)[R]) {
  constexpr int U = kScanPairs / R;
  for (; count >= U; count -= U, p += U, j += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) scan_target<R>(p[u], j + u, qx, qy, qz, best, best_j);
  }
  for (; count > 0; --count, ++p, ++j) scan_target<R>(*p, j, qx, qy, qz, best, best_j);
}

// Grid (query tiles * C, b) in clusters of C; blockDim 32 * G * W.
template <bool kCoords, int R>
__global__ void __launch_bounds__(kScanMaxWarps * 32)
nn_scan_kernel(const float* __restrict__ query, const float* __restrict__ target, int n, int m,
               int W, int tiles, float* __restrict__ dist, int* __restrict__ idx,
               float* __restrict__ coords) {
  extern __shared__ float4 smem[];
  scan_cg::cluster_group cluster = scan_cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, w = warp % W;
  const int b = blockIdx.y;
  const float* t = target + static_cast<size_t>(b) * m * 3;

  // this CTA's range of targets, and its tiles
  const int chunk = (m + C - 1) / C;
  const int lo = min(m, rank * chunk), len = min(m, lo + chunk) - lo;
  const int tile = (chunk + tiles - 1) / tiles;
  const int nt = (len + tile - 1) / tile;
  const int second = tiles == 1 ? 0 : tile;  // offset of the second buffer
  ScanPartial* part = reinterpret_cast<ScanPartial*>(smem + (tiles == 1 ? 1 : 2) * tile);

  // query r of a thread is q0 + 32 r
  const int q0 = (blockIdx.x / C) * (blockDim.x / W) * R + (warp / W) * 32 * R + lane;
  const bool warp_live = q0 - lane < n;
  float qx[R], qy[R], qz[R], best[R];
  int best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + 32 * r;
    const float* q = query + (static_cast<size_t>(b) * n + min(i, n - 1)) * 3;
    qx[r] = q[0];
    qy[r] = q[1];
    qz[r] = q[2];
    best[r] = __int_as_float(0x7f800000);  // +inf
    best_j[r] = 0;
  }

  if (nt > 0) scan_stage(smem, t, lo, min(tile, len));
  for (int k = 0; k < nt; ++k) {
    float4* cur = smem + (k & 1) * second;
    const int cnt = min(tile, len - k * tile);
    if (k + 1 < nt) {
      const int next = lo + (k + 1) * tile;
      scan_stage(smem + ((k + 1) & 1) * second, t, next, min(tile, lo + len - next));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    for (int p = threadIdx.x; p < cnt; p += blockDim.x) {
      const float4 v = cur[p];
      cur[p].w = sq3(v.x, v.y, v.z);
    }
    __syncthreads();
    if (warp_live) {
      const int sub = (cnt + W - 1) / W;
      const int s = min(cnt, w * sub);
      scan_range<R>(cur + s, min(cnt, s + sub) - s, lo + k * tile + s, qx, qy, qz, best, best_j);
    }
    if (k + 2 < nt) __syncthreads();  // every warp is done with cur before it is refilled
  }

  // the query group's W partials, then the cluster's C
  if (W > 1 || C > 1) {
    ScanPartial* mine = part + warp * R * 32 + lane;
    if (w > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) mine[32 * r] = {best[r], best_j[r]};
    }
    __syncthreads();
    if (w == 0) {
      for (int v = 1; v < W; ++v) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const ScanPartial o = mine[(v * R + r) * 32];
          if (scan_before(o.e, o.j, best[r], best_j[r])) {
            best[r] = o.e;
            best_j[r] = o.j;
          }
        }
      }
      if (C > 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) mine[32 * r] = {best[r], best_j[r]};
      }
    }
    if (C > 1) {
      cluster.sync();
      if (rank == 0 && w == 0) {
        for (int c = 1; c < C; ++c) {
          const ScanPartial* peer = cluster.map_shared_rank(mine, c);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const ScanPartial o = peer[32 * r];
            if (scan_before(o.e, o.j, best[r], best_j[r])) {
              best[r] = o.e;
              best_j[r] = o.j;
            }
          }
        }
      }
    }
  }

  if (rank == 0 && w == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + 32 * r;
      if (i >= n) continue;
      const size_t o = static_cast<size_t>(b) * n + i;
      dist[o] = fmaxf(__fadd_rn(best[r], sq3(qx[r], qy[r], qz[r])), 0.f);
      idx[o] = best_j[r];
      if constexpr (kCoords) {
        const int j = best_j[r];
        float x, y, z;
        if (tiles == 1) {  // from the range of the CTA that holds it
          const int owner = j / chunk;
          const float4* src = owner == rank ? smem : cluster.map_shared_rank(smem, owner);
          const float4 v = src[j - owner * chunk];
          x = v.x;
          y = v.y;
          z = v.z;
        } else {
          x = t[3 * j];
          y = t[3 * j + 1];
          z = t[3 * j + 2];
        }
        coords[3 * o] = x;
        coords[3 * o + 1] = y;
        coords[3 * o + 2] = z;
      }
    }
  }
  if (C > 1) cluster.sync();  // no CTA leaves while rank 0 may read its shared memory
}

// Shared memory of one CTA: its tile (two where the range is tiled) and,
// where the targets are split, a partial for each query slot of the CTA.
// ops/chamfer.py:_nn_scan_shared mirrors it.
inline size_t nn_scan_shared_bytes(int m, int R, int G, int W, int C, int tiles) {
  const size_t chunk = (m + C - 1) / C;
  const size_t tile = (chunk + tiles - 1) / tiles;
  const size_t part = W * C > 1 ? sizeof(ScanPartial) * 32 * R * G * W : 0;
  return (tiles == 1 ? 1 : 2) * tile * sizeof(float4) + part;
}

inline bool scan_pow2(int x, int most) { return x >= 1 && x <= most && (x & (x - 1)) == 0; }

template <typename Kernel>
cudaError_t nn_scan_go(Kernel kernel, int* granted, int b, int n, int m, int R, int G, int W,
                       int C, int tiles, const void* query, const void* target, void* dist,
                       void* idx, void* coords, void* stream) {
  const size_t smem = nn_scan_shared_bytes(m, R, G, W, C, tiles);
  if (smem > static_cast<size_t>(kScanMaxShared)) return cudaErrorInvalidValue;
  if (static_cast<int>(smem) > *granted) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    *granted = static_cast<int>(smem);
  }
  const int per_cta = 32 * R * G;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + per_cta - 1) / per_cta * C, b);
  config.blockDim = dim3(32 * G * W);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(query), static_cast<const float*>(target), n, m,
      W, tiles, static_cast<float*>(dist), static_cast<int*>(idx), static_cast<float*>(coords));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks the plan and launches. A plan is refused when R is not 4 or 8, G,
// W or C is not a power of two in range, or its tiles are too few for the
// CTA's range to fit in shared memory (a short plan).
template <bool kCoords>
int nn_scan_launch(const void* query, const void* target, int b, int n, int m, int R, int G,
                   int W, int C, int tiles, void* dist, void* idx, void* coords, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || tiles < 1) return cudaErrorInvalidValue;
  if (!scan_pow2(G, kScanMaxWarps) || !scan_pow2(W, kScanMaxWarps) || G * W > kScanMaxWarps ||
      !scan_pow2(C, kScanMaxCluster)) {
    return cudaErrorInvalidValue;
  }
  // dynamic shared memory allowed so far, per R (for the process's card)
  static int granted[2] = {48 * 1024, 48 * 1024};
  switch (R) {
    case 4:
      return nn_scan_go(nn_scan_kernel<kCoords, 4>, &granted[0], b, n, m, R, G, W, C, tiles,
                        query, target, dist, idx, coords, stream);
    case 8:
      return nn_scan_go(nn_scan_kernel<kCoords, 8>, &granted[1], b, n, m, R, G, W, C, tiles,
                        query, target, dist, idx, coords, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace rfnet

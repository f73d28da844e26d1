// K9: the dense one-sided nearest-neighbour scan in four arithmetic and
// argmin variants, for the study tools/bench_chamfer_variants_torch.py.
//
// Replaces the TPU kernel of tools/bench_chamfer_variants.py:nn_variant
// (body make_kernel(fma, eq_argmin)). Contract, every variant: for each query
// the least e over the targets of its cloud under strict <, the lowest index
// among equal e, then dist = max(e_best + |q|^2, 0) and that index. The
// variant sets the form of e and of the argmin:
//   v0 (fma 0, eq 0)  e = |t|^2 - 2 ((tx qx + ty qy) + tz qz), each step
//                     rounded: K4's kernel instance (nn_scan.cuh) under K4's
//                     plan, the study's re-measured baseline;
//   v1 (fma 1, eq 0)  e = fma(mx, qx, fma(my, qy, fma(mz, qz, |t|^2))),
//                     m = -2t, and the per-pair strict-< select (the
//                     variadic argmin);
//   v2 (fma 0, eq 1)  e = fma(-2, (tx qx + ty qy) + tz qz, |t|^2), the
//                     product and sum steps rounded, and the argmin as
//                     min-then-equality;
//   v3 (fma 1, eq 1)  v1's e, v2's argmin.
// v1-v3 run nn_variant_kernel below under the plan of
// tools/bench_chamfer_variants_torch.py:variant_plan.
//
// v2's e equals v0's bit for bit. 2 * cross is exact in float32 (a doubling
// changes the exponent alone), so s2 - 2 * cross rounds the exact value
// s2 - 2 * cross once, and the fused fma(-2, cross, s2) rounds the same exact
// value once. Both give +0 where it is zero (|t|^2 >= +0, so no -0 arises).
// The claim holds on every input where |t|^2 and 2 * cross are finite, that
// is, for coordinates below ~1e19 in magnitude; beyond, either may overflow.
//
// Design (H100). A thread holds R queries (4 or 8). A CTA of G query warps
// times W warps that split the targets stages its cluster rank's range of
// targets in tiles of at most 2048 float4s (x, y, z, |t|^2; under fma
// -2x, -2y, -2z, |t|^2, exact), double-buffered with cp.async as
// nn_scan.cuh stages them, 64 KB a CTA, so that two CTAs of 8 warps share
// an SM, three for v1 (its launch bounds cap the registers at 128 a thread
// with the equality argmin, at 85 without). Each warp scans a share of
// every tile that is a whole number of chunks of U targets (variant_chunk),
// in chunks; a chunk's U targets are read from shared memory into registers
// once (a broadcast float4 each) and serve the R queries:
// - v1: every pair's e against the running best under strict <, FSETP and
//   two SELs a pair (v1's identity in the study is the variadic argmin).
// - v2, v3: for each query the chunk's U values of e are computed into
//   registers and their least taken with fminf (1 FMNMX a pair); only where
//   it is below the query's running best (strict <) is the lowest u whose
//   held e equals it found, by comparing registers, and (e, j) taken. With
//   32 lanes a warp, a query slot's chance of improving at chunk k is ~1/k,
//   so the warp takes that branch on ~32 (1 + ln(k_max / 32)) of its k_max
//   chunks: 8 % of them at 16384 targets and U = 8, 11 % at U = 12.
// - The ragged end of a share goes target by target under strict <, which
//   is the chunk rule for a chunk of one.
// Expected issue slots a pair: v1 3 FFMA + FSETP + 2 SEL (6); v2 3 FMUL +
// 2 FADD + FFMA + FMNMX (7); v3 3 FFMA + FMNMX (4); each plus the chunk's
// compare and branch, 1 / R for the broadcast load and the rare re-find.
// (An H100 read about 6.2, 7.4 and 4.6 outside the re-find at R = 8:
// PERF.md.)
//
// Why the chunks and the splits equal the sequential scan. A chunk's
// (least e, lowest index that has it) is its lexicographic least (e, j); it
// replaces the running best only under strict <, and its j is above every
// earlier j, so the running best stays the lexicographic least of what the
// warp has scanned in ascending order. The W warps' and the C CTAs' partials
// then merge lexicographically as in nn_scan.cuh. fminf ignores a NaN e and
// a NaN never passes strict <, so NaNs are skipped as the select skips them;
// where every e is +inf (or NaN) the warp keeps (+inf, 0).
//
// Bound on the H100: each variant's fp32 operations a pair at 67 TFLOP/s,
// which counts an FFMA as 2: v1, v3 7 (3 FFMA, the compare or fminf), v2 8
// (3 FMUL, 2 FADD, 1 FFMA, fminf); bytes, 12 a point read and 8 a query
// written, take far less. The kernel is bound by its issue slots a pair
// above, at 128 an SM a cycle: an FMUL, FADD, FMNMX or select issues 1
// operation a slot where the peak counts 2.

#include "nn_scan.cuh"

namespace rfnet {

// U, the targets of a chunk: 64 / R, and 12 at R = 8 for the unfused chain
// (on an H100 at (32,16384)^2, U = 12 took v2 from 2.34 to 2.27 ms and v3
// from 1.67 to 1.82: tools/bench_torch_k9_designs.py, PERF.md).
template <int R, bool kFma>
__host__ __device__ constexpr int variant_chunk() {
  return R == 8 && !kFma ? 12 : 64 / R;
}

// CTAs of 8 warps an SM that the registers allow (__launch_bounds__ caps a
// thread's registers at 65536 / (256 x this)): 2 for the equality argmin
// (a chunk's targets and a query's U values of e in registers), 3 for the
// select.
constexpr int variant_blocks_per_sm(bool eq) { return eq ? 2 : 3; }

// e of the staged target p and the query q in the variant's arithmetic.
template <bool kFma>
__device__ __forceinline__ float variant_e(float4 p, float qx, float qy, float qz) {
  if constexpr (kFma) {
    return __fmaf_rn(p.x, qx, __fmaf_rn(p.y, qy, __fmaf_rn(p.z, qz, p.w)));
  } else {
    return __fmaf_rn(-2.f, dot3(p.x, p.y, p.z, qx, qy, qz), p.w);
  }
}

// One target (index j) against the thread's R queries, under strict <.
template <int R, bool kFma>
__device__ __forceinline__ void variant_select(float4 p, int j, const float (&qx)[R],
                                               const float (&qy)[R], const float (&qz)[R],
                                               float (&best)[R], int (&best_j)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float e = variant_e<kFma>(p, qx[r], qy[r], qz[r]);
    if (e < best[r]) {
      best[r] = e;
      best_j[r] = j;
    }
  }
}

// U targets from p on (the first has index j) against the R queries, the
// argmin as min-then-equality over the e values held in registers.
template <int R, int U, bool kFma>
__device__ __forceinline__ void variant_chunk_eq(const float4* p, int j, const float (&qx)[R],
                                                 const float (&qy)[R], const float (&qz)[R],
                                                 float (&best)[R], int (&best_j)[R]) {
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = p[u];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) e[u] = variant_e<kFma>(v[u], qx[r], qy[r], qz[r]);
    float least = e[0];
#pragma unroll
    for (int u = 1; u < U; ++u) least = fminf(least, e[u]);
    if (least < best[r]) {  // rare: a branch around the re-find
      int k = U - 1;
#pragma unroll
      for (int u = U - 2; u >= 0; --u) k = e[u] == least ? u : k;
      best[r] = least;
      best_j[r] = j + k;
    }
  }
}

// The `count` targets from p on, whose first has index j in the cloud.
template <int R, bool kFma, bool kEq>
__device__ __forceinline__ void variant_range(const float4* p, int count, int j,
                                              const float (&qx)[R], const float (&qy)[R],
                                              const float (&qz)[R], float (&best)[R],
                                              int (&best_j)[R]) {
  constexpr int U = variant_chunk<R, kFma>();
  for (; count >= U; count -= U, p += U, j += U) {
    if constexpr (kEq) {
      variant_chunk_eq<R, U, kFma>(p, j, qx, qy, qz, best, best_j);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) variant_select<R, kFma>(p[u], j + u, qx, qy, qz, best, best_j);
    }
  }
  for (; count > 0; --count, ++p, ++j) variant_select<R, kFma>(*p, j, qx, qy, qz, best, best_j);
}

// Grid (query tiles * C, b) in clusters of C; blockDim 32 * G * W. The
// parameter list is nn_scan_kernel's, so that nn_scan_go launches it; there
// is no coordinate output.
template <int R, bool kFma, bool kEq>
__global__ void __launch_bounds__(kScanMaxWarps * 32, variant_blocks_per_sm(kEq))
nn_variant_kernel(const float* __restrict__ query, const float* __restrict__ target, int n,
                  int m, int W, int tiles, float* __restrict__ dist, int* __restrict__ idx,
                  float* __restrict__ /*coords*/) {
  constexpr int U = variant_chunk<R, kFma>();
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
    const float* q = query + (static_cast<size_t>(b) * n + min(q0 + 32 * r, n - 1)) * 3;
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
      const float s2 = sq3(v.x, v.y, v.z);
      cur[p] = kFma ? make_float4(-2.f * v.x, -2.f * v.y, -2.f * v.z, s2)
                    : make_float4(v.x, v.y, v.z, s2);
    }
    __syncthreads();
    if (warp_live) {  // a share of whole chunks
      const int sub = ((cnt + W - 1) / W + U - 1) / U * U;
      const int s = min(cnt, w * sub);
      variant_range<R, kFma, kEq>(cur + s, min(cnt, s + sub) - s, lo + k * tile + s, qx, qy, qz,
                                  best, best_j);
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
      cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
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
    }
  }
}

// The plan's checks, as nn_scan_launch makes them.
inline bool variant_plan_ok(int b, int n, int m, int G, int W, int C, int tiles) {
  return b > 0 && n > 0 && m > 0 && tiles >= 1 && scan_pow2(G, kScanMaxWarps) &&
         scan_pow2(W, kScanMaxWarps) && G * W <= kScanMaxWarps && scan_pow2(C, kScanMaxCluster);
}

template <bool kFma, bool kEq>
int variant_launch(const void* query, const void* target, int b, int n, int m, int R, int G,
                   int W, int C, int tiles, void* dist, void* idx, void* stream) {
  if (!variant_plan_ok(b, n, m, G, W, C, tiles)) return cudaErrorInvalidValue;
  static int granted[2] = {48 * 1024, 48 * 1024};
  switch (R) {
    case 4:
      return nn_scan_go(nn_variant_kernel<4, kFma, kEq>, &granted[0], b, n, m, R, G, W, C, tiles,
                        query, target, dist, idx, nullptr, stream);
    case 8:
      return nn_scan_go(nn_variant_kernel<8, kFma, kEq>, &granted[1], b, n, m, R, G, W, C, tiles,
                        query, target, dist, idx, nullptr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

inline int variant_index(int fma, int eq) {
  return (fma == 0 || fma == 1) && (eq == 0 || eq == 1) ? 2 * fma + eq : -1;
}

}  // namespace rfnet

// query, target, b, n, m, the plan (R, G, W, C, tiles; v0 takes K4's, v1-v3
// K9's), fma and eq each 0 or 1 (another value is refused with
// cudaErrorInvalidValue), dist_out, idx_out, stream.
extern "C" int rfnet_nn_variant(const void* query, const void* target, int b, int n, int m,
                                int per_thread, int groups, int warps, int cluster, int tiles,
                                int fma, int eq, void* dist, void* idx, void* stream) {
  switch (rfnet::variant_index(fma, eq)) {
    case 0:
      return rfnet::nn_scan_launch<false>(query, target, b, n, m, per_thread, groups, warps,
                                          cluster, tiles, dist, idx, nullptr, stream);
    case 1:
      return rfnet::variant_launch<false, true>(query, target, b, n, m, per_thread, groups, warps,
                                                cluster, tiles, dist, idx, stream);
    case 2:
      return rfnet::variant_launch<true, false>(query, target, b, n, m, per_thread, groups, warps,
                                                cluster, tiles, dist, idx, stream);
    case 3:
      return rfnet::variant_launch<true, true>(query, target, b, n, m, per_thread, groups, warps,
                                               cluster, tiles, dist, idx, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

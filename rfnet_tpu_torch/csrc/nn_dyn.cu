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
// expansion of the TPU kernel). That makes every skip exact with no slack:
// rounding is monotone and every term is >= 0, so the rounded d of a target
// is >= the rounded g = (qz-tz)^2 computed from the same rounded difference,
// and along a z-sorted cloud g only grows away from the query's z; likewise
// the squared distance to a box never exceeds the rounded d of a point in it
// (nn_tiles.cuh:point_box_bound). (The expansion's absolute error, about
// eps*(|q|^2+|t|^2), can exceed a relative widening of the bound at small
// distances; this formulation has no such gap.) The plain version
// (ops/chamfer.py:_nn_sorted_plain) computes the same d for every pair, so
// distances and indices agree bit for bit, and with K7 on the same inputs.
//
// Design: a block-cooperative slab walk. One block of 128 threads takes 256
// consecutive z-sorted queries, two a thread, so one read of a target from
// shared memory feeds two pairs. The sorted targets are cut into slabs of S
// consecutive points. The block starts at the slab holding its middle
// query's z (one 32-way search by a warp) and walks outward with two
// pointers. Before it scans a slab it decides the next one and copies it
// into the other of two shared-memory buffers with 16-byte cp.async, so the
// copy overlaps the scan. A side stops when, for every query of the block,
// the squared z gap to that side's frontier slab exceeds the query's
// running best (equality keeps scanning, for ties); the walk ends when both
// sides have stopped. Inside a landed slab each warp takes the targets 32 at
// a time and skips them (a warp-uniform branch) when every one of its 64
// queries lies farther from their box than its best. Inside a slab a query
// keeps the first least d by strict <; slabs arrive out of index order, so
// the slab's winner j merges into the running best by
// d < best || (d == best && j < best_j).
//
// Bound on the H100: 8 fp32 operations a pair (3 differences, 3 squares, 2
// sums) plus a compare and two selects, over the pairs the block scans; a
// third of a shared-memory load a pair. The visited slabs are a data-
// dependent share of the dense scan: a few percent on surface-like clouds,
// most of it where a random-init output lies far from the ground truth.

#include <cstdint>

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 2;  // queries a thread
constexpr int kQueries = kThreads * kQ;
constexpr int kSlab = 256;  // S (128 and 512 were no faster on the main path's shapes)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, uintptr_t src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The block starts copying slab k (targets [k*S, min(m, (k+1)*S)) of the
// cloud t) into buf. It copies the 16-byte aligned chunks that hold the
// slab's floats, so it may read up to 12 bytes on either side of the slab;
// a chunk holding one of the tensor's floats lies inside its allocation.
// Returns the offset, in floats, of the slab's first float in buf.
template <int S>
__device__ __forceinline__ int copy_slab(float* buf, const float* t, int k, int m) {
  const size_t end = min(m, (k + 1) * S);
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(t + 3 * static_cast<size_t>(k) * S);
  const uintptr_t a1 = reinterpret_cast<uintptr_t>(t + 3 * end);
  const uintptr_t c0 = a0 & ~static_cast<uintptr_t>(15);
  const int chunks = static_cast<int>((a1 + 15 - c0) >> 4);
  for (int c = threadIdx.x; c < chunks; c += kThreads) cp_async16(buf + 4 * c, c0 + 16 * c);
  return static_cast<int>((a0 - c0) >> 2);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
nn_dyn_kernel(const float* __restrict__ query, const float* __restrict__ target, int n, int m,
              float* __restrict__ dist, int* __restrict__ idx,
              unsigned long long* __restrict__ pairs_loaded) {
  __shared__ __align__(16) float slab[2][3 * S + 8];
  __shared__ int wants[kWarps];
  __shared__ int start;

  const int b = blockIdx.y, i0 = blockIdx.x * kQueries;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* t = target + static_cast<size_t>(b) * m * 3;
  const float inf = CUDART_INF_F;

  // two consecutive queries a thread; a missing one has best -inf, so it
  // never wants a slab
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_j[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = i0 + kQ * threadIdx.x + q;
    const bool live = i < n;
    const float* p = query + (static_cast<size_t>(b) * n + (live ? i : 0)) * 3;
    qx[q] = live ? p[0] : 0.f;
    qy[q] = live ? p[1] : 0.f;
    qz[q] = live ? p[2] : 0.f;
    best[q] = live ? inf : -inf;
    best_j[q] = 0x7fffffff;
  }

  // the first target with tz >= the block's middle query's z, by a 32-way
  // search of warp 0
  const int last = min(i0 + kQueries, n) - 1;
  const float zmid = __ldg(query + (static_cast<size_t>(b) * n + (i0 + last) / 2) * 3 + 2);
  if (warp == 0) {
    int lo = 0, hi = m;
    while (lo < hi) {
      const int step = (hi - lo + 31) / 32;
      const int pos = lo + lane * step;
      const bool below = pos < hi && __ldg(t + 3 * pos + 2) < zmid;
      const int c = __popc(__ballot_sync(kFull, below));
      if (c == 0) {
        hi = lo;
      } else {
        hi = min(hi, lo + c * step);
        lo += (c - 1) * step + 1;
      }
    }
    if (lane == 0) start = lo;
  }
  __syncthreads();

  const int ns = (m + S - 1) / S;
  int cur = min(start / S, ns - 1);
  int up = cur + 1, dn = cur - 1, stage = 0;
  int head = copy_slab<S>(slab[0], t, cur, m);
  cp_async_commit();

  for (;;) {
    // Decide the next slab from the bests so far. The frontier gap of a
    // side lower-bounds every target beyond it, so a side no query wants
    // now is never wanted again.
    const float zu = up < ns ? __ldg(t + 3 * up * S + 2) : 0.f;
    const float zd = dn >= 0 ? __ldg(t + 3 * ((dn + 1) * S - 1) + 2) : 0.f;
    bool want_up = false, want_dn = false;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float gu = fmaxf(__fsub_rn(zu, qz[q]), 0.f);
      const float gd = fmaxf(__fsub_rn(qz[q], zd), 0.f);
      want_up |= up < ns && !(__fmul_rn(gu, gu) > best[q]);
      want_dn |= dn >= 0 && !(__fmul_rn(gd, gd) > best[q]);
    }
    const int w = (__any_sync(kFull, want_up) ? 1 : 0) | (__any_sync(kFull, want_dn) ? 2 : 0);
    if (lane == 0) wants[warp] = w;
    __syncthreads();  // also: every warp has finished scanning the buffer refilled below
    int f = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) f |= wants[k];
    int nxt = -1, nxt_head = 0;
    if (f) {
      const bool take_up = (f & 1) && (!(f & 2) || __fsub_rn(zu, zmid) <= __fsub_rn(zmid, zd));
      nxt = take_up ? up++ : dn--;
      nxt_head = copy_slab<S>(slab[stage ^ 1], t, nxt, m);
    }
    cp_async_commit();  // possibly empty: the group of slab `cur` is then the older one
    cp_async_wait_one();
    __syncthreads();

    const float* sp = slab[stage] + head;
    const int base = cur * S, cnt = min(S, m - base);
    float sb[kQ];
    int sk[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      sb[q] = inf;
      sk[q] = 0;
    }
    for (int c = 0; c < cnt; c += 32) {
      // the box of these 32 targets: x and y by the warp, z from its sorted
      // ends; the warp skips them when none of its queries can reach it
      const int cc = min(32, cnt - c);
      const bool mine = lane < cc;
      float xlo = mine ? sp[3 * (c + lane)] : inf, ylo = mine ? sp[3 * (c + lane) + 1] : inf;
      float xhi = mine ? xlo : -inf, yhi = mine ? ylo : -inf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        xlo = fminf(xlo, __shfl_xor_sync(kFull, xlo, off));
        xhi = fmaxf(xhi, __shfl_xor_sync(kFull, xhi, off));
        ylo = fminf(ylo, __shfl_xor_sync(kFull, ylo, off));
        yhi = fmaxf(yhi, __shfl_xor_sync(kFull, yhi, off));
      }
      const float zlo = sp[3 * c + 2], zhi = sp[3 * (c + cc - 1) + 2];
      bool scan = false;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float gx = fmaxf(fmaxf(__fsub_rn(xlo, qx[q]), __fsub_rn(qx[q], xhi)), 0.f);
        const float gy = fmaxf(fmaxf(__fsub_rn(ylo, qy[q]), __fsub_rn(qy[q], yhi)), 0.f);
        const float gz = fmaxf(fmaxf(__fsub_rn(zlo, qz[q]), __fsub_rn(qz[q], zhi)), 0.f);
        // nearer than neither the running best nor this slab's best so far
        scan |= !(rfnet::sq3(gx, gy, gz) > fminf(best[q], sb[q]));
      }
      if (!__any_sync(kFull, scan)) continue;
#pragma unroll 4
      for (int k = c; k < c + cc; ++k) {
        const float tx = sp[3 * k], ty = sp[3 * k + 1], tz = sp[3 * k + 2];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float d = rfnet::sq3(__fsub_rn(qx[q], tx), __fsub_rn(qy[q], ty),
                                     __fsub_rn(qz[q], tz));
          if (d < sb[q]) {  // k ascends: the first of equal distances stays
            sb[q] = d;
            sk[q] = k;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = base + sk[q];
      if (sb[q] < best[q] || (sb[q] == best[q] && j < best_j[q])) {
        best[q] = sb[q];
        best_j[q] = j;
      }
    }
    if (nxt < 0) break;
    cur = nxt;
    head = nxt_head;
    stage ^= 1;
  }

  // The block loaded the slabs strictly between dn and up, each whole: it
  // counts their targets once for each of its live queries.
  if (pairs_loaded != nullptr && threadIdx.x == 0) {
    const unsigned long long targets = min(m, up * S) - (dn + 1) * S;
    atomicAdd(pairs_loaded, targets * static_cast<unsigned>(min(kQueries, n - i0)));
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = i0 + kQ * threadIdx.x + q;
    if (i < n) {
      const size_t o = static_cast<size_t>(b) * n + i;
      dist[o] = best[q];
      idx[o] = best_j[q];
    }
  }
}

}  // namespace

// `slab` must be kSlab, the targets a shared-memory slab holds: the
// wrapper's copy of the constant, which its callers read. `pairs_loaded`,
// where not null, gains the pairs of the slabs the blocks loaded: for each
// block, its live queries times the targets of every slab it loaded.
extern "C" int rfnet_nn_dyn(const void* query, const void* target, int b, int n, int m, int slab,
                            void* dist, void* idx, void* pairs_loaded, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || slab != kSlab) return cudaErrorInvalidValue;
  const dim3 grid((n + kQueries - 1) / kQueries, b);
  nn_dyn_kernel<kSlab><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n, m,
      static_cast<float*>(dist), static_cast<int*>(idx),
      static_cast<unsigned long long*>(pairs_loaded));
  return cudaGetLastError();
}

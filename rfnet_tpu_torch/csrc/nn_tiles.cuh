// The tile walk shared by the two box-pruned nearest-neighbour scans, K7
// (nn_pruned.cu, z-sorted clouds, fixed diagonal order) and K8 (nn_tile.cu,
// Morton-sorted clouds, best-first order).
//
// Contract. Both scan a sorted target cloud for every query of the same
// cloud and return the least squared distance
//     d = ((qx-tx)^2 + (qy-ty)^2) + (qz-tz)^2,
// each step rounded with no fused multiply-add (the chain of K3, nn_dyn.cu,
// and of the plain version, ops/chamfer.py:_nn_sorted_plain), and the index
// into the sorted target of the nearest target, the lowest index winning
// ties whatever order the tiles are visited in.
//
// Boxes. The box pass (common.cuh:run_boxes) writes the box [lo x y z,
// hi x y z] of every chunk of 32 consecutive targets and of every tile of
// tile_m consecutive targets (a multiple of 32). A bound is the squared gap from a
// query, or from a box of queries, to a box, taken through d's own rounded
// chain: for a target t in the box, where lo > q the rounded lo - q is <= the
// rounded t - q = |q - t| (rounding is monotone, negation is exact), likewise
// q - hi, and squares and sums of non-negative numbers taken in d's order
// are monotone too. So a bound never exceeds the rounded d of any pair it
// covers, and needs no slack: a tile or chunk is skipped only when its bound
// is strictly greater than the running best of every query it covers, and
// equality keeps scanning, for ties.
//
// Design.
// - kR = 2 queries a thread, query r of a lane at warp_base + 32 r + lane,
//   so a warp holds 64 consecutive sorted queries. One broadcast float4 read
//   of a target from shared memory feeds two pairs. (Four a thread was
//   slower at every measured shape: a warp's box of 128 queries is looser,
//   so its votes scan more.)
// - The tie rule is off the per-pair path. A chunk of 32 targets is scanned
//   in ascending index by strict < into a chunk-local winner whose index is
//   the unrolled loop's own constant (a select of an immediate), so a pair
//   costs the 8 operations of d, a compare and two selects. The winner
//   merges into the running best once a chunk, by
//   d < best || (d == best && j < best_j). The strict-< scan returns the
//   lexicographic least (d, j) of its chunk, and the lexicographic min is
//   associative and commutative, so any visit order gives the full scan's
//   answer.
// - Skips by warp, not by block. Before a tile is scanned, a warp tests its
//   queries against the tile's box and then against each chunk's box
//   (point-to-box bounds, one __any_sync each): a warp skips what none of
//   its queries can reach. The block stages a tile only if some warp wants
//   it: each warp looks ahead along the visit order, 32 tiles a step, for
//   the next tile whose box lies within its box's reach of its largest best,
//   and the block takes the least step over its warps. Bests only fall, so a
//   tile no warp wants now is never wanted later.
// - Tiles are staged as float4s with 4-byte cp.async copies of the flat
//   float array (any alignment), in two buffers: the next tile's copies are
//   issued before the current tile is scanned, so the copy overlaps the
//   scan. The next tile is decided from the bests before that scan, so it
//   may turn out unneeded; its chunks are then skipped by the warps' votes.
//   Two barriers a staged tile, none for a tile no warp wants.
// - K8's order: the block sorts its (bound of the block's query box to each
//   tile's box, tile index) keys once, a bitonic sort in shared memory of
//   as many tiles as the keys fit (the wrapper widens the tile until they
//   do, ops/chamfer.py:_nn_tiles_fit); the ascending keys are the order of
//   a repeated argmin, least bound first and lowest index on equal bounds. A warp's
//   look-ahead ends at the first key whose bound exceeds its largest best
//   (every later key's bound is at least as large, and the block's box
//   holds the warp's, so its bound is no larger than the warp's own).
// - K7's order: from the tile whose z range reaches the block's middle
//   query's z (a 32-way search of the tiles' top z), wrapping.
//
// Bound on the H100: 8 fp32 operations a pair (3 differences, 3 squares, 2
// sums) plus the compare, over the pairs of the chunks the warps cannot
// skip; the bytes are 12 a point read and 8 a query written.
#pragma once

#include <cstdint>

#include <math_constants.h>

#include "common.cuh"

namespace rfnet {

constexpr int kR = 2;                    // queries a thread
constexpr int kChunk = 32;               // targets of a chunk, the finest skip
constexpr int kTilesMaxWarps = 8;        // warps a block at most
constexpr unsigned kTilesFull = 0xffffffffu;
// bytes of shared memory a block may have (static and dynamic), and the
// walk's static part (next_step and warp_box)
constexpr int kTilesMaxShared = 232448;
constexpr int kTilesStaticShared = kTilesMaxWarps * (1 + 6) * 4;

// Squared gap from a point to the box b (lo x y z, hi x y z), rounded as d.
__device__ __forceinline__ float point_box_bound(float qx, float qy, float qz, const float* b) {
  const float gx = fmaxf(fmaxf(__fsub_rn(b[0], qx), __fsub_rn(qx, b[3])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(b[1], qy), __fsub_rn(qy, b[4])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(b[2], qz), __fsub_rn(qz, b[5])), 0.f);
  return sq3(gx, gy, gz);
}

// Squared gap between the box q (of queries) and the box t, rounded as d.
__device__ __forceinline__ float box_box_bound(const float (&q)[6], const float* t) {
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g[a] = fmaxf(fmaxf(__fsub_rn(__ldg(t + a), q[3 + a]), __fsub_rn(q[a], __ldg(t + 3 + a))), 0.f);
  }
  return sq3(g[0], g[1], g[2]);
}

__device__ __forceinline__ void box_fold(float (&acc)[6], const float (&v)[6]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    acc[a] = fminf(acc[a], v[a]);
    acc[3 + a] = fmaxf(acc[3 + a], v[3 + a]);
  }
}

__device__ __forceinline__ void box_warp_reduce(float (&v)[6]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(kTilesFull, v[a], off));
      v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(kTilesFull, v[3 + a], off));
    }
  }
}

__device__ __forceinline__ void tiles_cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Starts copying targets [base, base + cnt) of the cloud t into buf as the
// x, y, z of float4s, and fills buf up to the next multiple of 32 with
// points at +inf (their d is +inf, which strict < never takes).
__device__ __forceinline__ void stage_tile(float4* buf, const float* t, int base, int cnt) {
  const float* src = t + 3 * static_cast<size_t>(base);
  float* dst = reinterpret_cast<float*>(buf);
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
    tiles_cp_async4(dst + 4 * k, src + 3 * k);
    tiles_cp_async4(dst + 4 * k + 1, src + 3 * k + 1);
    tiles_cp_async4(dst + 4 * k + 2, src + 3 * k + 2);
  }
  const int pad = (cnt + kChunk - 1) / kChunk * kChunk;
  for (int k = cnt + threadIdx.x; k < pad; k += blockDim.x) {
    buf[k] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One warp scans the staged tile `tile` (cnt targets from index base) for
// its kR queries a lane: the tile's box first, then chunk by chunk.
__device__ __forceinline__ void scan_tile(const float4* __restrict__ buf, int base, int cnt,
                                          const float* tbox, const float* cbox,
                                          const float (&qx)[kR], const float (&qy)[kR],
                                          const float (&qz)[kR], float (&best)[kR],
                                          int (&best_j)[kR]) {
  float box[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) box[a] = __ldg(tbox + a);
  bool want = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) want |= !(point_box_bound(qx[r], qy[r], qz[r], box) > best[r]);
  if (!__any_sync(kTilesFull, want)) return;
  for (int c = 0; c * kChunk < cnt; ++c) {
#pragma unroll
    for (int a = 0; a < 6; ++a) box[a] = __ldg(cbox + 6 * c + a);
    want = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) want |= !(point_box_bound(qx[r], qy[r], qz[r], box) > best[r]);
    if (!__any_sync(kTilesFull, want)) continue;
    // the chunk's first least d by strict < in ascending index; an
    // all-+inf chunk keeps (inf, its first target), its lexicographic least
    float cb[kR];
    int ck[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      cb[r] = CUDART_INF_F;
      ck[r] = 0;
    }
    const float4* p = buf + c * kChunk;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float4 v = p[u];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float d = sq3(__fsub_rn(qx[r], v.x), __fsub_rn(qy[r], v.y), __fsub_rn(qz[r], v.z));
        if (d < cb[r]) {
          cb[r] = d;
          ck[r] = u;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int j = base + c * kChunk + ck[r];
      if (cb[r] < best[r] || (cb[r] == best[r] && j < best_j[r])) {
        best[r] = cb[r];
        best_j[r] = j;
      }
    }
  }
}

// Grid (query blocks, b); blockDim 32 * warps; dynamic shared memory: two
// tile buffers of tile_m float4s, then (K8) sort_len 64-bit keys.
template <bool kBestFirst>
__global__ void __launch_bounds__(kTilesMaxWarps * 32)
nn_tiles_kernel(const float* __restrict__ query, const float* __restrict__ target,
                const float* __restrict__ chunk_boxes, const float* __restrict__ tile_boxes,
                int n, int m, int tile_m, int mt, int sort_len, float* __restrict__ dist,
                int* __restrict__ idx, int* __restrict__ visited) {
  extern __shared__ float4 smem[];
  __shared__ int next_step[kTilesMaxWarps];
  __shared__ float warp_box[kTilesMaxWarps][6];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + 2 * tile_m);

  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int mc = (m + kChunk - 1) / kChunk;
  const float* t = target + static_cast<size_t>(b) * m * 3;
  const float* cbox = chunk_boxes + static_cast<size_t>(b) * mc * 6;
  const float* tbox = tile_boxes + static_cast<size_t>(b) * mt * 6;
  const float inf = CUDART_INF_F;

  // kR queries a lane; a missing one has best -inf, so it never wants a tile
  // or a chunk, and stays out of the warp's box
  const int block_q0 = blockIdx.x * blockDim.x * kR;
  const int q0 = block_q0 + warp * 32 * kR + lane;
  float qx[kR], qy[kR], qz[kR], best[kR];
  int best_j[kR];
  float wbox[6] = {inf, inf, inf, -inf, -inf, -inf};
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + 32 * r;
    const bool live = i < n;
    const float* q = query + (static_cast<size_t>(b) * n + (live ? i : 0)) * 3;
    qx[r] = q[0];
    qy[r] = q[1];
    qz[r] = q[2];
    best[r] = live ? inf : -inf;
    best_j[r] = 0x7fffffff;
    if (live) {
      const float v[6] = {qx[r], qy[r], qz[r], qx[r], qy[r], qz[r]};
      box_fold(wbox, v);
    }
  }
  box_warp_reduce(wbox);

  int anchor = 0;
  if constexpr (kBestFirst) {
    // the block's box, its bound to every tile's box, and one sort of the
    // (bound, tile) keys: the visit order
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a) warp_box[warp][a] = wbox[a];
    }
    __syncthreads();
    float bbox[6] = {inf, inf, inf, -inf, -inf, -inf};
    for (int w = 0; w < warps; ++w) {
      float v[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) v[a] = warp_box[w][a];
      box_fold(bbox, v);
    }
    for (int k = threadIdx.x; k < sort_len; k += blockDim.x) {
      unsigned long long key = ~0ull;
      if (k < mt) {  // a bound is >= +0, so its bits order as the floats do
        key = (static_cast<unsigned long long>(__float_as_uint(box_box_bound(bbox, tbox + 6 * k)))
               << 32) | static_cast<unsigned>(k);
      }
      keys[k] = key;
    }
    __syncthreads();
    for (int span = 2; span <= sort_len; span <<= 1) {
      for (int j = span >> 1; j > 0; j >>= 1) {
        for (int k = threadIdx.x; k < sort_len; k += blockDim.x) {
          const int p = k ^ j;
          if (p > k) {
            const unsigned long long a = keys[k], c = keys[p];
            if ((a > c) == ((k & span) == 0)) {
              keys[k] = c;
              keys[p] = a;
            }
          }
        }
        __syncthreads();
      }
    }
  } else {
    // the first tile whose top z reaches the block's middle live query's z
    // (tiles of a z-sorted cloud have non-decreasing top z), by a 32-way
    // search of each warp; every warp finds the same tile
    const int last = min(block_q0 + static_cast<int>(blockDim.x) * kR, n) - 1;
    const float zmid = __ldg(query + (static_cast<size_t>(b) * n + (block_q0 + last) / 2) * 3 + 2);
    int lo = 0, hi = mt;
    while (lo < hi) {
      const int step = (hi - lo + 31) / 32;
      const int pos = lo + lane * step;
      const bool below = pos < hi && __ldg(tbox + 6 * pos + 5) < zmid;
      const int cnt = __popc(__ballot_sync(kTilesFull, below));
      if (cnt == 0) {
        hi = lo;
      } else {
        hi = min(hi, lo + cnt * step);
        lo += (cnt - 1) * step + 1;
      }
    }
    anchor = min(lo, mt - 1);
  }
  auto tile_at = [&](int s) -> int {
    if constexpr (kBestFirst) {
      return static_cast<int>(keys[s] & 0xffffffffu);
    } else {
      return anchor + s < mt ? anchor + s : anchor + s - mt;
    }
  };

  // the first step after `from` whose tile this warp may need, or mt
  auto warp_next = [&](int from) -> int {
    float wmax = -inf;
#pragma unroll
    for (int r = 0; r < kR; ++r) wmax = fmaxf(wmax, best[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wmax = fmaxf(wmax, __shfl_xor_sync(kTilesFull, wmax, off));
    }
    for (int s0 = from; s0 < mt; s0 += 32) {
      const int s = s0 + lane;
      bool want = false, past = false;
      if (s < mt) {
        int k;
        if constexpr (kBestFirst) {
          const unsigned long long key = keys[s];
          past = __uint_as_float(static_cast<unsigned>(key >> 32)) > wmax;
          k = static_cast<int>(key & 0xffffffffu);
        } else {
          k = tile_at(s);
        }
        want = !past && !(box_box_bound(wbox, tbox + 6 * k) > wmax);
      }
      const unsigned mask = __ballot_sync(kTilesFull, want);
      if (mask) return s0 + __ffs(mask) - 1;
      if (kBestFirst && __any_sync(kTilesFull, past)) return mt;
    }
    return mt;
  };

  // the walk: tile `cur` in buffer `stage` while the next one lands
  int cur = 0, stage = 0, scanned = 0;
  {
    const int k = tile_at(0);
    stage_tile(smem, t, k * tile_m, min(tile_m, m - k * tile_m));
  }
  for (;;) {
    const int mine = warp_next(cur + 1);
    if (lane == 0) next_step[warp] = mine;
    __syncthreads();  // also: every warp is done with the buffer refilled below
    int nxt = mt;
    for (int w = 0; w < warps; ++w) nxt = min(nxt, next_step[w]);
    if (nxt < mt) {
      const int k = tile_at(nxt);
      stage_tile(smem + (stage ^ 1) * tile_m, t, k * tile_m, min(tile_m, m - k * tile_m));
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty: tile `cur` is the older
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    ++scanned;
    const int k = tile_at(cur);
    scan_tile(smem + stage * tile_m, k * tile_m, min(tile_m, m - k * tile_m), tbox + 6 * k,
                 cbox + 6 * (k * (tile_m / kChunk)), qx, qy, qz, best, best_j);
    if (nxt >= mt) break;
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + 32 * r;
    if (i < n) {
      const size_t o = static_cast<size_t>(b) * n + i;
      dist[o] = best[r];
      idx[o] = best_j[r];
    }
  }
  if (threadIdx.x == 0) visited[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = scanned;
}

// Dynamic shared memory of one block: two tile buffers and, best-first,
// the keys (mirrored by ops/chamfer.py:_nn_tiles_shared).
inline size_t nn_tiles_shared_bytes(int tile_m, int sort_len) {
  return 2 * static_cast<size_t>(tile_m) * sizeof(float4) +
         static_cast<size_t>(sort_len) * sizeof(unsigned long long);
}

// Checks the plan (warps a block, targets a tile) and launches the box pass
// (chunk boxes, then tile boxes) and the walk. `boxes` is scratch of
// b * (ceil(m / 32) + ceil(m / tile_m)) * 6 floats: the chunk boxes, then
// the tile boxes. `visited` receives for each block the tiles it staged.
// Refuses a best-first plan whose tile buffers and keys do not fit shared
// memory (a tile of 128 targets holds up to 16 384 tiles, 2 097 152
// targets; the wrapper widens the tile for more).
template <bool kBestFirst>
int nn_tiles_launch(const void* query, const void* target, void* boxes, int b, int n, int m,
                    int warps, int tile_m, void* dist, void* idx, void* visited, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || tile_m < kChunk || tile_m % kChunk) {
    return cudaErrorInvalidValue;
  }
  if (warps < 1 || warps > kTilesMaxWarps || (warps & (warps - 1))) return cudaErrorInvalidValue;
  const int mt = (m + tile_m - 1) / tile_m, mc = (m + kChunk - 1) / kChunk;
  int sort_len = 0;
  if (kBestFirst) {
    sort_len = 1;
    while (sort_len < mt) sort_len <<= 1;
  }
  const size_t smem = nn_tiles_shared_bytes(tile_m, sort_len);
  if (smem > static_cast<size_t>(kTilesMaxShared - kTilesStaticShared)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = nn_tiles_kernel<kBestFirst>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(target);
  float* chunk_boxes = static_cast<float*>(boxes);
  float* tile_boxes = chunk_boxes + static_cast<size_t>(b) * mc * 6;
  cudaError_t e = run_boxes(t, b, m, kChunk, chunk_boxes, s);
  if (e != cudaSuccess) return e;
  if ((e = run_boxes(t, b, m, tile_m, tile_boxes, s)) != cudaSuccess) return e;
  const int per_block = 32 * warps * kR;
  kernel<<<dim3((n + per_block - 1) / per_block, b), 32 * warps, smem, s>>>(
      static_cast<const float*>(query), t, chunk_boxes, tile_boxes, n, m, tile_m, mt, sort_len,
      static_cast<float*>(dist), static_cast<int*>(idx), static_cast<int*>(visited));
  return cudaGetLastError();
}

}  // namespace rfnet

// K8: exact one-sided nearest-neighbour scan over Morton-sorted clouds that
// takes target tiles best-first by a box-to-box lower bound.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer_tile.py:nn_tile_pallas
// (body _make_kernel). Contract: both clouds are sorted along a space-filling
// (Morton) curve, so a run of consecutive points is a compact box, not a
// z-shell; `boxes` holds, for every tile of `tile_m` consecutive targets, the
// box [lo x y z, hi x y z] over its points. For every query it returns the
// least squared distance to the target cloud and the index (into the sorted
// target) of the nearest target, the lowest index winning ties. It is exact
// for any input order; the order only decides how much of the scan is
// skipped.
//
// Exactness. Distances are sums of squared differences rounded step by step
// (nn_tiles.cuh). A tile's bound for a block is the squared gap between the
// box of the block's queries and the tile's box: per axis
// max(tlo - qhi, qlo - thi, 0), squared and summed in the distance's own
// order. For a query q and a target t inside their boxes, where tlo > qhi
// the difference t - q is >= tlo - qhi, so by monotone rounding the rounded
// tlo - qhi is <= the rounded t - q = |q - t| (negation is exact), likewise
// for qlo > thi; squares of non-negative numbers and their sums are monotone
// too. So the bound never exceeds the rounded distance of any pair of the two
// boxes, and no slack is needed (the TPU kernel widens its break by 4 ulps
// because its bound and its |t|^2 - 2 q.t distances come from different op
// chains). The walk stops only when the least bound left is strictly greater
// than every live query's running best; equality keeps scanning, for ties.
// Whatever the visit order, `d < best || (d == best && j < best_j)` leaves
// the lowest index of the least distance, so the result equals the plain
// version's (ops/chamfer.py:_nn_sorted_plain) bit for bit.
//
// Design: one block per tile of consecutive Morton-sorted queries, one thread
// a query, grid (query tiles, b). The block reduces its live queries' box,
// writes the bound to every target tile into shared memory (any number of
// tiles), then loops: the block finds the tile of least bound, the lowest
// index on equal bounds (a visited tile's bound is set to +inf);
// __syncthreads_or over `bound <= my best` decides whether any live query can
// still gain, else the walk ends; the block loads the tile into shared
// memory, and each thread scans it unless its own point-to-box bound already
// exceeds its best. It stops in any case after all tiles. Threads past the
// end of the cloud take no part in the box nor in the vote, and every tile
// holds at least one real point, so nothing padded can be picked or veto the
// break. Bound on the H100: about 9 fp32 operations a visited pair.

#include "nn_tiles.cuh"

namespace {

using namespace rfnet;

constexpr int kWarps = kTileThreads / 32;

__global__ void __launch_bounds__(kTileThreads)
nn_tile_kernel(const float* __restrict__ query, const float* __restrict__ target,
               const float* __restrict__ boxes, int n, int m, int tile_m, int mt,
               float* __restrict__ dist, int* __restrict__ idx, int* __restrict__ visited) {
  extern __shared__ float4 shared[];
  float4* tile = shared;                                       // tile_m points
  float* bounds = reinterpret_cast<float*>(shared + tile_m);   // mt bounds
  __shared__ float warp_box[kWarps][6];
  __shared__ float warp_min[kWarps];
  __shared__ int warp_arg[kWarps];

  const int b = blockIdx.y, ni = blockIdx.x, nt = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int i = ni * blockDim.x + tid;
  const bool live = i < n;
  const float* t = target + static_cast<size_t>(b) * m * 3;
  const float* box = boxes + static_cast<size_t>(b) * mt * 6;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* q = query + (static_cast<size_t>(b) * n + i) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }

  // the box of the block's live queries
  float lo[3] = {live ? qx : CUDART_INF_F, live ? qy : CUDART_INF_F, live ? qz : CUDART_INF_F};
  float hi[3] = {live ? qx : -CUDART_INF_F, live ? qy : -CUDART_INF_F, live ? qz : -CUDART_INF_F};
  for (int off = 16; off > 0; off >>= 1) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if (lane == 0) {
    for (int a = 0; a < 3; ++a) {
      warp_box[warp][a] = lo[a];
      warp_box[warp][3 + a] = hi[a];
    }
  }
  __syncthreads();
  for (int w = 0; w < warps; ++w) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], warp_box[w][a]);
      hi[a] = fmaxf(hi[a], warp_box[w][3 + a]);
    }
  }

  // box-to-box bound to every target tile
  for (int k = tid; k < mt; k += blockDim.x) {
    const float* tb = box + 6 * k;
    float g[3];
    for (int a = 0; a < 3; ++a) {
      g[a] = fmaxf(fmaxf(__fsub_rn(__ldg(tb + a), hi[a]), __fsub_rn(lo[a], __ldg(tb + 3 + a))),
                   0.f);
    }
    bounds[k] = sq3(g[0], g[1], g[2]);
  }
  __syncthreads();

  float best = CUDART_INF_F;
  int best_j = 0x7fffffff;
  int scanned = 0;
  for (int round = 0; round < mt; ++round) {
    // the tile of least bound, the lowest index on equal bounds
    float v = CUDART_INF_F;
    int arg = 0x7fffffff;
    for (int k = tid; k < mt; k += blockDim.x) {
      const float bk = bounds[k];
      if (bk < v) {
        v = bk;
        arg = k;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ov < v || (ov == v && oa < arg)) {
        v = ov;
        arg = oa;
      }
    }
    if (lane == 0) {
      warp_min[warp] = v;
      warp_arg[warp] = arg;
    }
    __syncthreads();
    v = warp_min[0];
    arg = warp_arg[0];
    for (int w = 1; w < warps; ++w) {
      const float ov = warp_min[w];
      const int oa = warp_arg[w];
      if (ov < v || (ov == v && oa < arg)) {
        v = ov;
        arg = oa;
      }
    }
    // every tile visited (all bounds +inf), or no live query can still gain:
    // each one's best is below the least bound left
    if (arg == 0x7fffffff) break;
    if (!__syncthreads_or(live && !(v > best))) break;
    if (tid == 0) bounds[arg] = CUDART_INF_F;  // visited; seen after the next barrier
    const int base = arg * tile_m;
    const int cnt = min(tile_m, m - base);
    load_tile(tile, t, base, cnt);
    __syncthreads();
    ++scanned;
    if (live && !(point_box_bound(qx, qy, qz, box + 6 * arg) > best)) {
      scan_tile(tile, base, cnt, qx, qy, qz, best, best_j);
    }
    // the next round's two barriers come before the tile is loaded again
  }
  if (live) {
    const size_t o = static_cast<size_t>(b) * n + i;
    dist[o] = best;
    idx[o] = best_j;
  }
  if (tid == 0) visited[b * nt + ni] = scanned;
}

}  // namespace

// `visited` receives for each block (b, query tiles) the number of target
// tiles it loaded.
extern "C" int rfnet_nn_tile(const void* query, const void* target, const void* boxes, int b,
                             int n, int m, int tile_n, int tile_m, void* dist, void* idx,
                             void* visited, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || tile_m <= 0) return cudaErrorInvalidValue;
  if (tile_n < 32 || tile_n > kTileThreads || tile_n % 32) return cudaErrorInvalidValue;
  const int mt = (m + tile_m - 1) / tile_m;
  const size_t shared = static_cast<size_t>(tile_m) * sizeof(float4) + sizeof(float) * mt;
  if (shared > 227 * 1024) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nn_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + tile_n - 1) / tile_n, b);
  nn_tile_kernel<<<grid, tile_n, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target),
      static_cast<const float*>(boxes), n, m, tile_m, mt, static_cast<float*>(dist),
      static_cast<int*>(idx), static_cast<int*>(visited));
  return cudaGetLastError();
}

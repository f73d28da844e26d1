// K7: exact one-sided nearest-neighbour scan over z-sorted clouds that skips
// whole target tiles by a bounding-box lower bound.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer_pruned.py:
// nn_pruned_pallas (body _make_kernel). Contract: both clouds are sorted by
// z; `boxes` holds, for every tile of `tile_m` consecutive targets, the box
// [lo x y z, hi x y z] over its points. For every query it returns the least
// squared distance to the target cloud and the index (into the sorted
// target) of the nearest target, the lowest index winning ties.
//
// Exactness. Distances are sums of squared differences rounded step by step
// (nn_tiles.cuh), and a tile's bound for a query is the squared distance from
// the query to the tile's box, rounded through the same chain. By monotone
// rounding that bound never exceeds the rounded distance of any target in
// the tile (the argument is at point_box_bound), so there is no slack to
// add: a tile is skipped only when the bound is strictly greater than the
// query's running best, and equality keeps scanning, for ties. Whatever the
// visit order, `d < best || (d == best && j < best_j)` leaves the lowest
// index of the least distance. On the same z-sorted inputs the result equals
// K3's (nn_dyn.cu) and the plain version's (ops/chamfer.py:_nn_sorted_plain)
// bit for bit, distances and indices.
//
// Design: one block per tile of consecutive z-sorted queries, one thread a
// query, grid (query tiles, b). Target tiles are visited from the tile on
// the z-diagonal, (ni * mt) / nt, wrapping, so the running best is tight
// after the first visit. Each thread tests its own bound; __syncthreads_or
// decides whether the block loads the tile into shared memory at all (a real
// branch), and a thread whose own bound fails skips the inner scan. Ragged
// last tiles need no padding: the loops are bounded by n and m. Bound on the
// H100: about 9 fp32 operations a visited pair, so the operations of the
// visited tiles bound it wherever more than a few tiles are visited; the
// bytes are 12 a point read and 8 a query written.

#include "nn_tiles.cuh"

namespace {

using namespace rfnet;

__global__ void __launch_bounds__(kTileThreads)
nn_pruned_kernel(const float* __restrict__ query, const float* __restrict__ target,
                 const float* __restrict__ boxes, int n, int m, int tile_m, int mt,
                 float* __restrict__ dist, int* __restrict__ idx, int* __restrict__ visited) {
  extern __shared__ float4 tile[];
  const int b = blockIdx.y, ni = blockIdx.x, nt = gridDim.x;
  const int i = ni * blockDim.x + threadIdx.x;
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
  float best = CUDART_INF_F;
  int best_j = 0x7fffffff;
  const int anchor = static_cast<int>(static_cast<long long>(ni) * mt / nt);
  int scanned = 0;
  for (int step = 0; step < mt; ++step) {
    int phys = anchor + step;
    if (phys >= mt) phys -= mt;
    const bool want = live && !(point_box_bound(qx, qy, qz, box + 6 * phys) > best);
    // also the barrier after the previous tile's scan
    if (!__syncthreads_or(want)) continue;
    const int base = phys * tile_m;
    const int cnt = min(tile_m, m - base);
    load_tile(tile, t, base, cnt);
    __syncthreads();
    ++scanned;
    if (want) scan_tile(tile, base, cnt, qx, qy, qz, best, best_j);
  }
  if (live) {
    const size_t o = static_cast<size_t>(b) * n + i;
    dist[o] = best;
    idx[o] = best_j;
  }
  if (threadIdx.x == 0) visited[b * nt + ni] = scanned;
}

}  // namespace

// `visited` receives for each block (b, query tiles) the number of target
// tiles it loaded.
extern "C" int rfnet_nn_pruned(const void* query, const void* target, const void* boxes, int b,
                               int n, int m, int tile_n, int tile_m, void* dist, void* idx,
                               void* visited, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || tile_m <= 0) return cudaErrorInvalidValue;
  if (tile_n < 32 || tile_n > kTileThreads || tile_n % 32) return cudaErrorInvalidValue;
  const size_t shared = static_cast<size_t>(tile_m) * sizeof(float4);
  if (shared > 48 * 1024) return cudaErrorInvalidValue;
  const int mt = (m + tile_m - 1) / tile_m;
  const dim3 grid((n + tile_n - 1) / tile_n, b);
  nn_pruned_kernel<<<grid, tile_n, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target),
      static_cast<const float*>(boxes), n, m, tile_m, mt, static_cast<float*>(dist),
      static_cast<int*>(idx), static_cast<int*>(visited));
  return cudaGetLastError();
}

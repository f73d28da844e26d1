// K10: the k nearest neighbours of every query among the targets of its
// cloud (k = 16), nearest first, the lower index first among equal
// distances. SnowflakeNet's k-NN grouping (ops/knn.py), in its set
// abstractions and in its five point transformers.
//
// Contract. For every query q of a cloud, the K least (d_j, j) in
// lexicographic order over all targets t_j of the same cloud, where
//     d_j = (dx*dx + dy*dy) + dz*dz,   d = q - t_j
// each step rounded with no fused multiply-add: the plain version's
// (ops/knn.py:_knn_plain) operation order, so a point's distance to itself
// is exactly 0 and distances and indices agree with it bit for bit.
//
// Design. The targets are staged as nn_scan.cuh stages them: tiles of
// kKnnTile float4s in shared memory, through two buffers with 4-byte
// cp.async copies, the next tile's copies issued before the current tile is
// scanned. Each thread holds one query and its K best (d, j) in registers,
// sorted ascending. A target enters only where d < the K-th best; it is
// inserted after every held entry whose d is not greater, which keeps the
// lexicographic order because targets come in ascending index order. The
// insertion is a fixed, unrolled pass over the K slots (static register
// indices), one compare pair and two selects a slot.
//
// Bound. 8 fp32 operations a pair (3 sub, 3 mul, 2 add) and the compare;
// bytes are 12 a query and 12 a target read, 8 * K a query written. The
// insertions are data dependent: about K ln(m / K) a query for targets in
// random order, and a warp pays for each of its lanes' insertions.

#include "nn_scan.cuh"

namespace rfnet {

constexpr int kKnnThreads = 128;  // queries a CTA, one a thread
constexpr int kKnnTile = 1024;    // targets a staged tile (16 KiB a buffer)

template <int K>
__device__ __forceinline__ void knn_insert(float d, int j, float (&bd)[K], int (&bj)[K]) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool up = d < bd[s - 1];  // slot s takes slot s - 1's entry
    const bool here = d < bd[s];    // else the new entry, where it beats slot s
    bd[s] = up ? bd[s - 1] : (here ? d : bd[s]);
    bj[s] = up ? bj[s - 1] : (here ? j : bj[s]);
  }
  if (d < bd[0]) {
    bd[0] = d;
    bj[0] = j;
  }
}

// Grid (ceil(n / kKnnThreads), b); blockDim kKnnThreads; n queries, m >= K
// targets a cloud.
template <int K>
__global__ void __launch_bounds__(kKnnThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ target, int n, int m,
           float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 tiles[2][kKnnTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kKnnThreads + threadIdx.x;
  const float* t = target + static_cast<size_t>(b) * m * 3;
  const float* q = query + (static_cast<size_t>(b) * n + min(i, n - 1)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  float bd[K];
  int bj[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = __int_as_float(0x7f800000);  // +inf
    bj[s] = 0;
  }

  const int nt = (m + kKnnTile - 1) / kKnnTile;
  scan_stage(tiles[0], t, 0, min(kKnnTile, m));
  for (int k = 0; k < nt; ++k) {
    const int base = k * kKnnTile;
    const int cnt = min(kKnnTile, m - base);
    if (k + 1 < nt) {
      scan_stage(tiles[(k + 1) & 1], t, base + kKnnTile, min(kKnnTile, m - base - kKnnTile));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float4* cur = tiles[k & 1];
    for (int p = 0; p < cnt; ++p) {
      const float4 v = cur[p];
      const float d = sq3(__fsub_rn(qx, v.x), __fsub_rn(qy, v.y), __fsub_rn(qz, v.z));
      if (d < bd[K - 1]) knn_insert<K>(d, base + p, bd, bj);
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
  }

  if (i < n) {
    const size_t o = (static_cast<size_t>(b) * n + i) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      dist[o + s] = bd[s];
      idx[o + s] = bj[s];
    }
  }
}

}  // namespace rfnet

// query (b, n, 3) and target (b, m, 3) float32, contiguous; k must be 16 and
// m >= k; dist (b, n, k) float32 and idx (b, n, k) int32 out.
extern "C" int rfnet_knn(const void* query, const void* target, int b, int n, int m, int k,
                         void* dist, void* idx, void* stream) {
  constexpr int K = 16;
  if (b <= 0 || n <= 0 || k != K || m < K) return cudaErrorInvalidValue;
  const dim3 grid((n + rfnet::kKnnThreads - 1) / rfnet::kKnnThreads, b);
  rfnet::knn_kernel<K><<<grid, rfnet::kKnnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n, m,
      static_cast<float*>(dist), static_cast<int*>(idx));
  return cudaGetLastError();
}

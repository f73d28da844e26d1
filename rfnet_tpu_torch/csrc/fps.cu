// K1: farthest point sampling, the whole selection loop in one kernel.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/fps.py:fps_pallas (body
// _make_kernel). Semantics of rfnet_tpu/ops/fps.py:_fps_single: the first
// pick is index 0; every later pick is the argmax of the running minimum
// squared distance to the picked set (initialised to 1e38), the lowest index
// winning ties.
//
// Design: one block of 1024 threads per cloud. The running minimum lives in
// shared memory (4 bytes a point, so up to 58 044 points per cloud); the
// coordinates are read through the read-only cache each pass. Each pick is a
// block argmax: a per-thread scan over its strided points, a warp-shuffle
// reduction, then one warp over the 32 warp winners. The distance is
// (x-lx)^2 + (y-ly)^2 + (z-lz)^2 in that order without fused multiply-adds,
// so the picks equal the plain version's (ops/fps.py) exactly.
//
// Bound on the H100: 8 flops a point a pick and 12 bytes a point read once,
// both tiny at the serving shape (32 of 3000). The kernel is bound by the
// chain of npoint-1 dependent block reductions (two barriers each), i.e. by
// latency; one block per cloud also leaves most SMs idle at batch 4.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// better (value, index) under "larger value, then lower index"
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint, int* __restrict__ idx) {
  extern __shared__ float mind[];  // (n,) running min squared distance
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int picked;

  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* out = idx + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < n; i += kThreads) mind[i] = 1e38f;
  if (tid == 0) out[0] = 0;
  int last = 0;

  for (int j = 1; j < npoint; ++j) {
    const float lx = __ldg(pts + 3 * last);
    const float ly = __ldg(pts + 3 * last + 1);
    const float lz = __ldg(pts + 3 * last + 2);
    float bv = -FLT_MAX;
    int bi = 0x7fffffff;
    for (int i = tid; i < n; i += kThreads) {
      const float d = rfnet::sq3(__fsub_rn(__ldg(pts + 3 * i), lx),
                                 __fsub_rn(__ldg(pts + 3 * i + 1), ly),
                                 __fsub_rn(__ldg(pts + 3 * i + 2), lz));
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > bv) {  // i ascends, so strict > keeps this thread's lowest index
        bv = m;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                   __shfl_down_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      for (int off = 16; off > 0; off >>= 1)
        argmax_merge(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                     __shfl_down_sync(0xffffffffu, bi, off));
      if (lane == 0) {
        picked = bi;
        out[j] = bi;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

extern "C" int rfnet_fps(const void* xyz, int b, int n, int npoint, void* idx,
                         void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (b <= 0 || n <= 0 || npoint <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, npoint, static_cast<int*>(idx));
  return cudaGetLastError();
}

// The box pass that K6 (emd_cost.cu), K7 (nn_pruned.cu) and K8 (nn_tile.cu)
// run over their sorted clouds before their walks (common.cuh:run_boxes).
// Replaces the boxes the TPU wrappers compute outside their kernels
// (rfnet_tpu/ops/pallas/chamfer_pruned.py, chamfer_tile.py, emd.py); the
// plain version is ops/chamfer.py:_tile_boxes. Min and max are exact, so
// the boxes equal the plain version's bit for bit. Bound on the H100: the
// 12 bytes a point read once.

#include <math_constants.h>

#include "common.cuh"

namespace rfnet {
namespace {

constexpr int kThreads = 128;

// A warp a run: boxes[y][t] over points [t run, (t + 1) run) of cloud y.
__global__ void __launch_bounds__(kThreads)
run_boxes_kernel(const float* __restrict__ pts, int count, int run, int runs,
                 float* __restrict__ boxes) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= runs) return;
  const float* p = pts + static_cast<size_t>(blockIdx.y) * count * 3;
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  const int end = min(count, (t + 1) * run);
  for (int k = t * run + lane; k < end; k += 32) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = p[3 * static_cast<size_t>(k) + c];
      lo[c] = fminf(lo[c], v);
      hi[c] = fmaxf(hi[c], v);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int d = 16; d > 0; d >>= 1) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], d));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], d));
    }
  }
  if (lane == 0) {
    float* o = boxes + (static_cast<size_t>(blockIdx.y) * runs + t) * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = lo[c];
      o[3 + c] = hi[c];
    }
  }
}

}  // namespace

cudaError_t run_boxes(const float* pts, int b, int count, int run, float* boxes,
                      cudaStream_t stream) {
  const int runs = (count + run - 1) / run;
  constexpr int kPerBlock = kThreads / 32;
  run_boxes_kernel<<<dim3((runs + kPerBlock - 1) / kPerBlock, b), kThreads, 0, stream>>>(
      pts, count, run, runs, boxes);
  return cudaGetLastError();
}

}  // namespace rfnet

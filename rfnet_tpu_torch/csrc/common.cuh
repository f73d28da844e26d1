// Shared helpers of the package's kernels.
//
// Every floating-point step of a distance is written with a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn). The compiler never contracts
// those into fused multiply-adds, so each kernel rounds exactly where its
// plain PyTorch version (one elementwise op at a time) rounds, and the two
// agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace rfnet {

// (a*a + b*b) + c*c, rounded after every operation.
__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// (a0*b0 + a1*b1) + a2*b2, rounded after every operation.
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// Writes boxes (b, ceil(count / run), 6): [lo x y z, hi x y z] over every
// run of `run` consecutive points of each of b clouds of `count` points, a
// ragged last run covering its real points only. The one box pass of the
// spatially sorted kernels (boxes.cu): K6 takes runs of its tile, K7 and K8
// runs of 32 targets and of their tile.
cudaError_t run_boxes(const float* pts, int b, int count, int run, float* boxes,
                      cudaStream_t stream);

}  // namespace rfnet

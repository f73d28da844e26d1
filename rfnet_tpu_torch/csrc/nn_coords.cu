// K2: one-sided nearest-neighbour scan that also returns the neighbour.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer.py:nn_coords_pallas
// (body _make_coords_kernel). The scan, its rounding and its bound are in
// nn_scan.cuh, shared with K4 (nn_dense.cu); this entry also writes the
// argmin's coordinates, which the merge layer consumes.

#include "nn_scan.cuh"

extern "C" int rfnet_nn_coords(const void* query, const void* target, int b, int n,
                               int m, void* dist, void* idx, void* coords,
                               void* stream) {
  return rfnet::nn_scan_launch<true>(query, target, b, n, m, dist, idx, coords, stream);
}

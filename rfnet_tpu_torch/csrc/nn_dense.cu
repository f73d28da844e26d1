// K4: dense one-sided nearest-neighbour scan, distances and indices only.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer.py:nn_distance_pallas
// (body _kernel): the scan of e = |t|^2 - 2 q.t with strict < (first index
// wins ties), then max(e + |q|^2, 0) and the argmin. It is K2's scan without
// the coordinate gather (nn_scan.cuh holds the shared device code, its
// rounding and its bound); a separate entry point so that its launches are
// counted apart from the merge layer's. On the trainer's path it serves
// zero_groupnear at (32,1024)->(32,64) and (32,16384)->(32,1024).

#include "nn_scan.cuh"

extern "C" int rfnet_nn_dense(const void* query, const void* target, int b, int n, int m,
                              void* dist, void* idx, void* stream) {
  return rfnet::nn_scan_launch<false>(query, target, b, n, m, dist, idx, nullptr, stream);
}

// K9: the dense one-sided nearest-neighbour scan in four arithmetic and
// argmin variants, for the study tools/bench_chamfer_variants_torch.py.
//
// Replaces the TPU kernel of tools/bench_chamfer_variants.py:nn_variant
// (body make_kernel(fma, eq_argmin)): for every query the least e over the
// targets of its cloud, dist = max(e_best + |q|^2, 0) and the argmin, the
// lowest index winning ties.
//   fma = 0: e = |t|^2 - 2 ((tx qx + ty qy) + tz qz), each step rounded: K4's
//            contract and code (v0 and K4 agree bit for bit);
//   fma = 1: e = fma(mx, qx, fma(my, qy, fma(mz, qz, |t|^2))), m = -2t;
//   eq  = 1: the tile's least e first, then the lowest index that has it,
//            merged into the running best under strict <.
// It is K4's scan (nn_scan.cuh) with the two switches kFma and kEq, under
// K4's launch plan (ops/chamfer.py:_nn_scan_plan), so the variants' times
// differ from K4's by the variant alone. Bound on the H100: the issue rate,
// as K4's; kFma takes the dot product and the doubling from 5 FMUL/FADD and
// an FSUB to 3 FFMA a pair, kEq adds a second pass over every pair.

#include "nn_scan.cuh"

// The plan as for rfnet_nn_dense; fma and eq each 0 or 1 (another value is
// refused with cudaErrorInvalidValue).
extern "C" int rfnet_nn_variant(const void* query, const void* target, int b, int n, int m,
                                int per_thread, int groups, int warps, int cluster, int tiles,
                                int fma, int eq, void* dist, void* idx, void* stream) {
  const int variant = (fma == 0 || fma == 1) && (eq == 0 || eq == 1) ? 2 * fma + eq : -1;
  switch (variant) {
    case 0:
      return rfnet::nn_scan_launch<false, false, false>(query, target, b, n, m, per_thread,
                                                        groups, warps, cluster, tiles, dist, idx,
                                                        nullptr, stream);
    case 1:
      return rfnet::nn_scan_launch<false, false, true>(query, target, b, n, m, per_thread, groups,
                                                       warps, cluster, tiles, dist, idx, nullptr,
                                                       stream);
    case 2:
      return rfnet::nn_scan_launch<false, true, false>(query, target, b, n, m, per_thread, groups,
                                                       warps, cluster, tiles, dist, idx, nullptr,
                                                       stream);
    case 3:
      return rfnet::nn_scan_launch<false, true, true>(query, target, b, n, m, per_thread, groups,
                                                      warps, cluster, tiles, dist, idx, nullptr,
                                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K5: the chamfer backward's scatter, as a deterministic segmented sum.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/nn_grad.py:nn_grad_scatter
// (with its helper ops/pallas/exact_dot.py:onehot_select). For queries x1
// (b,n,3) with per-query scales g (b,n) and argmins idx (b,n) into a cloud
// of m targets it computes, exactly in fp32,
//     S_p[j] = sum_{i: idx[i]=j} g[i]*x1[i]   (b,m,3)
//     S_w[j] = sum_{i: idx[i]=j} g[i]         (b,m)
// The TPU kernel is a banded one-hot contraction on the matrix unit with a
// three-pass bf16 split of the payload, both there only because the TPU has
// no fast scatter and its matrix unit truncates fp32; neither is carried over.
//
// Design: the wrapper (ops/nn_grad.py) stable-sorts each row of idx, giving
// the sorted indices sidx and the query of each sorted slot (order), so the
// queries of a target form one run, in ascending query index. One thread per
// target binary-searches its run in sidx and sums g*x1 over it in that order,
// each product and sum rounded with no fused multiply-add. That is the order
// and rounding of the plain version (index_add_ into zeros on the CPU, which
// adds the rows one index after the other), so the two agree bit for bit, and
// the result does not change from run to run: no atomics anywhere.
//
// Bound on the H100: bytes. Each query's 3 coordinates, scale, index and
// slot are read once (24 bytes), each target's 4 sums written once (16
// bytes); 8 fp32 operations a query. The all-to-one index (every query on one
// target) serialises the sum on one thread: exact, and slow only there.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// first k in [0, n) with s[k] >= v (n if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ s, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(s + mid) < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
nn_grad_kernel(const float* __restrict__ x1, const float* __restrict__ g,
               const int* __restrict__ sidx, const long long* __restrict__ order, int n,
               int m, float* __restrict__ sp, float* __restrict__ sw) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const int* s = sidx + static_cast<size_t>(b) * n;
  const long long* o = order + static_cast<size_t>(b) * n;
  const float* xb = x1 + static_cast<size_t>(b) * n * 3;
  const float* gb = g + static_cast<size_t>(b) * n;
  const int lo = lower_bound(s, n, j);
  const int hi = lower_bound(s, n, j + 1);
  float px = 0.f, py = 0.f, pz = 0.f, w = 0.f;
  for (int k = lo; k < hi; ++k) {
    const long long q = __ldg(o + k);
    const float gq = __ldg(gb + q);
    px = __fadd_rn(px, __fmul_rn(gq, __ldg(xb + 3 * q)));
    py = __fadd_rn(py, __fmul_rn(gq, __ldg(xb + 3 * q + 1)));
    pz = __fadd_rn(pz, __fmul_rn(gq, __ldg(xb + 3 * q + 2)));
    w = __fadd_rn(w, gq);
  }
  const size_t t = static_cast<size_t>(b) * m + j;
  sp[3 * t] = px;
  sp[3 * t + 1] = py;
  sp[3 * t + 2] = pz;
  sw[t] = w;
}

}  // namespace

extern "C" int rfnet_nn_grad(const void* x1, const void* g, const void* sidx,
                             const void* order, int b, int n, int m, void* sp, void* sw,
                             void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  nn_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(g),
      static_cast<const int*>(sidx), static_cast<const long long*>(order), n, m,
      static_cast<float*>(sp), static_cast<float*>(sw));
  return cudaGetLastError();
}

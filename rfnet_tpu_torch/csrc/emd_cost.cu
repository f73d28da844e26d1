// K6: the plan-free approximate-EMD cost, the whole level recurrence.
//
// Replaces the TPU kernels of rfnet_tpu/ops/pallas/emd.py:
// approx_match_cost_pallas -> _approx_cost_pallas (sweeps _make_k2, _make_k3,
// _make_k31). Semantics of rfnet_tpu/ops/emd.py:approx_match_cost, which
// follows the reference GPU kernel's schedule: capacities multi_l, multi_r
// (integer division, computed by the caller); for the levels
// lambda = -4^j, j = 7..-1, and lambda = 0 at j = -2:
//     w_kl    = exp(lambda * d2_kl)
//     ratio_l = remain_l / (1e-9 + sum_l w_kl remain_r_l)
//     sumr_l  = (sum_k w_kl ratio_l_k) * remain_r_l
//     ratio_r = min(remain_r / (sumr + 1e-9), 1) * remain_r
//     remain_r = max(0, remain_r - sumr)
//     delta   = (w_kl ratio_l_k) ratio_r_l
//     cost   += sum delta * sqrt(d2);  remain_l = max(0, remain_l - sum_l delta)
// with d2 = max((|x1|^2 + |x2|^2) - 2 x1.x2, 0), the JAX package's expansion.
// Each term of it is symmetric in the two points, so the row and column
// sweeps see the same w for a pair.
//
// Design: three sweeps, each one thread per point of one cloud scanning every
// point of the other through shared memory (no band skipping: simple first):
//   emd_row_kernel<prev, cur>: one thread per query k. It finishes the previous level
//       (delta, its cost and remain_l) and starts the current one (ratio_l):
//       both need the same d2, so a level costs two sweeps, not three;
//   emd_col_kernel: one thread per target l: sumr, ratio_r and remain_r;
//   emd_reduce_kernel: one block per cloud sums the per-row costs.
// Every sum runs in a fixed order: a thread adds one tile (1024 points) into
// a tile partial and the partial into its total; the cost of a cloud is a
// block tree reduction of per-row sums carried across the levels. No atomics,
// so the cost is the same from run to run. exp is expf (not __expf): at
// lambda = -4^7 most pairs underflow to exactly 0, as the TPU kernel's band
// skip relies on. One call of the entry point runs the whole recurrence: 21
// sweeps and one reduction, all on the caller's stream.
//
// Bound on the H100: operations. The recurrence needs about 109 fp32
// operations a pair (d2 and its root once; then per level exp, the row and
// column sums, delta, its cost and its row sum), against bytes of only the
// two clouds and O(n + m) level state. This kernel spends more: each of its
// 21 sweeps recomputes d2 (about 9 operations) and one or two expf (some 10
// operations each) for every pair.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kLevels = 10;
// -4^j for j = 7 ... -1, then 0 (rfnet_tpu/ops/emd.py:_levels)
__constant__ float kLevelValue[kLevels] = {-16384.f, -4096.f, -1024.f, -256.f, -64.f,
                                           -16.f,    -4.f,    -1.f,    -0.25f, 0.f};

__device__ __forceinline__ float pair_d2(float s1, float s2, float cross) {
  return fmaxf(__fsub_rn(__fadd_rn(s1, s2), __fmul_rn(2.f, cross)), 0.f);
}

__global__ void emd_fill_kernel(float* __restrict__ p, size_t cnt, float v) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < cnt) p[i] = v;
}

// One thread per query k of x1. kPrev: finish level lvl_prev (cost, remain_l);
// kCur: start level lvl (ratio_l from the updated remain_l).
template <bool kPrev, bool kCur>
__global__ void __launch_bounds__(kThreads)
emd_row_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n, int m,
               int lvl_prev, int lvl, float* __restrict__ remain_l,
               float* __restrict__ ratio_l, float* __restrict__ rowcost,
               const float* __restrict__ remain_r, const float* __restrict__ ratio_r) {
  __shared__ float4 pts[kTile];
  __shared__ float2 vec[kTile];  // (ratio_r of lvl_prev, remain_r for lvl)
  const int b = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool live = k < n;
  const float* t = x2 + static_cast<size_t>(b) * m * 3;
  const float* rr = ratio_r + static_cast<size_t>(b) * m;
  const float* rm = remain_r + static_cast<size_t>(b) * m;
  const size_t o = static_cast<size_t>(b) * n + k;
  float qx = 0.f, qy = 0.f, qz = 0.f, rl_prev = 0.f;
  if (live) {
    qx = x1[3 * o];
    qy = x1[3 * o + 1];
    qz = x1[3 * o + 2];
    if (kPrev) rl_prev = ratio_l[o];
  }
  const float s1 = rfnet::sq3(qx, qy, qz);
  const float lp = kPrev ? kLevelValue[lvl_prev] : 0.f;
  const float lc = kCur ? kLevelValue[lvl] : 0.f;
  float cost = 0.f, used = 0.f, suml = 0.f;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float x = t[3 * (base + j)], y = t[3 * (base + j) + 1], z = t[3 * (base + j) + 2];
      pts[j] = make_float4(x, y, z, rfnet::sq3(x, y, z));
      vec[j] = make_float2(kPrev ? rr[base + j] : 0.f, kCur ? rm[base + j] : 0.f);
    }
    __syncthreads();
    if (!live) continue;
    float tc = 0.f, tu = 0.f, ts = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const float4 p = pts[j];
      const float d2 = pair_d2(s1, p.w, rfnet::dot3(qx, qy, qz, p.x, p.y, p.z));
      if (kPrev) {
        const float delta = __fmul_rn(__fmul_rn(expf(__fmul_rn(lp, d2)), rl_prev), vec[j].x);
        tc = __fadd_rn(tc, __fmul_rn(delta, sqrtf(d2)));
        tu = __fadd_rn(tu, delta);
      }
      if (kCur) ts = __fadd_rn(ts, __fmul_rn(expf(__fmul_rn(lc, d2)), vec[j].y));
    }
    cost = __fadd_rn(cost, tc);
    used = __fadd_rn(used, tu);
    suml = __fadd_rn(suml, ts);
  }
  if (!live) return;
  float rem = remain_l[o];
  if (kPrev) {
    rowcost[o] = __fadd_rn(rowcost[o], cost);
    rem = fmaxf(0.f, __fsub_rn(rem, used));
    remain_l[o] = rem;
  }
  if (kCur) ratio_l[o] = __fdiv_rn(rem, __fadd_rn(1e-9f, suml));
}

// One thread per target l of x2: the column sums of level lvl, then ratio_r
// and remain_r.
__global__ void __launch_bounds__(kThreads)
emd_col_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n, int m,
               int lvl, const float* __restrict__ ratio_l, float* __restrict__ remain_r,
               float* __restrict__ ratio_r) {
  __shared__ float4 pts[kTile];
  __shared__ float rls[kTile];
  const int b = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool live = l < m;
  const float* q = x1 + static_cast<size_t>(b) * n * 3;
  const float* rl = ratio_l + static_cast<size_t>(b) * n;
  const size_t o = static_cast<size_t>(b) * m + l;
  float tx = 0.f, ty = 0.f, tz = 0.f;
  if (live) {
    tx = x2[3 * o];
    ty = x2[3 * o + 1];
    tz = x2[3 * o + 2];
  }
  const float s2 = rfnet::sq3(tx, ty, tz);
  const float lc = kLevelValue[lvl];
  float acc = 0.f;
  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float x = q[3 * (base + j)], y = q[3 * (base + j) + 1], z = q[3 * (base + j) + 2];
      pts[j] = make_float4(x, y, z, rfnet::sq3(x, y, z));
      rls[j] = rl[base + j];
    }
    __syncthreads();
    if (!live) continue;
    float ts = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const float4 p = pts[j];
      const float d2 = pair_d2(p.w, s2, rfnet::dot3(p.x, p.y, p.z, tx, ty, tz));
      ts = __fadd_rn(ts, __fmul_rn(expf(__fmul_rn(lc, d2)), rls[j]));
    }
    acc = __fadd_rn(acc, ts);
  }
  if (!live) return;
  const float rem = remain_r[o];
  const float sumr = __fmul_rn(acc, rem);
  ratio_r[o] = __fmul_rn(fminf(__fdiv_rn(rem, __fadd_rn(sumr, 1e-9f)), 1.f), rem);
  remain_r[o] = fmaxf(0.f, __fsub_rn(rem, sumr));
}

constexpr int kReduceThreads = 1024;

// cost[b] = sum_k rowcost[b, k]: strided per-thread sums, then a tree.
__global__ void __launch_bounds__(kReduceThreads)
emd_reduce_kernel(const float* __restrict__ rowcost, int n, float* __restrict__ cost) {
  __shared__ float part[kReduceThreads];
  const float* r = rowcost + static_cast<size_t>(blockIdx.x) * n;
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += kReduceThreads) s = __fadd_rn(s, r[k]);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[blockIdx.x] = part[0];
}

int fill(float* p, size_t cnt, float v, cudaStream_t s) {
  emd_fill_kernel<<<static_cast<unsigned>((cnt + 255) / 256), 256, 0, s>>>(p, cnt, v);
  return cudaGetLastError();
}

}  // namespace

// Scratch (all float, caller-allocated): remain_l, ratio_l, rowcost (b, n);
// remain_r, ratio_r (b, m). Output cost (b,).
extern "C" int rfnet_emd_cost(const void* xyz1, const void* xyz2, int b, int n, int m,
                              float multi_l, float multi_r, void* remain_l, void* ratio_l,
                              void* rowcost, void* remain_r, void* ratio_r, void* cost,
                              void* stream) {
  if (b <= 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x1 = static_cast<const float*>(xyz1);
  const float* x2 = static_cast<const float*>(xyz2);
  float* rml = static_cast<float*>(remain_l);
  float* rtl = static_cast<float*>(ratio_l);
  float* rc = static_cast<float*>(rowcost);
  float* rmr = static_cast<float*>(remain_r);
  float* rtr = static_cast<float*>(ratio_r);
  const size_t bn = static_cast<size_t>(b) * n, bm = static_cast<size_t>(b) * m;
  int err;
  if ((err = fill(rml, bn, multi_l, s)) || (err = fill(rtl, bn, 0.f, s)) ||
      (err = fill(rc, bn, 0.f, s)) || (err = fill(rmr, bm, multi_r, s)) ||
      (err = fill(rtr, bm, 0.f, s)))
    return err;
  const dim3 rows((n + kThreads - 1) / kThreads, b), cols((m + kThreads - 1) / kThreads, b);
  emd_row_kernel<false, true><<<rows, kThreads, 0, s>>>(x1, x2, n, m, 0, 0, rml, rtl, rc, rmr,
                                                        rtr);
  if ((err = cudaGetLastError())) return err;
  for (int j = 0; j < kLevels; ++j) {
    emd_col_kernel<<<cols, kThreads, 0, s>>>(x1, x2, n, m, j, rtl, rmr, rtr);
    if ((err = cudaGetLastError())) return err;
    if (j + 1 < kLevels)
      emd_row_kernel<true, true><<<rows, kThreads, 0, s>>>(x1, x2, n, m, j, j + 1, rml, rtl,
                                                           rc, rmr, rtr);
    else
      emd_row_kernel<true, false><<<rows, kThreads, 0, s>>>(x1, x2, n, m, j, 0, rml, rtl, rc,
                                                            rmr, rtr);
    if ((err = cudaGetLastError())) return err;
  }
  emd_reduce_kernel<<<b, kReduceThreads, 0, s>>>(rc, n, static_cast<float*>(cost));
  return cudaGetLastError();
}

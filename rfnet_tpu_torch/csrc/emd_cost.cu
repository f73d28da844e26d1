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
// The same chain of operations gives d2 in the row and the column sweeps, so
// both see the same w for a pair.
//
// Bound on the H100: operations. The recurrence needs about 109 fp32
// operations a pair against bytes of only the two clouds and O(n + m) level
// state, and every sweep must recompute d2 and w: nothing of size n*m is
// kept. So the design spends as few issue slots a pair as it can and skips
// the pairs whose weight is exactly zero:
//
// * Both clouds arrive spatially sorted (Morton order, ops/emd.py); a first
//   kernel takes a box over every run of kTile points. A sweep gives a
//   thread kQ points of one cloud and walks the other cloud tile by tile through shared memory; a
//   warp (64 consecutive points, its own box) skips a tile when even the gap
//   between the two boxes puts every pair's weight at exactly zero, and the
//   block skips loading a tile all its warps skip. w = 2^(lambda*log2(e)*d2)
//   is taken with ex2.approx.ftz, which returns exactly 0 below 2^-126; the
//   rule skips only where the argument is under -128 even after the rounding
//   error of the expansion (at most 2^-19 (|a|^2 + |b|^2), taken from the
//   boxes), so a skipped pair would have added +0 to every sum and skipping
//   changes no bit of the result (the entry's `band_skip` flag turns the
//   rule off to show just that).
// * A fused row sweep ends level j (delta, cost, remain_l) and starts level
//   j+1 (ratio_l) from one d2. Its band is that of level j+1, the wider one.
//   lambda_j = 4 lambda_{j+1}, so w_j = (w_{j+1}^2)^2: two multiplications in
//   place of a second exponential. ratio_l of a row and
//   ratio_r's factor are constant along a row, so they multiply the row's
//   sums once, not every pair. sqrt(d2) is sqrt.approx.
// * At the last level lambda = 0 and w = 1: its sweeps take no exponential.
// * d2 is three fused multiply-adds on targets stored as (-2x, -2y, -2z,
//   |p|^2) float4 in shared memory: one 16-byte read serves kQ pairs.
// * 128 threads of kQ = 2 points a block, two independent chains a thread,
//   and the walk over the other cloud's tiles split over `parts` blocks (the
//   wrapper picks parts so that every SM holds some eight blocks): how much
//   a block can skip varies widely, and many short blocks an SM even that
//   out where one long block an SM would wait for the slowest. A small
//   kernel after every sweep adds the parts' sums in order and updates the
//   level state.
// One call runs 1 init, 2 box kernels, 20 sweeps over the pairs, each with
// its update, and 1 reduction on the caller's stream. Every sum runs in a
// fixed order: a thread adds one tile into a tile partial and the partial
// into its part's total, the parts are added in order; the cost of a cloud is
// a block tree reduction of per-row sums carried across the levels. No
// floating-point atomics, so the cost is the same from run to run.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 2;                   // points of its own cloud a thread holds
constexpr int kRows = kThreads * kQ;    // points a block holds
constexpr int kTile = 128;              // points of the other cloud a tile, and a box
constexpr int kLevels = 10;
constexpr double kLog2e = 1.4426950408889634;
constexpr float kZeroArg = 128.f;       // ex2.approx.ftz(x) == 0 for x < -126
constexpr float kSlack = 1.9073486328125e-06f;  // 2^-19
// -4^j for j = 7 ... -1, then 0 (rfnet_tpu/ops/emd.py:_levels)
const double kLevelValue[kLevels] = {-16384., -4096., -1024., -256., -64.,
                                     -16.,    -4.,    -1.,    -0.25, 0.};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float root(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Box {
  float lo[3], hi[3];
};

// sum over the axes of the largest squared coordinate in the box
__device__ __forceinline__ float box_r2(const Box& a) {
  return rfnet::sq3(fmaxf(fabsf(a.lo[0]), fabsf(a.hi[0])), fmaxf(fabsf(a.lo[1]), fabsf(a.hi[1])),
                    fmaxf(fabsf(a.lo[2]), fabsf(a.hi[2])));
}

// True where every pair of a point in box a and a point in box t has weight
// exactly 0 at the level with lam2 = lambda * log2(e) < 0.
__device__ __forceinline__ bool band_skips(const Box& a, float a_r2, const float* __restrict__ t,
                                           float lam2) {
  Box o;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.lo[c] = __ldg(t + c);
    o.hi[c] = __ldg(t + 3 + c);
  }
  const float gx = fmaxf(fmaxf(__fsub_rn(o.lo[0], a.hi[0]), __fsub_rn(a.lo[0], o.hi[0])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(o.lo[1], a.hi[1]), __fsub_rn(a.lo[1], o.hi[1])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(o.lo[2], a.hi[2]), __fsub_rn(a.lo[2], o.hi[2])), 0.f);
  const float gap2 = rfnet::sq3(gx, gy, gz);
  const float safe = __fsub_rn(gap2, __fmul_rn(kSlack, __fadd_rn(a_r2, box_r2(o))));
  return __fmul_rn(safe, -lam2) > kZeroArg;
}

// What a thread knows of its own kQ points, its warp's box and its block's.
struct Own {
  float x[kQ], y[kQ], z[kQ], s[kQ];
  bool live[kQ];
  bool warp_live;
  Box wbox, bbox;
  float wr2, br2;
};

// Loads points first + lane + 32 q (q < kQ) of the warp's 64 consecutive
// points and reduces the boxes. All threads of the block call it.
__device__ __forceinline__ void load_own(Own& me, const float* __restrict__ pts, int first,
                                         int count) {
  __shared__ float wb[kThreads / 32][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Box w;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w.lo[c] = CUDART_INF_F;
    w.hi[c] = -CUDART_INF_F;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int k = first + warp * 32 * kQ + 32 * q + lane;
    me.live[q] = k < count;
    me.x[q] = me.y[q] = me.z[q] = 0.f;
    if (me.live[q]) {
      me.x[q] = pts[3 * static_cast<size_t>(k)];
      me.y[q] = pts[3 * static_cast<size_t>(k) + 1];
      me.z[q] = pts[3 * static_cast<size_t>(k) + 2];
      w.lo[0] = fminf(w.lo[0], me.x[q]);
      w.hi[0] = fmaxf(w.hi[0], me.x[q]);
      w.lo[1] = fminf(w.lo[1], me.y[q]);
      w.hi[1] = fmaxf(w.hi[1], me.y[q]);
      w.lo[2] = fminf(w.lo[2], me.z[q]);
      w.hi[2] = fmaxf(w.hi[2], me.z[q]);
    }
    me.s[q] = rfnet::sq3(me.x[q], me.y[q], me.z[q]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int d = 16; d > 0; d >>= 1) {
      w.lo[c] = fminf(w.lo[c], __shfl_xor_sync(0xffffffffu, w.lo[c], d));
      w.hi[c] = fmaxf(w.hi[c], __shfl_xor_sync(0xffffffffu, w.hi[c], d));
    }
  }
  me.wbox = w;
  me.warp_live = first + warp * 32 * kQ < count;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wb[warp][c] = w.lo[c];
      wb[warp][3 + c] = w.hi[c];
    }
  }
  __syncthreads();
  me.bbox = w;
  for (int v = 0; v < kThreads / 32; ++v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      me.bbox.lo[c] = fminf(me.bbox.lo[c], wb[v][c]);
      me.bbox.hi[c] = fmaxf(me.bbox.hi[c], wb[v][3 + c]);
    }
  }
  me.wr2 = box_r2(me.wbox);
  me.br2 = box_r2(me.bbox);
}

// The block copies points [base, base + cnt) of the other cloud into shared
// memory as (-2x, -2y, -2z, |p|^2).
__device__ __forceinline__ void load_tile(float4* __restrict__ tile, const float* __restrict__ t,
                                          int base, int cnt) {
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const float* p = t + 3 * static_cast<size_t>(base + j);
    const float x = p[0], y = p[1], z = p[2];
    tile[j] = make_float4(-2.f * x, -2.f * y, -2.f * z, rfnet::sq3(x, y, z));
  }
}

// d2 of own point q and a tile point; the same chain in both sweeps.
__device__ __forceinline__ float pair_d2(const Own& me, int q, const float4& p) {
  const float e = fmaf(me.x[q], p.x, fmaf(me.y[q], p.y, __fmul_rn(me.z[q], p.z)));
  return fmaxf(__fadd_rn(__fadd_rn(me.s[q], p.w), e), 0.f);
}

// boxes[t] = [lo x y z, hi x y z] over points [t kTile, (t+1) kTile) of a
// cloud of `count` points: a warp a tile.
__global__ void __launch_bounds__(kThreads)
emd_boxes_kernel(const float* __restrict__ pts, int count, int tiles, float* __restrict__ boxes) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const float* p = pts + static_cast<size_t>(blockIdx.y) * count * 3;
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int k = tile * kTile + lane; k < min(count, (tile + 1) * kTile); k += 32) {
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
    float* o = boxes + (static_cast<size_t>(blockIdx.y) * tiles + tile) * 6;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = lo[c];
      o[3 + c] = hi[c];
    }
  }
}

__global__ void emd_init_kernel(float* __restrict__ remain_l, float* __restrict__ rowcost,
                                float* __restrict__ remain_r, size_t bn, size_t bm, float multi_l,
                                float multi_r) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < bn) {
    remain_l[i] = multi_l;
    rowcost[i] = 0.f;
  }
  if (i < bm) remain_r[i] = multi_r;
}

// Weight modes of a row sweep's two halves.
constexpr int kNone = 0;   // the half is absent
constexpr int kExp = 1;    // w = 2^(lam2 * d2)
constexpr int kPow4 = 2;   // w = (w_cur^2)^2, the previous level's from the current one's
constexpr int kUnit = 3;   // lambda = 0: w = 1

// Tiles [lo, hi) of the `tiles` of the walked cloud that part blockIdx.z of
// gridDim.z takes.
__device__ __forceinline__ void part_range(int tiles, int& lo, int& hi) {
  const int per = (tiles + gridDim.z - 1) / gridDim.z;
  lo = min(tiles, static_cast<int>(blockIdx.z) * per);
  hi = min(tiles, lo + per);
}

// A thread holds kQ queries of x1 and walks its part of x2's tiles. kPrev:
// the sums that finish the previous level (cost, remain_l), with ratio_r of
// that level; kCur: the sum that starts the current one (ratio_l). band2 < 0:
// the lam2 whose band bounds the sweep; 0: no skipping. The sums of the part
// go to part_sums[(3 part + {0: cost, 1: used, 2: suml}) b n + ...].
template <int kPrev, int kCur>
__global__ void __launch_bounds__(kThreads)
emd_row_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
               const float* __restrict__ boxes2, int n, int m, float lam_prev2, float lam_cur2,
               float band2, const float* __restrict__ remain_r,
               const float* __restrict__ ratio_r, float* __restrict__ part_sums) {
  __shared__ float4 pts[kTile];
  __shared__ float2 vec[kTile];  // (ratio_r of the previous level, remain_r for the current)
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kRows;
  Own me;
  load_own(me, x1 + static_cast<size_t>(b) * n * 3, first, n);
  const float* t = x2 + static_cast<size_t>(b) * m * 3;
  const float* rr = ratio_r + static_cast<size_t>(b) * m;
  const float* rm = remain_r + static_cast<size_t>(b) * m;
  const int mt = (m + kTile - 1) / kTile;
  const float* boxes = boxes2 + static_cast<size_t>(b) * mt * 6;
  int tile_lo, tile_hi;
  part_range(mt, tile_lo, tile_hi);
  float cost[kQ], used[kQ], suml[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) cost[q] = used[q] = suml[q] = 0.f;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int base = tile * kTile;
    const int cnt = min(kTile, m - base);
    if (band2 < 0.f && band_skips(me.bbox, me.br2, boxes + 6 * tile, band2)) continue;
    __syncthreads();
    load_tile(pts, t, base, cnt);
    for (int j = threadIdx.x; j < cnt; j += kThreads)
      vec[j] = make_float2(kPrev ? rr[base + j] : 0.f, kCur ? rm[base + j] : 0.f);
    __syncthreads();
    if (!me.warp_live) continue;
    if (band2 < 0.f && band_skips(me.wbox, me.wr2, boxes + 6 * tile, band2)) continue;
    float tc[kQ], tu[kQ], ts[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) tc[q] = tu[q] = ts[q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 p = pts[j];
      const float2 v = vec[j];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float d2 = pair_d2(me, q, p);
        float w = 1.f;
        if (kCur == kExp) {
          w = ex2(__fmul_rn(d2, lam_cur2));
          ts[q] = fmaf(w, v.y, ts[q]);
        } else if (kCur == kUnit) {
          ts[q] = __fadd_rn(ts[q], v.y);
        }
        if (kPrev != kNone) {
          float wp = 1.f;
          if (kPrev == kPow4) {
            const float w2 = __fmul_rn(w, w);
            wp = __fmul_rn(w2, w2);
          } else if (kPrev == kExp) {
            wp = ex2(__fmul_rn(d2, lam_prev2));
          }
          const float a = __fmul_rn(wp, v.x);
          tu[q] = __fadd_rn(tu[q], a);
          tc[q] = fmaf(a, root(d2), tc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      cost[q] = __fadd_rn(cost[q], tc[q]);
      used[q] = __fadd_rn(used[q], tu[q]);
      suml[q] = __fadd_rn(suml[q], ts[q]);
    }
  }
  const size_t bn = static_cast<size_t>(gridDim.y) * n;
  float* out = part_sums + 3 * blockIdx.z * bn;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (!me.live[q]) continue;
    const size_t o = static_cast<size_t>(b) * n + first + warp * 32 * kQ + 32 * q + lane;
    if (kPrev != kNone) {
      out[o] = cost[q];
      out[bn + o] = used[q];
    }
    if (kCur != kNone) out[2 * bn + o] = suml[q];
  }
}

// The parts' sums added in order, then the level's update of one query.
template <bool kPrev, bool kCur>
__global__ void emd_row_update_kernel(const float* __restrict__ part_sums, int parts, size_t bn,
                                      float* __restrict__ remain_l, float* __restrict__ ratio_l,
                                      float* __restrict__ rowcost) {
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= bn) return;
  float cost = 0.f, used = 0.f, suml = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float* s = part_sums + 3 * p * bn;
    if (kPrev) {
      cost = __fadd_rn(cost, s[o]);
      used = __fadd_rn(used, s[bn + o]);
    }
    if (kCur) suml = __fadd_rn(suml, s[2 * bn + o]);
  }
  float rem = remain_l[o];
  if (kPrev) {
    const float rl = ratio_l[o];
    rowcost[o] = __fadd_rn(rowcost[o], __fmul_rn(rl, cost));
    rem = fmaxf(0.f, __fsub_rn(rem, __fmul_rn(rl, used)));
    remain_l[o] = rem;
  }
  if (kCur) ratio_l[o] = __fdiv_rn(rem, __fadd_rn(1e-9f, suml));
}

// A thread holds kQ targets of x2 and walks its part of x1's tiles: the
// column sums of one level, to part_sums[part b m + ...]. kUnitWeight:
// lambda = 0.
template <bool kUnitWeight>
__global__ void __launch_bounds__(kThreads)
emd_col_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
               const float* __restrict__ boxes1, int n, int m, float lam2, float band2,
               const float* __restrict__ ratio_l, float* __restrict__ part_sums) {
  __shared__ float4 pts[kTile];
  __shared__ float rls[kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kRows;
  Own me;
  load_own(me, x2 + static_cast<size_t>(b) * m * 3, first, m);
  const float* qpts = x1 + static_cast<size_t>(b) * n * 3;
  const float* rl = ratio_l + static_cast<size_t>(b) * n;
  const int nt = (n + kTile - 1) / kTile;
  const float* boxes = boxes1 + static_cast<size_t>(b) * nt * 6;
  int tile_lo, tile_hi;
  part_range(nt, tile_lo, tile_hi);
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int base = tile * kTile;
    const int cnt = min(kTile, n - base);
    if (band2 < 0.f && band_skips(me.bbox, me.br2, boxes + 6 * tile, band2)) continue;
    __syncthreads();
    load_tile(pts, qpts, base, cnt);
    for (int j = threadIdx.x; j < cnt; j += kThreads) rls[j] = rl[base + j];
    __syncthreads();
    if (!me.warp_live) continue;
    if (band2 < 0.f && band_skips(me.wbox, me.wr2, boxes + 6 * tile, band2)) continue;
    float ts[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) ts[q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 p = pts[j];
      const float r = rls[j];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (kUnitWeight) ts[q] = __fadd_rn(ts[q], r);
        else ts[q] = fmaf(ex2(__fmul_rn(pair_d2(me, q, p), lam2)), r, ts[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] = __fadd_rn(acc[q], ts[q]);
  }
  float* out = part_sums + blockIdx.z * static_cast<size_t>(gridDim.y) * m;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (!me.live[q]) continue;
    out[static_cast<size_t>(b) * m + first + warp * 32 * kQ + 32 * q + lane] = acc[q];
  }
}

// The parts' column sums added in order, then ratio_r and remain_r.
__global__ void emd_col_update_kernel(const float* __restrict__ part_sums, int parts, size_t bm,
                                      float* __restrict__ remain_r, float* __restrict__ ratio_r) {
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= bm) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc = __fadd_rn(acc, part_sums[p * bm + o]);
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

}  // namespace

// xyz1 (b, n, 3) and xyz2 (b, m, 3) spatially sorted. parts: the blocks that
// share the walk over the other cloud's tiles. Scratch (all float,
// caller-allocated): boxes1 (b, ceil(n/tile), 6) and boxes2 (b, ceil(m/tile),
// 6), tile == 128, filled here with [lo x y z, hi x y z] over each run of
// `tile` points; remain_l, ratio_l, rowcost (b, n); remain_r, ratio_r (b, m);
// part_sums (parts, max(3 b n, b m)). Output cost (b,). band_skip == 0 turns
// the skip rule off, for the tests that show the result's bits do not depend
// on it.
extern "C" int rfnet_emd_cost(const void* xyz1, const void* xyz2, void* boxes1, void* boxes2,
                              int b, int n, int m, int tile, int parts, float multi_l,
                              float multi_r, void* remain_l, void* ratio_l, void* rowcost,
                              void* remain_r, void* ratio_r, void* part_sums, void* cost,
                              int band_skip, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || tile != kTile || parts <= 0 || parts > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x1 = static_cast<const float*>(xyz1);
  const float* x2 = static_cast<const float*>(xyz2);
  float* b1 = static_cast<float*>(boxes1);
  float* b2 = static_cast<float*>(boxes2);
  float* rml = static_cast<float*>(remain_l);
  float* rtl = static_cast<float*>(ratio_l);
  float* rc = static_cast<float*>(rowcost);
  float* rmr = static_cast<float*>(remain_r);
  float* rtr = static_cast<float*>(ratio_r);
  float* ps = static_cast<float*>(part_sums);
  const size_t bn = static_cast<size_t>(b) * n, bm = static_cast<size_t>(b) * m;
  const size_t most = bn > bm ? bn : bm;
  float lam2[kLevels];
  for (int j = 0; j < kLevels; ++j) lam2[j] = static_cast<float>(kLevelValue[j] * kLog2e);
  auto band = [&](int j) { return band_skip ? lam2[j] : 0.f; };
  const unsigned row_blocks = static_cast<unsigned>((bn + 255) / 256);
  const unsigned col_blocks = static_cast<unsigned>((bm + 255) / 256);
  int err;
  emd_init_kernel<<<static_cast<unsigned>((most + 255) / 256), 256, 0, s>>>(rml, rc, rmr, bn, bm,
                                                                            multi_l, multi_r);
  if ((err = cudaGetLastError())) return err;
  const int nt = (n + kTile - 1) / kTile, mt = (m + kTile - 1) / kTile;
  constexpr int kBoxTiles = kThreads / 32;
  emd_boxes_kernel<<<dim3((nt + kBoxTiles - 1) / kBoxTiles, b), kThreads, 0, s>>>(x1, n, nt, b1);
  if ((err = cudaGetLastError())) return err;
  emd_boxes_kernel<<<dim3((mt + kBoxTiles - 1) / kBoxTiles, b), kThreads, 0, s>>>(x2, m, mt, b2);
  if ((err = cudaGetLastError())) return err;
  const dim3 rows((n + kRows - 1) / kRows, b, parts), cols((m + kRows - 1) / kRows, b, parts);
  emd_row_kernel<kNone, kExp><<<rows, kThreads, 0, s>>>(x1, x2, b2, n, m, 0.f, lam2[0], band(0),
                                                        rmr, rtr, ps);
  emd_row_update_kernel<false, true><<<row_blocks, 256, 0, s>>>(ps, parts, bn, rml, rtl, rc);
  if ((err = cudaGetLastError())) return err;
  for (int j = 0; j < kLevels; ++j) {
    const bool last = j + 1 == kLevels;
    if (last)
      emd_col_kernel<true><<<cols, kThreads, 0, s>>>(x1, x2, b1, n, m, 0.f, 0.f, rtl, ps);
    else
      emd_col_kernel<false><<<cols, kThreads, 0, s>>>(x1, x2, b1, n, m, lam2[j], band(j), rtl,
                                                      ps);
    emd_col_update_kernel<<<col_blocks, 256, 0, s>>>(ps, parts, bm, rmr, rtr);
    if ((err = cudaGetLastError())) return err;
    if (last) {
      emd_row_kernel<kUnit, kNone><<<rows, kThreads, 0, s>>>(x1, x2, b2, n, m, 0.f, 0.f, 0.f, rmr,
                                                             rtr, ps);
      emd_row_update_kernel<true, false><<<row_blocks, 256, 0, s>>>(ps, parts, bn, rml, rtl, rc);
    } else {
      if (j + 2 == kLevels)  // the next level has lambda = 0: no band
        emd_row_kernel<kExp, kUnit><<<rows, kThreads, 0, s>>>(x1, x2, b2, n, m, lam2[j], 0.f, 0.f,
                                                              rmr, rtr, ps);
      else
        emd_row_kernel<kPow4, kExp><<<rows, kThreads, 0, s>>>(x1, x2, b2, n, m, lam2[j],
                                                              lam2[j + 1], band(j + 1), rmr, rtr,
                                                              ps);
      emd_row_update_kernel<true, true><<<row_blocks, 256, 0, s>>>(ps, parts, bn, rml, rtl, rc);
    }
    if ((err = cudaGetLastError())) return err;
  }
  emd_reduce_kernel<<<b, kReduceThreads, 0, s>>>(rc, n, static_cast<float*>(cost));
  return cudaGetLastError();
}

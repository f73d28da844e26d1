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
// Contract: every product and sum is rounded once (no fused multiply-add)
// and the queries of a target are added in ascending query index, from zero.
// That is the order and rounding of the plain version (index_add_ into zeros
// on the CPU), so the two agree bit for bit for any idx, and the result does
// not change from run to run: the only atomics are integer counters, whose
// results do not depend on the order they arrive in. An index outside [0, m)
// is ignored.
//
// Bound on the H100: bytes. Each query's 3 coordinates, scale and index are
// read once (20 bytes), each target's 4 sums written once (16 bytes); 8 fp32
// operations a query. What costs time is grouping the queries by target and
// the latency of dependent loads, so the design keeps the grouping in shared
// memory and lets no load wait for a sum:
//
// One block of 1024 threads owns one cloud, or one of `parts` equal ranges of
// a cloud's targets where the clouds are fewer than the card's SMs (the
// wrapper picks parts); it reads every index of the cloud and keeps those in
// its range. Its shared memory holds one counter per target of the range
// (cur) and one slot per query (ord[n]); where these exceed what a block
// may have, both live in a global scratch row instead and the same code runs
// on them.
//   1. count: cur[idx[i]] += 1 with integer atomics in shared memory; a warp
//      whose 32 queries share one index adds 32 once, so that an index every
//      query shares costs n/32 atomics, not n;
//   2. scan: cur becomes the exclusive prefix sum, the start of each run
//      (each warp scans a contiguous piece 32 counters at a time);
//   3. place: every query takes the next free slot of its run with an atomic
//      on cur and writes its own index there; afterwards cur[j] is the end of
//      run j. The slots of a run hold its queries in no particular order;
//   4. sum, in ascending query order. A run of at most kShort queries is
//      added by one lane: it picks the run's query indices in ascending
//      order from shared memory and gathers g and x1 for each, loads that
//      depend on no sum. Longer runs go on a list and the warps take them
//      one by one. A run's queries are distinct integers, so the warp sorts
//      them with a bitmap in its own shared memory (one pass over the run
//      for every 16384 queries of range, then a walk over the words) and
//      writes them in order to a global scratch row. Then it gathers g and
//      x1 of 64 queries at a time, the rows of the next two steps and the
//      indices of the third already in flight, stages the four products in
//      shared memory and adds them in order, a lane a component. The
//      all-to-one index costs n dependent additions, not n memory latencies,
//      and a long run costs O(its length) wherever its queries lie. kShort is
//      small because a lane's O(length^2) picking holds up its whole warp,
//      while a warp finishes a run of a few dozen in one step.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kShort = 8;    // longest run one lane sums alone
constexpr int kGroup = 64;   // rows a warp gathers and adds at a time
constexpr int kWarpBytes = 2048;             // a warp's own shared memory:
constexpr int kWindow = kWarpBytes * 8;      //   a bitmap over this many queries,
constexpr int kRows = kWarpBytes / 16;       //   then this many staged rows
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may opt into on the H100 (227 KB)
constexpr int kMaxShared = 232448;
constexpr int kFixedShared = kWarps * kWarpBytes;
constexpr int kMaxDevices = 64;
constexpr int kStaticShared = 1024;  // room kept for the kernel's static shared memory
static_assert(kRows >= kGroup, "a warp's memory holds one group of rows");

__device__ __forceinline__ float4 add4(float4 a, float4 v) {
  return make_float4(__fadd_rn(a.x, v.x), __fadd_rn(a.y, v.y), __fadd_rn(a.z, v.z),
                     __fadd_rn(a.w, v.w));
}

// g and x1 of query q as loaded, (x, y, z, g); q < 0 loads nothing.
__device__ __forceinline__ float4 load_row(const float* __restrict__ xb,
                                           const float* __restrict__ gb, int q) {
  if (q < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(__ldg(xb + 3 * q), __ldg(xb + 3 * q + 1), __ldg(xb + 3 * q + 2),
                     __ldg(gb + q));
}

// The four products (g x, g y, g z, g), each rounded once.
__device__ __forceinline__ float4 products(float4 r) {
  return make_float4(__fmul_rn(r.w, r.x), __fmul_rn(r.w, r.y), __fmul_rn(r.w, r.z), r.w);
}

// The index of query i less t_lo, or -1 where it is no query or points at no
// target in [t_lo, t_lo + m).
__device__ __forceinline__ int index_of(const int* __restrict__ ib, int i, int n, int t_lo,
                                        int m) {
  const int j = i < n ? __ldg(ib + i) - t_lo : -1;
  return j < m ? j : -1;
}

// The warp writes the queries ord[s, e) in ascending order to out[0, e - s):
// distinct integers, sorted through a bitmap over kWindow queries at a time.
__device__ __forceinline__ void sort_long_run(const int* ord, int* __restrict__ out,
                                              unsigned* bits, int n, int s, int e) {
  const int lane = threadIdx.x & 31;
  int first = n, last = -1;
#pragma unroll 4
  for (int k = s + lane; k < e; k += 32) {
    const int q = ord[k];
    first = min(first, q);
    last = max(last, q);
  }
  for (int d = 16; d > 0; d >>= 1) {
    first = min(first, __shfl_xor_sync(kFull, first, d));
    last = max(last, __shfl_xor_sync(kFull, last, d));
  }
  int done = 0;
  for (int wbase = first & ~31; wbase <= last; wbase += kWindow) {
    const int words = ((min(last, wbase + kWindow - 1) - wbase) >> 5) + 1;
    for (int t = lane; t < words; t += 32) bits[t] = 0u;
    __syncwarp();
#pragma unroll 4
    for (int kb = s; kb < e; kb += 32) {
      const int k = kb + lane;
      const int rel = k < e ? ord[k] - wbase : -1;
      const bool in = rel >= 0 && rel < kWindow;
      const int word = in ? rel >> 5 : -1;
      const unsigned bit = in ? 1u << (rel & 31) : 0u;
      if (__all_sync(kFull, word == __shfl_sync(kFull, word, 0))) {
        const unsigned all = __reduce_or_sync(kFull, bit);
        if (lane == 0 && word >= 0) bits[word] |= all;
      } else if (in) {
        atomicOr(bits + word, bit);
      }
      __syncwarp();
    }
    for (int tb = 0; tb < words; tb += 32) {
      const int t = tb + lane;
      unsigned w = t < words ? bits[t] : 0u;
      const int c = __popc(w);
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      int at = done + incl - c;
      while (w) {
        out[at++] = wbase + 32 * t + __ffs(w) - 1;
        w &= w - 1;
      }
      done += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
  }
}

// The warp adds the rows of queries ids[0, len), in that order: the rows of
// the next two groups and the indices of the third are in flight while a
// group is added.
__device__ __forceinline__ float4 sum_long_run(const float* __restrict__ xb,
                                               const float* __restrict__ gb, const int* ids,
                                               float4* wbuf, int len) {
  const int lane = threadIdx.x & 31;
  auto id_at = [&](int k) { return k < len ? ids[k] : -1; };
  float4 a0 = load_row(xb, gb, id_at(lane)), a1 = load_row(xb, gb, id_at(32 + lane));
  float4 b0 = load_row(xb, gb, id_at(kGroup + lane));
  float4 b1 = load_row(xb, gb, id_at(kGroup + 32 + lane));
  int q0 = id_at(2 * kGroup + lane), q1 = id_at(2 * kGroup + 32 + lane);
  // lane c & 3 adds component c of every row: one 4-byte read and one
  // addition a row and lane, the four chains side by side
  const float* mine = reinterpret_cast<const float*>(wbuf) + (lane & 3);
  float sum = 0.f;
  for (int base = 0; base < len; base += kGroup) {
    __syncwarp();
    wbuf[lane] = products(a0);
    wbuf[32 + lane] = products(a1);
    __syncwarp();
    a0 = b0;
    a1 = b1;
    b0 = load_row(xb, gb, q0);
    b1 = load_row(xb, gb, q1);
    q0 = id_at(base + 3 * kGroup + lane);
    q1 = id_at(base + 3 * kGroup + 32 + lane);
    if (len - base >= kGroup) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) sum = __fadd_rn(sum, mine[4 * k]);
    } else {
      for (int k = 0; k < len - base; ++k) sum = __fadd_rn(sum, mine[4 * k]);
    }
  }
  __syncwarp();
  return make_float4(__shfl_sync(kFull, sum, 0), __shfl_sync(kFull, sum, 1),
                     __shfl_sync(kFull, sum, 2), __shfl_sync(kFull, sum, 3));
}

// Ints of scratch a block indexes: [n sorted queries of its long runs]
// [n / kShort + 1 long targets][m_part counters][n slots], the last two used
// only where they do not fit in shared memory.
__host__ __device__ inline size_t list_length(int n) { return static_cast<size_t>(n) / kShort + 1; }
__host__ __device__ inline size_t block_scratch(int n, int m_part) {
  return 2 * static_cast<size_t>(n) + m_part + list_length(n);
}

// stride: ints between the scratch of one block and the next, at least
// block_scratch(n, m_part).
__global__ void __launch_bounds__(kThreads)
nn_grad_kernel(const float* __restrict__ x1, const float* __restrict__ g,
               const int* __restrict__ idx, int n, int m_all, int m_part, int fits,
               int* __restrict__ scratch, long long stride, float* __restrict__ sp, float* __restrict__ sw) {
  extern __shared__ float4 smem[];
  __shared__ int warp_total[kWarps];
  __shared__ int n_long, next_long;
  const int b = blockIdx.x;
  const int t_lo = blockIdx.y * m_part;
  const int m = min(m_part, m_all - t_lo);  // targets [t_lo, t_lo + m) are this block's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  char* mine_bytes = reinterpret_cast<char*>(smem) + warp * kWarpBytes;
  const size_t n_list = list_length(n);
  int* sorted = scratch + (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * stride;
  int* long_list = sorted + n;
  int* cur = fits ? reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + kFixedShared)
                  : long_list + n_list;
  int* ord = cur + m;
  const int* ib = idx + static_cast<size_t>(b) * n;
  const float* xb = x1 + static_cast<size_t>(b) * n * 3;
  const float* gb = g + static_cast<size_t>(b) * n;

  // 1. count
  if (tid == 0) n_long = next_long = 0;
  for (int j = tid; j < m; j += kThreads) cur[j] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kThreads) {
    const int j = index_of(ib, base + tid, n, t_lo, m);
    if (__all_sync(kFull, j == __shfl_sync(kFull, j, 0))) {
      if (lane == 0 && j >= 0) atomicAdd(cur + j, 32);
    } else if (j >= 0) {
      atomicAdd(cur + j, 1);
    }
  }
  __syncthreads();

  // 2. exclusive scan of cur: a warp owns a contiguous piece of the targets
  const int piece = ((m + kWarps - 1) / kWarps + 31) & ~31;
  const int lo = min(m, warp * piece), hi = min(m, lo + piece);
  int mine = 0;
  for (int j = lo + lane; j < hi; j += 32) mine += cur[j];
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_xor_sync(kFull, mine, d);
  if (lane == 0) warp_total[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_total[lane];
    int s = t;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += v;
    }
    warp_total[lane] = s - t;
  }
  __syncthreads();
  int carry = warp_total[warp];
  for (int jb = lo; jb < hi; jb += 32) {
    const int j = jb + lane;
    const int c = j < hi ? cur[j] : 0;
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (j < hi) cur[j] = carry + incl - c;
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();

  // 3. place
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const int j = index_of(ib, i, n, t_lo, m);
    if (__all_sync(kFull, j == __shfl_sync(kFull, j, 0))) {
      int slot = 0;
      if (lane == 0 && j >= 0) slot = atomicAdd(cur + j, 32);
      slot = __shfl_sync(kFull, slot, 0);
      if (j >= 0) ord[slot + lane] = i;
    } else if (j >= 0) {
      ord[atomicAdd(cur + j, 1)] = i;
    }
  }
  __syncthreads();

  // 4. sum every run in ascending query order (cur[j] is now the end of run
  // j): short runs here, a lane each; long runs listed
  for (int j = tid; j < m; j += kThreads) {
    const int s = j ? cur[j - 1] : 0, e = cur[j];
    const int len = e - s;
    if (len > kShort) {
      long_list[atomicAdd(&n_long, 1)] = j;
      continue;
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int prev = -1;
    for (int step = 0; step < len; ++step) {
      int q = n;
      for (int k = s; k < e; ++k) {
        const int v = ord[k];
        if (v > prev && v < q) q = v;
      }
      acc = add4(acc, products(load_row(xb, gb, q)));
      prev = q;
    }
    const size_t t = static_cast<size_t>(b) * m_all + t_lo + j;
    sp[3 * t] = acc.x;
    sp[3 * t + 1] = acc.y;
    sp[3 * t + 2] = acc.z;
    sw[t] = acc.w;
  }
  __syncthreads();
  // the long runs, a warp each, taken from the list as the warps come free
  for (;;) {
    int at = 0;
    if (lane == 0) at = atomicAdd(&next_long, 1);
    at = __shfl_sync(kFull, at, 0);
    if (at >= n_long) break;
    const int j = long_list[at];
    const int s = j ? cur[j - 1] : 0, e = cur[j];
    sort_long_run(ord, sorted + s, reinterpret_cast<unsigned*>(mine_bytes), n, s, e);
    __syncwarp();
    const float4 acc = sum_long_run(xb, gb, sorted + s, reinterpret_cast<float4*>(mine_bytes),
                                    e - s);
    if (lane == 0) {
      const size_t t = static_cast<size_t>(b) * m_all + t_lo + j;
      sp[3 * t] = acc.x;
      sp[3 * t + 1] = acc.y;
      sp[3 * t + 2] = acc.z;
      sw[t] = acc.w;
    }
  }
}

}  // namespace

// parts: blocks a cloud, each with ceil(m / parts) of its targets. scratch:
// (b, parts, stride) ints; a stride below block_scratch(n, ceil(m / parts)) is
// refused, so a wrapper that sizes the scratch wrongly fails loudly.
extern "C" int rfnet_nn_grad(const void* x1, const void* g, const void* idx, int b, int n, int m,
                             int parts, void* scratch, long long stride, void* sp, void* sw,
                             void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || parts <= 0 || parts > m) return cudaErrorInvalidValue;
  const int m_part = (m + parts - 1) / parts;
  if (stride < static_cast<long long>(block_scratch(n, m_part))) return cudaErrorInvalidValue;
  const long long need = kFixedShared + 4LL * (static_cast<long long>(m_part) + n);
  const bool fits = need + kStaticShared <= kMaxShared;
  const int shared = fits ? static_cast<int>(need) : kFixedShared;
  // opt in to the shared memory once a device, not once a call
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] < shared) {
    const int most = kMaxShared - kStaticShared;
    err = cudaFuncSetAttribute(nn_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    allowed[dev] = most;
  }
  const dim3 grid(b, (m + m_part - 1) / m_part);
  nn_grad_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(g), static_cast<const int*>(idx),
      n, m, m_part, fits ? 1 : 0, static_cast<int*>(scratch), stride, static_cast<float*>(sp),
      static_cast<float*>(sw));
  return cudaGetLastError();
}

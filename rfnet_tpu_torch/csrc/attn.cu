// K11: SnowflakeNet's k-NN vector attention after the k-NN, in one kernel
// (ops/vector_attention.py). It replaces no TPU kernel: SnowflakeNet is new in
// the port, and the published code runs this block as some fifteen eager
// passes over (b, n, 16, c) pair tensors.
//
// Contract. For every point i of a cloud and its K = 16 neighbours j = idx[i]
// (K10's output), with the position MLP's and the attention MLP's BatchNorm
// folded into their first layers:
//     pe_ij  = W2p relu(W1p (p_i - p_j) + b1p) + b2p               (3 -> 64 -> 64)
//     x_ij   = (q_i - k_j) + pe_ij
//     l_ij   = W2a relu(W1a x_ij + b1a) + b2a                      (64 -> 256 -> 64)
//     out_i  = sum_j softmax_j(l_ij) * (v_i + pe_ij)               (per channel)
// in float32, every product an fp32 FFMA: no TF32, no lower precision, and
// expf and IEEE division in the softmax (it subtracts the maximum, as
// torch.softmax does). Sums are taken in another order than the plain
// version's, so the two agree to float32 rounding, not bit for bit.
//
// Bound on the H100: operations. It is a product kernel with epilogues: a pair
// costs 2 (3*64 + 64*64) FLOPs in the position MLP and 2 (64*256 + 256*64) in
// the attention MLP, 74 112 in all, against 768 bytes of a neighbour's key
// and position read, so the products at 67 TFLOP/s bound it (1 900 544 pairs a
// SnowflakeNet forward at batch 32: 140.9 GFLOP, 2.10 ms). Its name says
// "gemm" so that the benchmark counts its time with the other products'.
//
// Design. The pair tensors never reach device memory:
// - One CTA of 256 threads is resident on each SM (217 088 bytes of shared
//   memory) and walks tiles of 8 query points x 16 neighbours = 128 pair rows.
//   The weights (150 016 bytes, laid out by the wrapper) are copied into its
//   shared memory once, so every tile reads them from there.
// - A tile gathers q_i - k_j for its rows into x^T (64 x 128) and p_i - p_j
//   into shared memory, runs the position MLP (hidden layer through shared
//   memory), keeps pe in registers and adds it into x^T. The attention MLP
//   runs in 4 chunks of 64 hidden channels: h = relu(x W1a[:, c] + b1a[c])
//   goes to shared memory, then the logits accumulate h W2a[c, :] in
//   registers. The softmax and the weighted sum over the 16 neighbours are
//   taken in registers, and only the (b, n, 64) output is written.
// - Every product is a 128 x 64 x 64 tile product from shared memory: each
//   thread owns 8 pair rows x 4 channels (32 FFMA accumulators) and reads,
//   for each of the 64 steps, 8 rows of A (two float4s of the transposed
//   operand) and 4 columns of B (one float4). A warp covers 4 row groups x 8
//   column groups, so its B read is one 128-byte line and its A reads are
//   broadcasts. A thread's 8 rows are half of one point's neighbours; the
//   other half sits 8 lanes away, so the softmax's max and sums are one
//   shuffle each.
// - The transposed operands swizzle each row's float4s by (k / 4) mod 8
//   (attn_at): the epilogues' transposed stores then spread each warp's 32
//   float4s evenly over the banks, and the reads stay conflict-free. Four
//   steps share a swizzle, so the product loop steps in fours from one base
//   address, unrolled to 32 steps: 32 FFMAs to 3 loads and about one integer
//   instruction a step.
// Measured on the H100 (PERF.md): 3.61 ms for the five blocks of a forward at
// batch 32, 58 % of the bound. Computing each step's swizzled address took
// a fifth of the issue slots (4.33 ms); a gather through cp.async under the
// last product, a register prefetch of the next step, 512 threads of 4 x 4
// and other unrollings measured slower or no faster.

#include <cuda_runtime.h>

namespace rfnet {

constexpr int kAttnThreads = 256;
constexpr int kAttnK = 16;                // neighbours a point
constexpr int kAttnQ = 8;                 // points a tile
constexpr int kAttnM = kAttnQ * kAttnK;   // pair rows a tile
constexpr int kAttnD = 64;                // channels of q, k, v, pe and the output
constexpr int kAttnP = 64;                // the position MLP's hidden channels
constexpr int kAttnH = 256;               // the attention MLP's hidden channels
constexpr int kAttnC = 64;                // hidden channels a chunk
constexpr int kAttnMaxDevices = 64;

// The packed weights (ops/vector_attention.py:pack), offsets in floats. The
// second layers and the attention MLP's first are stored input-major.
constexpr int kW1p = 0;                          // (P, 3)
constexpr int kB1p = kW1p + kAttnP * 3;          // (P)
constexpr int kW2p = kB1p + kAttnP;              // (P, D)
constexpr int kB2p = kW2p + kAttnP * kAttnD;     // (D)
constexpr int kW1a = kB2p + kAttnD;              // (D, H)
constexpr int kB1a = kW1a + kAttnD * kAttnH;     // (H)
constexpr int kW2a = kB1a + kAttnH;              // (H, D)
constexpr int kB2a = kW2a + kAttnH * kAttnD;     // (D)
constexpr int kAttnWeights = kB2a + kAttnD;      // 37 504
// shared memory beyond the weights: x^T (D, M), h^T (C, M) (also the position
// MLP's hidden layer (P, M)), p_i - p_j (3, M)
constexpr int kXt = kAttnWeights;
constexpr int kHt = kXt + kAttnD * kAttnM;
constexpr int kPr = kHt + kAttnC * kAttnM;
constexpr int kAttnShared = (kPr + 3 * kAttnM) * static_cast<int>(sizeof(float));

static_assert(kAttnP == kAttnC && kAttnD == 64, "every product is 128 x 64 x 64");
static_assert(kAttnWeights % 4 == 0 && kB1a % 4 == 0 && kW2a % 4 == 0, "float4 alignment");
static_assert(kAttnShared <= 232448, "more shared memory than a block may have");

// Index of element (k, m) of a transposed (64, 128) operand: row k, its
// float4s permuted within each run of 8 by (k / 4) mod 8.
__device__ __forceinline__ int attn_at(int k, int m) {
  return k * kAttnM + (m ^ (((k >> 2) & 7) << 2));
}

// acc[i][j] += sum over k < 64 of A(k, r0 + i) * B[k * LDB + c0 + j]: A
// transposed and swizzled, B row-major, both in shared memory.
template <int LDB>
__device__ __forceinline__ void attn_mma(const float* at, const float* bm, int r0, int c0,
                                         float (&acc)[8][4]) {
#pragma unroll 8
  for (int k4 = 0; k4 < 64; k4 += 4) {  // 4 steps share one swizzle: fixed offsets
    const float* lo = at + attn_at(k4, r0);
    const float* hi = at + attn_at(k4, r0 + 4);
    const float* bk = bm + k4 * LDB + c0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 a0 = *reinterpret_cast<const float4*>(lo + u * kAttnM);
      const float4 a1 = *reinterpret_cast<const float4*>(hi + u * kAttnM);
      const float4 w = *reinterpret_cast<const float4*>(bk + u * LDB);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

// Writes a thread's 8 rows x 4 columns into a transposed operand.
__device__ __forceinline__ void attn_store_t(float* at, int r0, int c0, const float (&v)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(at + attn_at(c0 + j, r0)) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    *reinterpret_cast<float4*>(at + attn_at(c0 + j, r0 + 4)) =
        make_float4(v[4][j], v[5][j], v[6][j], v[7][j]);
  }
}

// Grid: at most one CTA an SM, each walking tiles blockIdx.x, + gridDim.x, ...
// of the b * n points; blockDim kAttnThreads; kAttnShared bytes of dynamic
// shared memory.
__global__ void __launch_bounds__(kAttnThreads, 1)
attn_gemm_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
                 const float* __restrict__ query, const float* __restrict__ key,
                 const float* __restrict__ value, const float* __restrict__ weights, int b,
                 int n, float* __restrict__ out) {
  extern __shared__ float4 attn_smem[];
  float* sm = reinterpret_cast<float*>(attn_smem);
  float* xt = sm + kXt;
  float* ht = sm + kHt;
  float* pr = sm + kPr;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rg = (warp & 3) * 4 + (lane >> 3);  // row group: rows r0 .. r0 + 7
  const int cg = (warp >> 2) * 8 + (lane & 7);  // column group: columns c0 .. c0 + 3
  const int r0 = rg * 8, c0 = cg * 4;
  const int points = b * n;
  const int tiles = (points + kAttnQ - 1) / kAttnQ;

  for (int f = t; f < kAttnWeights / 4; f += kAttnThreads) {
    attn_smem[f] = __ldg(reinterpret_cast<const float4*>(weights) + f);
  }  // read only after the first tile's gather, behind its barrier
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    {  // gather: row m's q_i - k_j into x^T (a thread does half its channels)
      // and p_i - p_j; a point past the last is the last again, not written
      const int m = t & (kAttnM - 1), half = t >> 7;
      const int i = min(tile * kAttnQ + m / kAttnK, points - 1);
      const int j = min(max(__ldg(idx + static_cast<size_t>(i) * kAttnK + m % kAttnK), 0), n - 1);
      const size_t row = static_cast<size_t>(i / n) * n + j;
      const float4* kr = reinterpret_cast<const float4*>(key + row * kAttnD) + half * 8;
      const float4* qr =
          reinterpret_cast<const float4*>(query + static_cast<size_t>(i) * kAttnD) + half * 8;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const float4 kv = __ldg(kr + f), qv = __ldg(qr + f);
        const int c = half * 32 + f * 4;
        xt[attn_at(c, m)] = __fsub_rn(qv.x, kv.x);
        xt[attn_at(c + 1, m)] = __fsub_rn(qv.y, kv.y);
        xt[attn_at(c + 2, m)] = __fsub_rn(qv.z, kv.z);
        xt[attn_at(c + 3, m)] = __fsub_rn(qv.w, kv.w);
      }
      if (half == 0) {
        const float* pi = pos + static_cast<size_t>(i) * 3;
        const float* pj = pos + row * 3;
#pragma unroll
        for (int e = 0; e < 3; ++e) pr[e * kAttnM + m] = __fsub_rn(__ldg(pi + e), __ldg(pj + e));
      }
    }
    __syncthreads();

    // this thread's point i (its rows are 8 of i's neighbours)
    const int i = min(tile * kAttnQ + rg / 2, points - 1);
    {  // the position MLP's hidden layer, relu(W1p (p_i - p_j) + b1p), into h^T
      float d[3][8], hp[8][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float4 lo = *reinterpret_cast<const float4*>(pr + e * kAttnM + r0);
        const float4 hi = *reinterpret_cast<const float4*>(pr + e * kAttnM + r0 + 4);
        d[e][0] = lo.x, d[e][1] = lo.y, d[e][2] = lo.z, d[e][3] = lo.w;
        d[e][4] = hi.x, d[e][5] = hi.y, d[e][6] = hi.z, d[e][7] = hi.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* w = sm + kW1p + (c0 + jj) * 3;
        const float w0 = w[0], w1 = w[1], w2 = w[2], bias = sm[kB1p + c0 + jj];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const float s = fmaf(d[2][ii], w2, fmaf(d[1][ii], w1, d[0][ii] * w0));
          hp[ii][jj] = fmaxf(s + bias, 0.f);
        }
      }
      attn_store_t(ht, r0, c0, hp);
    }
    __syncthreads();

    // pe = W2p hp + b2p, kept in registers; x^T += pe
    float pe[8][4] = {};
    attn_mma<kAttnD>(ht, sm + kW2p, r0, c0, pe);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float bias = sm[kB2p + c0 + jj];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) pe[ii][jj] += bias;
      float4* lo = reinterpret_cast<float4*>(xt + attn_at(c0 + jj, r0));
      float4* hi = reinterpret_cast<float4*>(xt + attn_at(c0 + jj, r0 + 4));
      float4 a = *lo, c = *hi;
      a.x += pe[0][jj], a.y += pe[1][jj], a.z += pe[2][jj], a.w += pe[3][jj];
      c.x += pe[4][jj], c.y += pe[5][jj], c.z += pe[6][jj], c.w += pe[7][jj];
      *lo = a;
      *hi = c;
    }
    __syncthreads();

    // the attention MLP, a chunk of hidden channels at a time
    float logit[8][4] = {};
#pragma unroll 1
    for (int ch = 0; ch < kAttnH / kAttnC; ++ch) {
      float h[8][4] = {};
      attn_mma<kAttnH>(xt, sm + kW1a + ch * kAttnC, r0, c0, h);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float bias = sm[kB1a + ch * kAttnC + c0 + jj];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) h[ii][jj] = fmaxf(h[ii][jj] + bias, 0.f);
      }
      attn_store_t(ht, r0, c0, h);
      __syncthreads();
      attn_mma<kAttnD>(ht, sm + kW2a + ch * kAttnC * kAttnD, r0, c0, logit);
      if (ch + 1 < kAttnH / kAttnC) __syncthreads();  // h^T is rewritten next
    }

    // softmax over the 16 neighbours (8 here, 8 in lane ^ 8) and the weighted
    // sum of v_i + pe_ij
    const float4 v4 =
        __ldg(reinterpret_cast<const float4*>(value + static_cast<size_t>(i) * kAttnD + c0));
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    float o[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float bias = sm[kB2a + c0 + jj];
      float l[8], mx = -__int_as_float(0x7f800000);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        l[ii] = logit[ii][jj] + bias;
        mx = fmaxf(mx, l[ii]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      float s = 0.f;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        l[ii] = expf(l[ii] - mx);
        s += l[ii];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) acc = fmaf(l[ii] / s, pe[ii][jj] + v[jj], acc);
      o[jj] = acc + __shfl_xor_sync(0xffffffffu, acc, 8);
    }
    if ((lane & 8) == 0 && tile * kAttnQ + rg / 2 < points) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(i) * kAttnD + c0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

}  // namespace rfnet

// pos (b, n, 3), idx (b, n, 16) int32 in [0, n) (an index outside is clamped
// into it), query, key, value (b, n, 64) float32, weights the packed
// kAttnWeights floats, all contiguous, 16-byte aligned but pos; at most
// `ctas` CTAs (one an SM is resident); out (b, n, 64) float32.
extern "C" int rfnet_attn(const void* pos, const void* idx, const void* query, const void* key,
                          const void* value, const void* weights, int b, int n, int ctas,
                          void* out, void* stream) {
  if (b <= 0 || n <= 0 || ctas <= 0 || static_cast<long long>(b) * n > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  // opt in to the shared memory once a device, not once a call
  static bool allowed[rfnet::kAttnMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= rfnet::kAttnMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(rfnet::attn_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, rfnet::kAttnShared);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int tiles = (b * n + rfnet::kAttnQ - 1) / rfnet::kAttnQ;
  rfnet::attn_gemm_kernel<<<tiles < ctas ? tiles : ctas, rfnet::kAttnThreads, rfnet::kAttnShared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int*>(idx),
      static_cast<const float*>(query), static_cast<const float*>(key),
      static_cast<const float*>(value), static_cast<const float*>(weights), b, n,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// K1: farthest point sampling, the whole selection loop in one kernel.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/fps.py:fps_pallas (body
// _make_kernel). Semantics of rfnet_tpu/ops/fps.py:_fps_single: the first
// pick is index 0; every later pick is the argmax of the running minimum
// squared distance to the picked set (initialised to 1e38), the lowest index
// winning ties. The distance is (x-lx)^2 + (y-ly)^2 + (z-lz)^2 in that order
// without fused multiply-adds, so the picks equal the plain version's
// (ops/fps.py:_fps_plain) exactly, for any number of points.
//
// Design: a thread block cluster of C CTAs of 256 threads per cloud (C = 1,
// 2, 4 or 8, chosen by the wrapper from the batch and the cloud). CTA r of
// a cluster holds the r-th contiguous 1/C of the cloud. In the register form each
// thread keeps P points, coordinates and running minimum, in registers:
// point k of thread t is the CTA's point 256*k + t, so k ascends with the
// index and a strict > keeps a thread's lowest index. One pick: update the
// minima and take the thread's argmax in registers; the warp's argmax with
// __reduce_max_sync on the minimum's bits (it is >= 0, so its bits order as
// its value) and __reduce_min_sync on the indices that hold it, its
// coordinates from a copy of the CTA's points in shared memory (cheaper
// than carrying them through the argmax); then lane r of every warp stores
// the warp's winner (coordinates, minimum, index) into the warp's slot in
// CTA r with st.async, which counts the bytes on that CTA's mbarrier, and
// every thread waits until all C*8 slots of its own CTA have landed and
// merges them. The next pick's coordinates arrive with the winner, so the
// pick loop touches no global memory, and it has no cluster barrier: each
// CTA waits only for the data it reads. The slots and the mbarriers
// alternate with the pick's parity. Where the cloud is larger than
// C*256*P_max points the streaming form keeps the running minima in a
// global scratch array and reads the coordinates each pick (from L2 at the
// sizes it takes), carrying the winner's through its argmax, with the same
// exchange.
//
// Bound on the H100: 8 flops a point a pick and 12 bytes a point read once.
// The kernel is bound by the chain of npoint-1 dependent exchanges across
// the cluster plus each pick's pass over a CTA's points (about 12
// instructions a point).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kSlotBytes = 20;  // a warp's winner: x, y, z, minimum bits, index
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0x7fffffffu;  // index of a slot that holds no point

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Stores into a peer's shared memory that count their bytes on its mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

// One arrival that also expects `bytes` more to land in the current phase.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// P > 0: each thread holds P points in registers; P == 0: streaming form.
template <int P>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint, float* __restrict__ scratch,
           int* __restrict__ idx) {
  constexpr int R = P > 0 ? P : 1;
  // per pick parity and slot (rank * kWarps + warp): coordinates and the
  // bits of the minimum; the index apart; one mbarrier a parity counts the
  // bytes of the cluster's C * kWarps slots as they land
  __shared__ float4 slot_p[2][kMaxCluster * kWarps];
  __shared__ unsigned slot_i[2][kMaxCluster * kWarps];
  __shared__ __align__(8) unsigned long long landed[2];
  extern __shared__ float4 own[];  // register form: the CTA's points, (x, y, z, 0)

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = C * kWarps;
  const unsigned phase_bytes = static_cast<unsigned>(E * kSlotBytes);
  const float* pts = xyz + static_cast<size_t>(blockIdx.y) * n * 3;
  int* out = idx + static_cast<size_t>(blockIdx.y) * npoint;
  const int chunk = (n + C - 1) / C;
  const int base = min(n, rank * chunk);
  const int cnt = min(n, base + chunk) - base;
  float* mind = P > 0 ? nullptr : scratch + static_cast<size_t>(blockIdx.y) * n + base;

  // a missing point has minimum -1: fminf keeps it there and it never wins
  float px[R], py[R], pz[R], pm[R];
  if constexpr (P > 0) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = k * kThreads + tid;
      const bool live = i < cnt;
      const float* p = pts + 3 * static_cast<size_t>(base + (live ? i : 0));
      px[k] = live ? __ldg(p) : 0.f;
      py[k] = live ? __ldg(p + 1) : 0.f;
      pz[k] = live ? __ldg(p + 2) : 0.f;
      pm[k] = live ? 1e38f : -1.f;
      if (live) own[i] = make_float4(px[k], py[k], pz[k], 0.f);
    }
  } else {
    for (int i = tid; i < cnt; i += kThreads) mind[i] = 1e38f;
  }
  float lx = __ldg(pts), ly = __ldg(pts + 1), lz = __ldg(pts + 2);
  if (rank == 0 && tid == 0) out[0] = 0;
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&landed[k])),
                   "r"(1u) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // picks 1 and 2 (parities 1 and 0)
    for (int j = 1; j < min(npoint, 3); ++j) expect_bytes(smem_addr(&landed[j & 1]), phase_bytes);
  }
  cluster.sync();  // every CTA has started and armed its mbarriers before any slot is written

  unsigned phases = 0;  // bit p: the parity of the phase mbarrier p is in
  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    float bv = -1.f, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = static_cast<int>(kNone);
    if constexpr (P > 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float d = rfnet::sq3(__fsub_rn(px[k], lx), __fsub_rn(py[k], ly),
                                   __fsub_rn(pz[k], lz));
        const float m = fminf(pm[k], d);
        pm[k] = m;
        if (m > bv) {  // k ascends: strict > keeps the thread's lowest index
          bv = m;
          bi = base + k * kThreads + tid;
        }
      }
    } else {
      for (int i = tid; i < cnt; i += kThreads) {
        const float* p = pts + 3 * static_cast<size_t>(base + i);
        const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
        const float m = fminf(mind[i], rfnet::sq3(__fsub_rn(x, lx), __fsub_rn(y, ly),
                                                  __fsub_rn(z, lz)));
        mind[i] = m;
        if (m > bv) {
          bv = m;
          bi = base + i;
          bx = x;
          by = y;
          bz = z;
        }
      }
    }
    // the warp's winner: largest minimum, then lowest index
    const unsigned vb = bv < 0.f ? 0u : __float_as_uint(bv);
    const unsigned wv = __reduce_max_sync(kFull, vb);
    const unsigned wi = __reduce_min_sync(kFull, vb == wv ? static_cast<unsigned>(bi) : kFull);
    float wx, wy, wz;
    if constexpr (P > 0) {  // the winner's coordinates from the CTA's copy
      const float4 c = wi == kNone ? make_float4(0.f, 0.f, 0.f, 0.f) : own[wi - base];
      wx = c.x;
      wy = c.y;
      wz = c.z;
    } else {  // from the lane that holds it
      const int src = __ffs(__ballot_sync(kFull, vb == wv && static_cast<unsigned>(bi) == wi)) - 1;
      wx = __shfl_sync(kFull, bx, src);
      wy = __shfl_sync(kFull, by, src);
      wz = __shfl_sync(kFull, bz, src);
    }
    if (lane < C) {  // lane r sends the winner to CTA r's slot
      const int s = rank * kWarps + warp;
      const unsigned bar = peer_addr(smem_addr(&landed[par]), lane);
      st_async(peer_addr(smem_addr(&slot_p[par][s]), lane),
               make_float4(wx, wy, wz, __uint_as_float(wv)), bar);
      st_async(peer_addr(smem_addr(&slot_i[par][s]), lane), wi, bar);
    }
    // The slots of this parity are written again only at pick j + 2, and a
    // peer sends that only after it has every slot of pick j + 1, which each
    // warp here sends only after its reads below.
    wait_phase(smem_addr(&landed[par]), (phases >> par) & 1u);
    phases ^= 1u << par;
    if (tid == 0 && j + 2 < npoint) expect_bytes(smem_addr(&landed[par]), phase_bytes);
    // every warp merges the cluster's C * kWarps slots
    unsigned v = 0, i = kFull;
    int e = 0;
    for (int s = lane; s < E; s += 32) {
      const unsigned sv = __float_as_uint(slot_p[par][s].w), si = slot_i[par][s];
      if (sv > v || (sv == v && si < i)) {
        v = sv;
        i = si;
        e = s;
      }
    }
    const unsigned gv = __reduce_max_sync(kFull, v);
    const unsigned gi = __reduce_min_sync(kFull, v == gv ? i : kFull);
    e = __shfl_sync(kFull, e, __ffs(__ballot_sync(kFull, v == gv && i == gi)) - 1);
    const float4 w = slot_p[par][e];
    lx = w.x;
    ly = w.y;
    lz = w.z;
    if (rank == 0 && tid == 0) out[j] = static_cast<int>(gi);
  }
  cluster.sync();  // no CTA leaves while a peer's stores to it may be in flight
}

// The chain of the pick loop alone, `iters` rounds in clusters of C CTAs of
// kThreads threads: with `exchange` each round is the pick loop's exchange
// (lanes below C of every warp store one slot into every CTA with st.async,
// then every thread waits on its mbarrier); without, one cluster barrier.
__global__ void __launch_bounds__(kThreads) cluster_chain_kernel(int iters, int exchange) {
  __shared__ float4 slot[2][kMaxCluster * kWarps];
  __shared__ __align__(8) unsigned long long landed[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned phase_bytes = static_cast<unsigned>(C * kWarps * 16);
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&landed[k])),
                   "r"(1u) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 1; j < min(iters + 1, 3); ++j) {
      expect_bytes(smem_addr(&landed[j & 1]), phase_bytes);
    }
  }
  cluster.sync();
  unsigned phases = 0;
  for (int j = 1; j <= iters; ++j) {
    if (!exchange) {
      cluster.sync();
      continue;
    }
    const int par = j & 1;
    if (lane < C) {
      st_async(peer_addr(smem_addr(&slot[par][rank * kWarps + warp]), lane),
               make_float4(0.f, 0.f, 0.f, 0.f), peer_addr(smem_addr(&landed[par]), lane));
    }
    wait_phase(smem_addr(&landed[par]), (phases >> par) & 1u);
    phases ^= 1u << par;
    if (tid == 0 && j + 2 <= iters) expect_bytes(smem_addr(&landed[par]), phase_bytes);
  }
  cluster.sync();
}

// Launches `kernel` on a grid (cluster, b) in clusters of `cluster` CTAs of
// kThreads threads with `smem` bytes of dynamic shared memory.
// resident[log2(cluster)] caches the check that such a cluster can be
// resident (0 unknown, 1 yes); with null it checks at every launch.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int cluster, int b, cudaStream_t stream,
                           int* resident, size_t smem, Args... args) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, b);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // a cluster that cannot be resident would never launch: refuse it
  int* known = resident == nullptr ? nullptr : resident + __builtin_ctz(cluster);
  if (known == nullptr || *known == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    int active = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &config);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    if (known != nullptr) *known = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_fps(int cluster, int b, cudaStream_t stream, const float* xyz, int n,
                       int npoint, float* scratch, int* idx) {
  static int resident[4] = {0, 0, 0, 0};
  const size_t smem = P > 0 ? sizeof(float4) * kThreads * P : 0;
  return launch_cluster(fps_kernel<P>, cluster, b, stream, resident, smem, xyz, n, npoint,
                        scratch, idx);
}

}  // namespace

// `cluster` CTAs a cloud (1, 2, 4 or 8), `per_thread` points a thread in
// registers (1, 2, 4, 8, 16 or 32), or 0 for the streaming form, which
// needs `scratch`, b*n floats.
extern "C" int rfnet_fps(const void* xyz, int b, int n, int npoint, int cluster, int per_thread,
                         void* scratch, void* idx, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return cudaErrorInvalidValue;
  if (per_thread > 0 && static_cast<long long>(cluster) * kThreads * per_thread < n) {
    return cudaErrorInvalidValue;
  }
  if (per_thread == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xyz);
  auto* sc = static_cast<float*>(scratch);
  auto* out = static_cast<int*>(idx);
  switch (per_thread) {
    case 0: return launch_fps<0>(cluster, b, s, x, n, npoint, sc, out);
    case 1: return launch_fps<1>(cluster, b, s, x, n, npoint, sc, out);
    case 2: return launch_fps<2>(cluster, b, s, x, n, npoint, sc, out);
    case 4: return launch_fps<4>(cluster, b, s, x, n, npoint, sc, out);
    case 8: return launch_fps<8>(cluster, b, s, x, n, npoint, sc, out);
    case 16: return launch_fps<16>(cluster, b, s, x, n, npoint, sc, out);
    case 32: return launch_fps<32>(cluster, b, s, x, n, npoint, sc, out);
    default: return cudaErrorInvalidValue;
  }
}

// Runs cluster_chain_kernel: `iters` rounds of the pick loop's exchange
// (`exchange` != 0) or of cluster barriers in `b` clusters of `cluster`
// CTAs, a probe of the chain's round trip timed by its caller. Not on any
// path of the package.
extern "C" int rfnet_cluster_chain_probe(int b, int cluster, int iters, int exchange,
                                         void* stream) {
  return launch_cluster(cluster_chain_kernel, cluster, b, static_cast<cudaStream_t>(stream),
                        nullptr, size_t{0}, iters, exchange);
}

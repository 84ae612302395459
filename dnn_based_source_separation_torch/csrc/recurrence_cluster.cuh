// Forward of the LSTM recurrences for few sequences at H > 128 (Hopper, sm_90a):
// one chain of one sequence spread over a thread-block cluster.
//
// Included by csrc/lstm_scan.cu after csrc/recurrence_tf32.cuh (whose cluster
// primitives it uses) and launched there as path 4, "cluster"
// (ops/lstm_scan.py:_plan picks it and the cluster size); the backward's cluster
// kernel (csrc/recurrence_cluster_bwd.cuh) shares its exchange and launch helpers
// (mbar_*, st_async_*, allow, cluster_config). ops/_build.py hashes
// this header into the key of every source. It replaces, for these calls, the
// TPU kernels of dnn_based_source_separation_tpu/ops/pallas_lstm.py:
//   lstm_scan        (:139, _lstm_kernel):  one chain;
//   lstm_scan_bidir  (:310, _bidir_kernel): two chains, the second over a
//                    sequence the caller has already reversed in time.
//
// It computes the FMA kernel's function (csrc/lstm_scan.cu): per step
//     gates = f32(xw[b, t, :]) + f32(h rounded to W's dtype) @ f32(W_hh)
// in gate order i, f, g, o; c and h carried in f32; hs (and cs, when the
// caller asks for it) rounded to the dtype on write. xw and W_hh are float32
// or bfloat16; a bf16 W_hh is widened to f32 once, exactly, so the products
// are exact and the sums f32 in both dtypes, in another order than the FMA
// kernel's. The sigmoid divides with __fdividef (2 ulp), as the tensor-core
// paths do.
//
// What bounds it. At musdb18 serving (UMX: B = 1, T = 431; H = 256 on two
// chains, H = 512 on one) a step is a (1 x H) @ (H x 4H) product that
// depends on the step before: 0.5 and 2 MFLOP a step, microseconds of one
// SM's FMA issue but nanoseconds of the card's. The FMA kernel gives the
// chain one block, which re-reads the part of W_hh (1 MiB at H = 256, 4 MiB
// at H = 512, f32) that its 227 KB cannot hold from L2 on every step: 18.6
// and 39 us a step on an H100. Here the chain's step is split over a cluster
// of C blocks (C = 8 or 16, one SM each), so W_hh stays on chip for the whole
// loop and each SM does 1/C of the product. What is left bounds a step: the
// W bytes each SM reads from its registers and shared memory, the h bytes
// each warp reads, the reduction of the partial sums, the cell update, and
// the exchange of h between the SMs. `kProduct = false` compiles the product
// out (the serial floor: the same loop with only the reduction, the cell and
// the exchange), to measure how much of a step is latency; on an H100 it is
// most of a step at H = 256 (PERF.md).
//
// Design:
//   * the cluster owns one sequence of one chain (blockIdx.x = C * b + rank,
//     blockIdx.y the chain). Rank r owns hidden units [r H/C, (r+1) H/C) and
//     all four gate columns of each, so the cell update needs no exchange;
//     its H/(2C) warps own two units each (kUnitsPerWarp);
//   * the K (row) dimension is split over the lanes: in row block jb (128
//     rows), lane l owns rows 128 jb + 4 l + e, e = 0..3, and reads its four
//     h values as one 16-byte load (a warp reads h[128 jb : 128 jb + 128]
//     contiguously). Each thread holds the W_hh values of its rows, units and
//     gates: the first kRegBlocks row blocks in registers (64 floats), the
//     rest (H = 384: one, H = 512: two) in shared memory, laid out so that a
//     warp's 16-byte (f32) or 8-byte (bf16) loads are contiguous. W is staged
//     once through a padded f32 scratch tile (coalesced reads of device
//     memory, conflict-free reads of the tile);
//   * a warp's eight partial sums (2 units x 4 gates) are reduced over the 32
//     lanes by a transposed butterfly: at xor 16, 8 and 4 each lane keeps
//     half of its values and adds its partner's other half (4 + 2 + 1
//     shuffles), then xor 2 and 1 sum the last one, so lane l ends with the
//     total of value l / 4 = (unit l / 16, gate (l / 4) % 4), adds its xw
//     value (loaded a step ahead) and gathers the unit's four gates from the
//     lanes of its half-warp. Every lane of the half-warp updates the unit's
//     cell (the same values, so c never leaves the registers);
//   * h is published through distributed shared memory: lane p < C of each
//     half-warp sends the unit's h, rounded to W's dtype, into rank p's
//     double-buffered h (mapa, st.async), so a rank's C remote stores leave
//     in parallel, and each store signals rank p's mbarrier of that buffer
//     with its 4 bytes (complete_tx). Thread 0 arms its mbarrier for the next
//     step's H x 4 bytes (arrive.expect_tx), and every thread waits on it
//     (try_wait.parity, acquire at cluster scope) before the next product:
//     a rank waits for the data it reads and for nothing else, where one
//     barrier.cluster a step (a variant scripts/probe_cluster_recurrence.py
//     times, 1.3-1.8x slower on an H100) also waits for every thread of every
//     rank. hs (and cs) are stored after the sends;
//   * every block takes an SM of its own (at least kOwnSm of shared memory),
//     since a step's latency bounds the kernel. C = 16 is a non-portable
//     cluster size: the kernel sets cudaFuncAttributeNonPortableClusterSizeAllowed,
//     and the caller sizes its grid from max_clusters (cudaOccupancyMaxActiveClusters),
//     never from a launch that failed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_tf32.cuh"

namespace cluster_scan {

constexpr int kRowBlock = 128;     // rows of W_hh a warp covers in one pass: 32 lanes x 4
constexpr int kRegBlocks = 2;      // row blocks each thread holds in registers
constexpr int kUnitsPerWarp = 2;
constexpr int kMaxThreads = 512;   // 128 registers a thread
constexpr int kMinHidden = 256;    // H a multiple of kRowBlock above 128
constexpr int kMaxHidden = 512;
constexpr size_t kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling
constexpr size_t kOwnSm = 120 * 1024;  // no two blocks on one SM

struct Chains {
  const void* xw[2];
  const void* whh[2];
  void* hs[2];
  void* cs[2];  // null: do not write the cell state
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float rounded(float x, const float*) { return x; }
__device__ __forceinline__ float rounded(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

// Four gate values of W_hh in shared memory: f32, or bf16 (exact in f32).
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
  __device__ __forceinline__ static type pack(const float (&g)[4]) {
    return make_float4(g[0], g[1], g[2], g[3]);
  }
  __device__ __forceinline__ static void unpack(type v, float (&g)[4]) {
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using type = uint2;  // the lower half-word holds the first value
  __device__ __forceinline__ static type pack(const float (&g)[4]) {
    return make_uint2((__float_as_uint(g[0]) >> 16) | (__float_as_uint(g[1]) & 0xffff0000u),
                      (__float_as_uint(g[2]) >> 16) | (__float_as_uint(g[3]) & 0xffff0000u));
  }
  __device__ __forceinline__ static void unpack(type v, float (&g)[4]) {
    g[0] = __uint_as_float(v.x << 16); g[1] = __uint_as_float(v.x & 0xffff0000u);
    g[2] = __uint_as_float(v.y << 16); g[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

// The exchange of h: each value goes to its rank by st.async, which signals that
// rank's mbarrier for the buffer with its 4 bytes (complete_tx); a rank waits on
// its own mbarrier for the H * 4 bytes of a step.
__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(mbar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void st_async_f32(unsigned addr, float v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(v), "r"(mbar)
               : "memory");
}
// Four values as one 16-byte store (the address 16-byte aligned), which completes
// 16 bytes on the mbarrier: the backward's exchange (csrc/recurrence_cluster_bwd.cuh).
__device__ __forceinline__ void st_async_v4(unsigned addr, float4 v, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}

// Shared memory of a block: the two mbarriers (16 bytes), h [2][H] f32, the W
// row blocks past kRegBlocks in T, and the staging tile [128][4 H/C + 1] f32;
// at least kOwnSm.
__host__ __device__ constexpr size_t smem_need(int H, int C, size_t elem) {
  const int KS = H / kRowBlock > kRegBlocks ? H / kRowBlock - kRegBlocks : 0;
  return 16 + 2 * (size_t)H * 4 + (size_t)KS * kRowBlock * 4 * (H / C) * elem +
         (size_t)kRowBlock * (4 * (H / C) + 1) * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int H, int C, size_t elem) {
  return smem_need(H, C, elem) > kOwnSm ? smem_need(H, C, elem) : kOwnSm;
}

// H a multiple of 128 in 256..512; C = 8 or 16 with H / C units a rank, two a
// warp, at most kMaxThreads threads a block; the shared memory fits.
inline bool shape_ok(int H, int C) {
  return H % kRowBlock == 0 && H >= kMinHidden && H <= kMaxHidden && (C == 8 || C == 16) &&
         H % (kUnitsPerWarp * C) == 0 && 32 * (H / C / kUnitsPerWarp) <= kMaxThreads &&
         smem_bytes(H, C, 4) <= kMaxShared;
}

template <typename T, int KJ, bool kProduct>
__global__ void __launch_bounds__(kMaxThreads, 1)
scan_cluster_kernel(Chains chains, int T_len, int H, int C) {
  constexpr int KR = KJ < kRegBlocks ? KJ : kRegBlocks;  // row blocks in registers
  using Q = Quad<T>;
  using QT = typename Q::type;

  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const T* __restrict__ xw = static_cast<const T*>(second ? chains.xw[1] : chains.xw[0]);
  const T* __restrict__ whh = static_cast<const T*>(second ? chains.whh[1] : chains.whh[0]);
  T* __restrict__ hs = static_cast<T*>(second ? chains.hs[1] : chains.hs[0]);
  T* __restrict__ cs = static_cast<T*>(second ? chains.cs[1] : chains.cs[0]);

  const int HU = H / C;                // units of this rank
  const int NW = HU / kUnitsPerWarp;   // warps of the block
  const unsigned rank = tf32_scan::cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ubase = (int)rank * HU;
  const long long b = blockIdx.x / C;  // the sequence
  const long long G4 = 4LL * H;

  extern __shared__ float4 smem_cluster[];
  uint64_t* mbars = reinterpret_cast<uint64_t*>(smem_cluster);  // [2]: h of the buffer arrived
  float* hbuf = reinterpret_cast<float*>(smem_cluster + 1);     // [2][H]
  QT* wsm = reinterpret_cast<QT*>(hbuf + 2 * H);         // [KJ-KR][NW][4 e][2 u][32 lanes]
  float* scratch = reinterpret_cast<float*>(wsm + (size_t)(KJ - KR) * NW * 4 * kUnitsPerWarp * 32);

  // W_hh rows of this thread, rows 128 jb + 4 lane + e, columns q H + unit.
  float w[KR][4][kUnitsPerWarp][4];
  if (kProduct) {
    const int cols = 4 * HU, pitch = cols + 1;
#pragma unroll
    for (int jb = 0; jb < KJ; ++jb) {
      // Row r of the block at scratch row (r % 4) * 32 + r / 4: lane l's rows
      // 4 l + e sit one pitch apart, so its reads below hit distinct banks.
      for (int i = tid; i < kRowBlock * cols; i += blockDim.x) {
        const int r = i / cols, col = i - r * cols, q = col / HU;
        scratch[((r & 3) * 32 + (r >> 2)) * pitch + col] = to_f32(
            whh[(long long)(kRowBlock * jb + r) * G4 + (long long)q * H + ubase + col - q * HU]);
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int u = 0; u < kUnitsPerWarp; ++u) {
          const float* s = scratch + (e * 32 + lane) * pitch + kUnitsPerWarp * warp + u;
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q] = s[q * HU];
          if (jb < KR) {
#pragma unroll
            for (int q = 0; q < 4; ++q) w[jb < KR ? jb : 0][e][u][q] = g[q];
          } else {
            wsm[((((jb - KR) * NW + warp) * 4 + e) * kUnitsPerWarp + u) * 32 + lane] = Q::pack(g);
          }
        }
      __syncthreads();
    }
  }
  for (int i = tid; i < H; i += blockDim.x) hbuf[i] = 0.f;  // h = 0 before step 0
  const unsigned mbar = tf32_scan::smem_addr(mbars);
  if (tid == 0) {
    mbar_init(mbar);
    mbar_init(mbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Lane l ends the reduction with gate q_l of unit u_l of its warp.
  const int u_l = lane >> 4, q_l = (lane >> 2) & 3;
  const int unit = ubase + kUnitsPerWarp * warp + u_l;
  const int p = lane & 15;  // the rank this lane publishes h to
  const unsigned peer = tf32_scan::map_to_rank(tf32_scan::smem_addr(hbuf), p < C ? p : 0);
  const unsigned peer_mbar = tf32_scan::map_to_rank(mbar, p < C ? p : 0);
  const T* xrow = xw + b * T_len * G4 + (long long)q_l * H + unit;
  float x_next = to_f32(xrow[0]);
  float c = 0.f;

  // W staged, h zeroed and the mbarriers set up in every block, and every
  // block running, before any write to another's shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();

  // Step t reads h_{t-1} from buffer t % 2 and sends h_t into buffer (t+1) % 2
  // of every rank. A rank sends h_t only after it has all of h_{t-1}, which
  // every rank sent after its reads of step t - 1: so a buffer is never
  // written while it is read, and an mbarrier's next phase never starts
  // before its last one completed.
#pragma unroll 1
  for (int t = 0; t < T_len; ++t) {
    const float* hcur = hbuf + (t & 1) * H;  // h of step t - 1
    const unsigned next = 4u * (unsigned)(((t + 1) & 1) * H + unit);
    const unsigned next_mbar = 8u * (unsigned)((t + 1) & 1);
    if (tid == 0 && t + 1 < T_len) mbar_expect(mbar + next_mbar, 4u * (unsigned)H);
    if (t > 0) mbar_wait(mbar + 8u * (unsigned)(t & 1), (unsigned)((t - 1) >> 1) & 1u);
    const float xv = x_next;
    if (t + 1 < T_len) x_next = to_f32(xrow[(long long)(t + 1) * G4]);

    float acc[kUnitsPerWarp][4];
#pragma unroll
    for (int u = 0; u < kUnitsPerWarp; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][q] = 0.f;
    if (kProduct) {
#pragma unroll
      for (int jb = 0; jb < KJ; ++jb) {
        const float4 hv = *reinterpret_cast<const float4*>(hcur + kRowBlock * jb + 4 * lane);
        const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < kUnitsPerWarp; ++u) {
            float g[4];
            if (jb < KR) {
#pragma unroll
              for (int q = 0; q < 4; ++q) g[q] = w[jb < KR ? jb : 0][e][u][q];
            } else {
              Q::unpack(wsm[((((jb - KR) * NW + warp) * 4 + e) * kUnitsPerWarp + u) * 32 + lane], g);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[u][q] = fmaf(hh[e], g[q], acc[u][q]);
          }
      }
    }

    // The transposed butterfly: value v = 4 u + q.
    float a[4], bsum[2];
    const bool x16 = lane & 16, x8 = lane & 8, x4 = lane & 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float keep = x16 ? acc[1][i] : acc[0][i];
      const float send = x16 ? acc[0][i] : acc[1][i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float keep = x8 ? a[2 + j] : a[j];
      const float send = x8 ? a[j] : a[2 + j];
      bsum[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    float s = (x4 ? bsum[1] : bsum[0]) + __shfl_xor_sync(0xffffffffu, x4 ? bsum[0] : bsum[1], 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += xv;

    const int half = lane & 16;
    const float gi = __shfl_sync(0xffffffffu, s, half);
    const float gf = __shfl_sync(0xffffffffu, s, half | 4);
    const float gg = __shfl_sync(0xffffffffu, s, half | 8);
    const float go = __shfl_sync(0xffffffffu, s, half | 12);
    c = sigmoid(gf) * c + sigmoid(gi) * tanhf(gg);
    const float h = sigmoid(go) * tanhf(c);

    // The next product reads h rounded to the weight dtype, as Pallas does.
    if (p < C && t + 1 < T_len) st_async_f32(peer + next, rounded(h, whh), peer_mbar + next_mbar);
    if (p == 0) {
      const long long o = (b * T_len + t) * H + unit;
      store(hs + o, h);
      if (cs != nullptr) store(cs + o, c);
    }
  }
  // No block leaves while another may still write to its shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();
}

// A cluster kernel of this header or of csrc/recurrence_cluster_bwd.cuh allowed
// kMaxShared of dynamic shared memory and non-portable (16-block) clusters, once:
// `done` is the caller's flag for that kernel.
template <typename Kernel>
inline cudaError_t allow(Kernel kernel, bool& done) {
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

// static: the flag is this library's, even beside another build of this header in
// the process (a template's local static is otherwise one object process-wide).
template <typename T, int KJ, bool kProduct>
static cudaError_t prepare() {
  static bool done = false;  // per instantiation
  return allow(scan_cluster_kernel<T, KJ, kProduct>, done);
}

// The launch of one sequence a cluster of C blocks: grid (C B, n_chains), `threads` a
// block, `smem` bytes of dynamic shared memory.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* cluster, int B, int n_chains,
                                         int C, unsigned threads, size_t smem,
                                         cudaStream_t stream) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = (unsigned)C;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(C * B), (unsigned)n_chains);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  return config;
}

inline cudaLaunchConfig_t config_of(cudaLaunchAttribute* cluster, int B, int n_chains, int H,
                                    int C, size_t elem, cudaStream_t stream) {
  return cluster_config(cluster, B, n_chains, C, (unsigned)(32 * (H / C / kUnitsPerWarp)),
                        smem_bytes(H, C, elem), stream);
}

template <typename T, int KJ, bool kProduct>
int launch_k(const Chains& chains, int n_chains, int B, int T_len, int H, int C,
             cudaStream_t stream) {
  cudaError_t err = prepare<T, KJ, kProduct>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config = config_of(&cluster, B, n_chains, H, C, sizeof(T), stream);
  err = cudaLaunchKernelEx(&config, scan_cluster_kernel<T, KJ, kProduct>, chains, T_len, H, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool kProduct>
int launch_t(const Chains& chains, int n_chains, int B, int T_len, int H, int C,
             cudaStream_t stream) {
  switch (H / kRowBlock) {
    case 2: return launch_k<T, 2, kProduct>(chains, n_chains, B, T_len, H, C, stream);
    case 3: return launch_k<T, 3, kProduct>(chains, n_chains, B, T_len, H, C, stream);
    case 4: return launch_k<T, 4, kProduct>(chains, n_chains, B, T_len, H, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The "cluster" path: one sequence a cluster of C blocks (dtype 0 float32,
// 1 bfloat16). `product` false launches the serial floor.
inline int launch(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int C,
                  bool product, cudaStream_t stream) {
  if (B < 1 || T_len < 1 || !shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return product ? launch_t<float, true>(chains, n_chains, B, T_len, H, C, stream)
                   : launch_t<float, false>(chains, n_chains, B, T_len, H, C, stream);
  if (dtype == 1)
    return product ? launch_t<__nv_bfloat16, true>(chains, n_chains, B, T_len, H, C, stream)
                   : launch_t<__nv_bfloat16, false>(chains, n_chains, B, T_len, H, C, stream);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of C blocks of the f32 kernel at H the card holds at
// once (cudaOccupancyMaxActiveClusters), each block on an SM of its own; 0
// where no GPC has C free SMs. The bf16 kernel needs no more shared memory.
template <int KJ>
int max_clusters_k(int H, int C, int* clusters) {
  cudaError_t err = prepare<float, KJ, true>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config = config_of(&cluster, 1, 1, H, C, sizeof(float), nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, scan_cluster_kernel<float, KJ, true>,
                                             &config);
}

inline int max_clusters(int H, int C, int* clusters) {
  if (!shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  switch (H / kRowBlock) {
    case 2: return max_clusters_k<2>(H, C, clusters);
    case 3: return max_clusters_k<3>(H, C, clusters);
    case 4: return max_clusters_k<4>(H, C, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cluster_scan

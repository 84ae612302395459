// Reverse recurrence of the LSTM for few sequences at H > 128 (Hopper, sm_90a):
// one chain of one sequence spread over a thread-block cluster.
//
// Included by csrc/lstm_scan_bwd.cu and launched there as path 4, "cluster"
// (ops/lstm_scan.py:_plan_bwd picks it and the cluster size). ops/_build.py hashes
// this header into the key of every source. It replaces, for these calls, the
// backward of the TPU kernels of dnn_based_source_separation_tpu/ops/pallas_lstm.py:
//   `_lstm_bwd` (:230) of lstm_scan and `_bidir_bwd` (:339) of lstm_scan_bidir,
//   both `_lstm_bwd_core` (:182-227), whose reverse `lax.scan` this is.
//
// It computes the FMA kernel's function (csrc/lstm_scan_bwd.cu): per chain and
// sequence, walking t from T-1 down to 0 with dh_rec = dc_rec = 0,
//     i, f, g, o from gates[b, t, :] (the f32 pre-activations of one addmm outside)
//     dh = f32(g_hs[t]) + dh_rec;  dc = dc_rec + dh o (1 - tanh(c_t)^2)
//     da = [da_i, da_f, da_g, da_o] -> das[b, t, :] (f32), and d_xw in bfloat16
//     dh_rec = da @ W_hh^T;  dc_rec = dc f
// reading W_hh (H, 4H) as the forward does (not the FMA kernel's transposed copy),
// in its own dtype: bfloat16 widens to f32 exactly, so the products are exact and the
// sums f32 in both dtypes, in another order than the FMA kernel's.
//
// What bounds it. At musdb18 training (UMX / X-UMX: B = 16 x 259 frames, H = 256 a
// direction, two chains) a step is a (1 x 4H) @ (4H x H) product that depends on the
// step after it: 0.5 MFLOP, nanoseconds of the card's FMA rate. The FMA kernel gives a
// tile of sequences one block, which re-reads most of W_hh^T (1 MiB in f32) from L2
// on every step: about 18 us a step on an H100. Here the step is split over a cluster
// of C blocks (C = 8 or 16, one SM each), so W_hh stays on chip for the whole loop and
// each SM does 1/C of the product. What is left bounds a step: the W values each SM
// reads from its registers and shared memory, the da values each warp reads, the
// lane reduction, the cell derivative and the exchange of da between the SMs.
// `kProduct = false` compiles the product out (the serial floor), as the forward's does.
//
// Design (the forward's, csrc/recurrence_cluster.cuh, whose exchange it uses):
//   * the cluster owns one sequence of one chain (blockIdx.x = C * b + rank,
//     blockIdx.y the chain; the second chain arrives reversed in time). Rank r owns
//     hidden units [r H/C, (r+1) H/C), two a warp, keeps their dh_rec and dc_rec in
//     registers (the cell derivative needs no exchange) and holds W_hh's rows of
//     them, W_hh[S_r, :] (H/C x 4H): as many values as the forward's slice;
//   * each rank keeps the step's da in its shared memory in unit-major order: value
//     4 u + q is da_q of unit u (q = i, f, g, o), so a unit's four values are one
//     16-byte vector. The product dh_rec[unit] = sum_k W_hh[unit, k] da[k] splits
//     K = 4H over the lanes in row blocks of 128 values (32 units): in row block jb
//     lane l reads unit 32 jb + l's four values as one 16-byte load (a warp reads 512
//     contiguous bytes) and holds W_hh[unit, q H + 32 jb + l] of its warp's two units,
//     eight values a row block: the first kRegBlocks (8) row blocks in registers (64
//     floats; all of them at H = 256), the rest (4 at H = 384, 8 at H = 512) in shared
//     memory, 16-byte vectors a lane in its own slots. W is read once from device
//     memory, a warp's 32 lanes over 32 adjacent columns of one row;
//   * a warp's two partial sums are reduced over the 32 lanes: at xor 16 each half
//     keeps one unit and adds its partner's copy of it, then xor 8, 4, 2, 1 sum it, so
//     every lane of half-warp h holds dh_rec of unit h (2 values, 5 shuffles, where the
//     forward reduces 8). Every lane of the half-warp derives the unit's cell (the same
//     values), so dc_rec never leaves the registers;
//   * da is sent to every rank: lane p < C of each half-warp sends the unit's four
//     values as one 16-byte st.async into rank p's double-buffered da, completing 16
//     bytes on rank p's mbarrier of that buffer. Thread 0 arms its mbarrier for the
//     next step's 16 H bytes (arrive.expect_tx) and every thread waits on it
//     (try_wait.parity, acquire at cluster scope) before the next product: the same
//     count of messages as the forward's h exchange, four times its bytes. das (and
//     d_xw) are stored after the sends, one value a lane; the step's gate
//     pre-activations, c_t, c_{t-1} and g_hs are loaded a step ahead;
//   * every block takes an SM of its own (at least kOwnSm of shared memory). C = 16 is
//     a non-portable cluster size; the caller sizes its grid from max_clusters
//     (cudaOccupancyMaxActiveClusters), never from a launch that failed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_cluster.cuh"

namespace cluster_bwd {

using cluster_scan::kMaxHidden;
using cluster_scan::kMaxShared;
using cluster_scan::kMaxThreads;
using cluster_scan::kMinHidden;
using cluster_scan::kOwnSm;
using cluster_scan::kUnitsPerWarp;

constexpr int kRowBlock = 128;  // da values a warp covers in one pass: 32 lanes x 4 gates
constexpr int kRegBlocks = 8;   // row blocks each thread holds in registers: 64 floats

struct Chains {
  const float* gates[2];  // (B, T, 4H) f32 pre-activations
  const void* cs[2];      // (B, T, H) cell states, input dtype
  const void* g_hs[2];    // (B, T, H) cotangent of hs, input dtype
  const void* whh[2];     // W_hh (H, 4H), input dtype
  float* das[2];          // (B, T, 4H) f32 gate derivatives
  void* d_xw[2];          // (B, T, 4H) das rounded to bfloat16, or null (float32)
};

// A lane's eight W_hh values of a row block in shared memory, w[q][u] (gate q, unit
// u of its warp): two 16-byte vectors in f32, one in bf16 (exact in f32), each at a
// stride of 32 vectors so that a warp's loads are contiguous.
template <typename T>
struct Octet;
template <>
struct Octet<float> {
  static constexpr int kVectors = 2;
  __device__ __forceinline__ static void put(uint4* p, const float (&w)[4][kUnitsPerWarp]) {
    p[0] = make_uint4(__float_as_uint(w[0][0]), __float_as_uint(w[0][1]),
                      __float_as_uint(w[1][0]), __float_as_uint(w[1][1]));
    p[32] = make_uint4(__float_as_uint(w[2][0]), __float_as_uint(w[2][1]),
                       __float_as_uint(w[3][0]), __float_as_uint(w[3][1]));
  }
  __device__ __forceinline__ static void get(const uint4* p, float (&w)[4][kUnitsPerWarp]) {
    const uint4 a = p[0], b = p[32];
    w[0][0] = __uint_as_float(a.x); w[0][1] = __uint_as_float(a.y);
    w[1][0] = __uint_as_float(a.z); w[1][1] = __uint_as_float(a.w);
    w[2][0] = __uint_as_float(b.x); w[2][1] = __uint_as_float(b.y);
    w[3][0] = __uint_as_float(b.z); w[3][1] = __uint_as_float(b.w);
  }
};
template <>
struct Octet<__nv_bfloat16> {
  static constexpr int kVectors = 1;
  // The bf16 bits are the high half of the f32 bits; the lower half-word holds unit 0.
  __device__ __forceinline__ static unsigned pair(float a, float b) {
    return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
  }
  __device__ __forceinline__ static void put(uint4* p, const float (&w)[4][kUnitsPerWarp]) {
    p[0] = make_uint4(pair(w[0][0], w[0][1]), pair(w[1][0], w[1][1]), pair(w[2][0], w[2][1]),
                      pair(w[3][0], w[3][1]));
  }
  __device__ __forceinline__ static void get(const uint4* p, float (&w)[4][kUnitsPerWarp]) {
    const uint4 v = p[0];
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q][0] = __uint_as_float(x[q] << 16);
      w[q][1] = __uint_as_float(x[q] & 0xffff0000u);
    }
  }
};

// Shared memory of a block: the two mbarriers (16 bytes), da [2][4H] f32 (unit-major),
// and the W row blocks past kRegBlocks in T; at least kOwnSm.
__host__ __device__ constexpr size_t smem_need(int H, int C, size_t elem) {
  const int KS = 4 * H / kRowBlock > kRegBlocks ? 4 * H / kRowBlock - kRegBlocks : 0;
  return 16 + 2 * 4 * (size_t)H * 4 + (size_t)KS * kRowBlock * (H / C) * elem;
}
__host__ __device__ constexpr size_t smem_bytes(int H, int C, size_t elem) {
  return smem_need(H, C, elem) > kOwnSm ? smem_need(H, C, elem) : kOwnSm;
}

// H a multiple of 128 in 256..512; C = 8 or 16 with H / C units a rank, two a warp,
// at most kMaxThreads threads a block; the shared memory fits.
inline bool shape_ok(int H, int C) {
  return H % kRowBlock == 0 && H >= kMinHidden && H <= kMaxHidden && (C == 8 || C == 16) &&
         H % (kUnitsPerWarp * C) == 0 && 32 * (H / C / kUnitsPerWarp) <= kMaxThreads &&
         smem_bytes(H, C, 4) <= kMaxShared;
}

// One step's inputs of a lane's unit.
struct StepInputs {
  float a[4];  // gate pre-activations i, f, g, o
  float g;     // cotangent of h
  float c;     // c_t
  float cp;    // c_{t-1}, 0 at t = 0
};

template <typename T>
__device__ __forceinline__ void load_step(StepInputs& in, const float* __restrict__ gates,
                                          const T* __restrict__ cs, const T* __restrict__ g_hs,
                                          long long b, int T_len, int H, int unit, int t) {
  const float* row = gates + (b * T_len + t) * 4LL * H + unit;
#pragma unroll
  for (int q = 0; q < 4; ++q) in.a[q] = row[(long long)q * H];
  const long long at = (b * T_len + t) * H + unit;
  in.g = cluster_scan::to_f32(g_hs[at]);
  in.c = cluster_scan::to_f32(cs[at]);
  in.cp = t > 0 ? cluster_scan::to_f32(cs[at - H]) : 0.f;
}

template <typename T, int KJ, bool kProduct>
__global__ void __launch_bounds__(kMaxThreads, 1)
bwd_cluster_kernel(Chains chains, int T_len, int H, int C) {
  constexpr int KR = KJ < kRegBlocks ? KJ : kRegBlocks;  // row blocks in registers
  constexpr int V = Octet<T>::kVectors;

  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const float* __restrict__ gates = second ? chains.gates[1] : chains.gates[0];
  const T* __restrict__ cs = static_cast<const T*>(second ? chains.cs[1] : chains.cs[0]);
  const T* __restrict__ g_hs = static_cast<const T*>(second ? chains.g_hs[1] : chains.g_hs[0]);
  const T* __restrict__ whh = static_cast<const T*>(second ? chains.whh[1] : chains.whh[0]);
  float* __restrict__ das = second ? chains.das[1] : chains.das[0];
  T* __restrict__ d_xw = static_cast<T*>(second ? chains.d_xw[1] : chains.d_xw[0]);

  const int HU = H / C;               // units of this rank
  const int NW = HU / kUnitsPerWarp;  // warps of the block
  const unsigned rank = tf32_scan::cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ubase = (int)rank * HU;
  const long long b = blockIdx.x / C;  // the sequence
  const long long G4 = 4LL * H;

  extern __shared__ float4 smem_cluster_bwd[];
  uint64_t* mbars = reinterpret_cast<uint64_t*>(smem_cluster_bwd);  // [2]: da of the buffer arrived
  float* dabuf = reinterpret_cast<float*>(smem_cluster_bwd + 1);     // [2][4H], value 4 u + q
  uint4* wsm = reinterpret_cast<uint4*>(dabuf + 8 * H);  // [KJ-KR][NW][V][32 lanes]

  // W_hh values of this thread: w[jb][q][u] = W_hh[unit u of its warp, q H + 32 jb + lane].
  float w[KR][4][kUnitsPerWarp];
  if (kProduct) {
#pragma unroll
    for (int jb = 0; jb < KJ; ++jb) {
      float g[4][kUnitsPerWarp];
#pragma unroll
      for (int u = 0; u < kUnitsPerWarp; ++u) {
        const T* row = whh + (long long)(ubase + kUnitsPerWarp * warp + u) * G4 + 32 * jb + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q][u] = cluster_scan::to_f32(row[(long long)q * H]);
      }
      if (jb < KR) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < kUnitsPerWarp; ++u) w[jb < KR ? jb : 0][q][u] = g[q][u];
      } else {
        Octet<T>::put(wsm + ((jb - KR) * NW + warp) * V * 32 + lane, g);
      }
    }
  }
  for (int i = tid; i < 8 * H; i += blockDim.x) dabuf[i] = 0.f;  // dh_rec = 0 at t = T - 1
  const unsigned mbar = tf32_scan::smem_addr(mbars);
  if (tid == 0) {
    cluster_scan::mbar_init(mbar);
    cluster_scan::mbar_init(mbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Lane l derives unit u_l of its warp; lane p < C of each half-warp sends it to
  // rank p, lane p < 4 stores its gate p.
  const int u_l = lane >> 4;
  const int unit = ubase + kUnitsPerWarp * warp + u_l;
  const int p = lane & 15;
  const unsigned peer = tf32_scan::map_to_rank(tf32_scan::smem_addr(dabuf), p < C ? p : 0);
  const unsigned peer_mbar = tf32_scan::map_to_rank(mbar, p < C ? p : 0);
  StepInputs in;
  load_step<T>(in, gates, cs, g_hs, b, T_len, H, unit, T_len - 1);
  float dc_rec = 0.f;

  // W staged, da zeroed and the mbarriers set up in every block, and every block
  // running, before any write to another's shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();

  // Step s (t = T - 1 - s) reads da of step s - 1 from buffer s % 2 and sends its
  // own into buffer (s+1) % 2 of every rank. A rank sends da of step s only after it
  // has all of step s - 1's, which every rank sent after its reads of step s - 1:
  // so a buffer is never written while it is read, and an mbarrier's next phase
  // never starts before its last one completed.
#pragma unroll 1
  for (int s = 0; s < T_len; ++s) {
    const int t = T_len - 1 - s;
    const float* dcur = dabuf + (s & 1) * 4 * H;  // da of step t + 1
    const unsigned next = 4u * (unsigned)(((s + 1) & 1) * 4 * H + 4 * unit);
    const unsigned next_mbar = 8u * (unsigned)((s + 1) & 1);
    if (tid == 0 && s + 1 < T_len) cluster_scan::mbar_expect(mbar + next_mbar, 16u * (unsigned)H);
    if (s > 0)
      cluster_scan::mbar_wait(mbar + 8u * (unsigned)(s & 1), (unsigned)((s - 1) >> 1) & 1u);
    const StepInputs cur = in;
    if (t > 0) load_step<T>(in, gates, cs, g_hs, b, T_len, H, unit, t - 1);

    float acc[kUnitsPerWarp] = {0.f, 0.f};
    if (kProduct) {
#pragma unroll
      for (int jb = 0; jb < KR; ++jb) {
        const float4 dv = *reinterpret_cast<const float4*>(dcur + kRowBlock * jb + 4 * lane);
        const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < kUnitsPerWarp; ++u) acc[u] = fmaf(d[q], w[jb][q][u], acc[u]);
      }
      // The row blocks in shared memory, two at a time: unrolled whole, the bf16
      // kernel at H = 512 spilled (its unpacked values live beside the 64 of w).
#pragma unroll 2
      for (int jb = KR; jb < KJ; ++jb) {
        const float4 dv = *reinterpret_cast<const float4*>(dcur + kRowBlock * jb + 4 * lane);
        const float d[4] = {dv.x, dv.y, dv.z, dv.w};
        float g[4][kUnitsPerWarp];
        Octet<T>::get(wsm + ((jb - KR) * NW + warp) * V * 32 + lane, g);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < kUnitsPerWarp; ++u) acc[u] = fmaf(d[q], g[q][u], acc[u]);
      }
    }

    // Half-warp h keeps unit h: xor 16 swaps the halves' copies, then 8, 4, 2, 1 sum.
    const bool hi = lane & 16;
    float dh_rec = (hi ? acc[1] : acc[0]) + __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[1], 16);
    dh_rec += __shfl_xor_sync(0xffffffffu, dh_rec, 8);
    dh_rec += __shfl_xor_sync(0xffffffffu, dh_rec, 4);
    dh_rec += __shfl_xor_sync(0xffffffffu, dh_rec, 2);
    dh_rec += __shfl_xor_sync(0xffffffffu, dh_rec, 1);

    const float gi = cluster_scan::sigmoid(cur.a[0]);
    const float gf = cluster_scan::sigmoid(cur.a[1]);
    const float gg = tanhf(cur.a[2]);
    const float go = cluster_scan::sigmoid(cur.a[3]);
    const float tc = tanhf(cur.c);
    const float dh = cur.g + dh_rec;
    const float dc = dc_rec + dh * go * (1.f - tc * tc);
    const float4 da = make_float4(dc * gg * gi * (1.f - gi), dc * cur.cp * gf * (1.f - gf),
                                  dc * gi * (1.f - gg * gg), dh * tc * go * (1.f - go));
    dc_rec = dc * gf;

    if (p < C && s + 1 < T_len) cluster_scan::st_async_v4(peer + next, da, peer_mbar + next_mbar);
    if (p < 4) {
      const float v = p == 0 ? da.x : p == 1 ? da.y : p == 2 ? da.z : da.w;
      const long long o = (b * T_len + t) * G4 + (long long)p * H + unit;
      das[o] = v;
      if (d_xw != nullptr) cluster_scan::store(d_xw + o, v);
    }
  }
  // No block leaves while another may still write to its shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();
}

// static: the flag is this library's (see cluster_scan::prepare).
template <typename T, int KJ, bool kProduct>
static cudaError_t prepare() {
  static bool done = false;  // per instantiation
  return cluster_scan::allow(bwd_cluster_kernel<T, KJ, kProduct>, done);
}

inline cudaLaunchConfig_t config_of(cudaLaunchAttribute* cluster, int B, int n_chains, int H,
                                    int C, size_t elem, cudaStream_t stream) {
  return cluster_scan::cluster_config(cluster, B, n_chains, C,
                                      (unsigned)(32 * (H / C / kUnitsPerWarp)),
                                      smem_bytes(H, C, elem), stream);
}

template <typename T, int KJ, bool kProduct>
int launch_k(const Chains& chains, int n_chains, int B, int T_len, int H, int C,
             cudaStream_t stream) {
  cudaError_t err = prepare<T, KJ, kProduct>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config = config_of(&cluster, B, n_chains, H, C, sizeof(T), stream);
  err = cudaLaunchKernelEx(&config, bwd_cluster_kernel<T, KJ, kProduct>, chains, T_len, H, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// KJ = 4H / 128 row blocks: 8, 12 or 16.
template <typename T, bool kProduct>
int launch_t(const Chains& chains, int n_chains, int B, int T_len, int H, int C,
             cudaStream_t stream) {
  switch (4 * H / kRowBlock) {
    case 8: return launch_k<T, 8, kProduct>(chains, n_chains, B, T_len, H, C, stream);
    case 12: return launch_k<T, 12, kProduct>(chains, n_chains, B, T_len, H, C, stream);
    case 16: return launch_k<T, 16, kProduct>(chains, n_chains, B, T_len, H, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The "cluster" backward: one sequence a cluster of C blocks (dtype 0 float32,
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

// How many clusters of C blocks of the f32 kernel at H the card holds at once
// (cudaOccupancyMaxActiveClusters), each block on an SM of its own; 0 where no GPC
// has C free SMs. The bf16 kernel needs no more shared memory.
template <int KJ>
int max_clusters_k(int H, int C, int* clusters) {
  cudaError_t err = prepare<float, KJ, true>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config = config_of(&cluster, 1, 1, H, C, sizeof(float), nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, bwd_cluster_kernel<float, KJ, true>,
                                             &config);
}

inline int max_clusters(int H, int C, int* clusters) {
  if (!shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  switch (4 * H / kRowBlock) {
    case 8: return max_clusters_k<8>(H, C, clusters);
    case 12: return max_clusters_k<12>(H, C, clusters);
    case 16: return max_clusters_k<16>(H, C, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cluster_bwd

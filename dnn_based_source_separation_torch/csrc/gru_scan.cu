// Fused GRU recurrences for the dual-path separators (Hopper, sm_90a).
//
// Replaces the TPU kernel of dnn_based_source_separation_tpu/ops/pallas_lstm.py:
//   gru_scan_bidir (_gru_bidir_kernel): two chains, the second over a sequence
//                  the caller has already reversed in time.
// and adds its one-chain instance, gru_scan, for the unidirectional (causal)
// inter-chunk GRU, which the JAX package runs in lax.scan. Forward only.
//
// Per chain and sequence, with h = 0 at the start and torch gate order r, z, n:
//
//     g = f32(h rounded to the weight dtype) @ f32(W_hh) + f32(b_hh)
//     r = sigmoid(x_r + g_r);  z = sigmoid(x_z + g_z);  n = tanh(x_n + r * g_n)
//     h = (1 - z) * n + z * h;  hs[b, t, :] = h rounded to the dtype
//
// where x = xw[b, t, :] already holds x @ W_ih + b_ih. b_hh cannot be folded
// into xw: its n-part sits inside the reset gate. xw (B, T, 3H), W_hh (H, 3H)
// and b_hh (3H,) share one dtype, float32 or bfloat16; the products are exact
// in f32 and summed in f32, and h is carried in f32, as the Pallas kernel
// carries it in f32 VMEM scratch.
//
// What bounds the FMA kernel. Every step of a chain depends on the step
// before, so time is a loop inside the block, and only independent sequences
// run in parallel. Per step and sequence the recurrent product is H x 3H FMAs
// (49,152 at H = 128) against 3H values of xw read and H written: the
// kernel is bound by FMA issue and shared-memory reads inside each SM, not
// by device memory.
//
// Three paths, chosen by the caller (ops/gru_scan.py:_plan, the LSTM's rule)
// from the dtype and the shape before the launch, never after a failure:
//   * "mma": bfloat16 with H a multiple of 16 up to 128, the tensor-core
//     kernel of csrc/recurrence_mma.cuh with the GRU cell below, on M-row
//     tiles (M = 16 or 32). The n-part of the product is its own n8 tiles,
//     so r * (W_hn h + b_hn) needs no extra accumulator;
//   * "tf32x3": float32 with the same H, the 3xTF32 tensor-core kernel of
//     csrc/recurrence_tf32.cuh with the same cell, on M-row tiles (M = 16,
//     32 or 64) held by a cluster of 2 or 4 blocks;
//   * "fma": every other call, the FMA kernel of this file, on tiles of R
//     sequences per group.
//
// The FMA kernel's design (that of csrc/lstm_scan.cu; simple and right
// first, walking the reverse chain inside the kernel is later work):
//   * one block owns a tile of TB = groups * R sequences of one chain
//     (blockIdx.y is the chain). Thread (g, p) of the block owns hidden units
//     2p and 2p + 1 of the R sequences of group g, so it computes all three
//     gates of its units itself and keeps their f32 h in registers: the
//     update needs no exchange, and the only barrier per step is the one that
//     publishes h;
//   * W_hh is staged once into shared memory in its (H, 3H) row-major layout.
//     A thread reads its two adjacent columns of a row as one 4-byte (bf16)
//     or 8-byte (f32) load, so a warp reads 128 or 256 contiguous bytes with
//     no bank conflict. At H = 128 it is 96 KB in bf16 and 192 KB in f32;
//     both fit a block's 227 KB with the h buffers. For wider H the first KS
//     rows that fit go to shared memory and the rest are read from global
//     memory (L2-resident: every block of the chain reads the same matrix);
//   * the thread's six b_hh values sit in registers for the whole loop;
//   * h is published in shared memory as f32 (already rounded to the weight
//     dtype), double-buffered by step parity, so one __syncthreads() per step
//     suffices. Each group reads its own R rows of h as 16-byte broadcasts;
//   * the step's xw values are loaded into registers before the recurrent
//     product, so their latency hides behind it;
//   * R in {4, 2, 1} comes from the caller: the largest that still gives
//     every SM a block, because a single request (about 255 sequences per
//     chain at B = 1) cannot fill 132 SMs with large tiles, and per-step
//     latency grows with R.
//
// Bound with ctypes (ops/_build.py); the C entry points return
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_mma.cuh"
#include "recurrence_tf32.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling

struct Chains {
  const void* xw[2];
  const void* whh[2];
  const void* bhh[2];
  void* hs[2];
};

// Two adjacent elements as f32. bf16 -> f32 is exact: the bf16 bits are the
// high half of the f32 bits, and the lower address holds the low half-word.
__device__ __forceinline__ float2 unpack(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return unpack(*reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {
  return unpack(__ldg(reinterpret_cast<const unsigned*>(p)));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float lo_hi(float2 v, int e) { return e ? v.y : v.x; }

// The GRU cell of the tensor-core path (csrc/recurrence_mma.cuh): the r and
// z accumulators start from f32(x) + f32(b_hh) and the n accumulator from
// f32(b_hn) alone, so after the product it holds W_hn h + b_hn; the carried
// state is the f32 h.
struct GruCell {
  static constexpr int kGates = 3;
  static constexpr bool kBias = true;
  static constexpr bool kCellState = false;
  __device__ __forceinline__ static void start(float (&acc)[3][4], const float (&x)[3][4],
                                               const float (&bias)[3][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0][j] = x[0][j] + bias[0][j & 1];
      acc[1][j] = x[1][j] + bias[1][j & 1];
      acc[2][j] = bias[2][j & 1];
    }
  }
  __device__ __forceinline__ static float update(const float (&acc)[3][4], const float (&x)[3][4],
                                                 int j, float& h) {
    const float rg = mma_scan::sigmoid(acc[0][j]);
    const float zg = mma_scan::sigmoid(acc[1][j]);
    const float ng = tanhf(x[2][j] + rg * acc[2][j]);
    h = (1.f - zg) * ng + zg * h;
    return h;
  }
};

// acc[r][q] += h[r, k0:k1] @ W[k0:k1, q*H + u : q*H + u + 2] for the R
// sequences of the group. `w` points at row 0 of the (H, 3H) matrix, in
// shared (kShared) or global memory; h rows are H floats apart.
template <typename T, int R, bool kShared>
__device__ __forceinline__ void accumulate(const T* __restrict__ w, int k0, int k1, int H, int u,
                                           const float* __restrict__ h, float2 (&acc)[R][3]) {
  const long long ld = 3LL * H;
  for (int k = k0; k < k1; k += 4) {
    float hv[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(h + r * H + k);
      hv[r][0] = v.x; hv[r][1] = v.y; hv[r][2] = v.z; hv[r][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const T* row = w + (k + kk) * ld + u;
      float2 wq[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) wq[q] = kShared ? load_pair(row + q * H) : ldg_pair(row + q * H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          acc[r][q].x = fmaf(hv[r][kk], wq[q].x, acc[r][q].x);
          acc[r][q].y = fmaf(hv[r][kk], wq[q].y, acc[r][q].y);
        }
      }
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_kernel(Chains chains, int B, int T_len, int H, int groups, int KS) {
  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const T* __restrict__ xw = static_cast<const T*>(second ? chains.xw[1] : chains.xw[0]);
  const T* __restrict__ whh = static_cast<const T*>(second ? chains.whh[1] : chains.whh[0]);
  const T* __restrict__ bhh = static_cast<const T*>(second ? chains.bhh[1] : chains.bhh[0]);
  T* __restrict__ hs = static_cast<T*>(second ? chains.hs[1] : chains.hs[0]);
  const int TB = groups * R;
  const long long G3 = 3LL * H;

  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);     // [2][TB][H], f32
  T* ws = reinterpret_cast<T*>(hbuf + 2 * TB * H);   // [KS][3H], rows 0..KS-1 of W_hh

  // Stage W_hh rows [0, KS) with 16-byte copies; zero h for step 0.
  {
    const int n16 = (int)(KS * G3 * (long long)sizeof(T) / 16);
    const uint4* src = reinterpret_cast<const uint4*>(whh);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = __ldg(src + i);
    for (int i = threadIdx.x; i < TB * H; i += blockDim.x) hbuf[i] = 0.f;
  }
  __syncthreads();

  const int half = H / 2;
  const int g = threadIdx.x / half;
  const int u = 2 * (threadIdx.x - g * half);
  const long long b0 = (long long)blockIdx.x * TB + g * R;

  float2 bias[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) bias[q] = ldg_pair(bhh + q * H + u);

  float hc[R][2];  // the carried f32 h of this thread's two units
#pragma unroll
  for (int r = 0; r < R; ++r) hc[r][0] = hc[r][1] = 0.f;

  for (int t = 0; t < T_len; ++t) {
    const float* hprev = hbuf + (t & 1) * TB * H + g * R * H;
    float* hnext = hbuf + ((t + 1) & 1) * TB * H + g * R * H;

    float2 xv[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long b = b0 + r;
      if (b < B) {
        const T* row = xw + (b * T_len + t) * G3 + u;
#pragma unroll
        for (int q = 0; q < 3; ++q) xv[r][q] = ldg_pair(row + q * H);
      } else {
#pragma unroll
        for (int q = 0; q < 3; ++q) xv[r][q] = make_float2(0.f, 0.f);
      }
    }

    float2 acc[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) acc[r][q] = make_float2(0.f, 0.f);
    accumulate<T, R, true>(ws, 0, KS, H, u, hprev, acc);
    accumulate<T, R, false>(whh, KS, H, H, u, hprev, acc);  // rows that did not fit

#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gr = lo_hi(acc[r][0], e) + lo_hi(bias[0], e);
        const float gz = lo_hi(acc[r][1], e) + lo_hi(bias[1], e);
        const float gn = lo_hi(acc[r][2], e) + lo_hi(bias[2], e);
        const float rg = sigmoid(lo_hi(xv[r][0], e) + gr);
        const float zg = sigmoid(lo_hi(xv[r][1], e) + gz);
        const float ng = tanhf(lo_hi(xv[r][2], e) + rg * gn);
        hc[r][e] = (1.f - zg) * ng + zg * hc[r][e];
      }
      const long long b = b0 + r;
      if (b < B) store_pair(hs + (b * T_len + t) * H + u, hc[r][0], hc[r][1]);
      // The next product reads h rounded to the weight dtype, as Pallas does.
      *reinterpret_cast<float2*>(hnext + r * H + u) =
          make_float2(round_to(hc[r][0], whh), round_to(hc[r][1], whh));
    }
    __syncthreads();
  }
}

template <typename T, int R>
int launch_r(const Chains& chains, int n_chains, int B, int T_len, int H, int groups,
             cudaStream_t stream) {
  const int TB = groups * R;
  const long long hbytes = 2LL * TB * H * sizeof(float);
  const long long row_bytes = 3LL * H * sizeof(T);
  long long ks = (kMaxShared - hbytes) / row_bytes;
  ks = ks < H ? ks / 4 * 4 : H;
  if (ks < 0) return (int)cudaErrorInvalidConfiguration;
  const int KS = (int)ks;
  const size_t smem = (size_t)(hbytes + KS * row_bytes);
  auto kernel = gru_kernel<T, R>;
  static size_t opted_in = 0;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((unsigned)((B + TB - 1) / TB), (unsigned)n_chains);
  kernel<<<grid, groups * (H / 2), smem, stream>>>(chains, B, T_len, H, groups, KS);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma(const Chains& chains, int n_chains, int B, int T_len, int H, int R,
               cudaStream_t stream) {
  if (H < 4 || H % 4 || H / 2 > kMaxThreads || B < 1 || T_len < 1)
    return (int)cudaErrorInvalidValue;
  int groups = kMaxThreads / (H / 2);
  if (groups > 4) groups = 4;
  if (R == 4) return launch_r<T, 4>(chains, n_chains, B, T_len, H, groups, stream);
  if (R == 2) return launch_r<T, 2>(chains, n_chains, B, T_len, H, groups, stream);
  if (R == 1) return launch_r<T, 1>(chains, n_chains, B, T_len, H, groups, stream);
  return (int)cudaErrorInvalidValue;
}

// path 0: the FMA kernel with tile R; path 1: the tensor-core kernel
// (bfloat16 only) with tile M; path 2: the 3xTF32 kernel (float32 only)
// with tile M and clusters of `cluster` blocks (ignored by the others).
int dispatch(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int path,
             int tile, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    const tf32_scan::Chains tc = {
        {static_cast<const float*>(chains.xw[0]), static_cast<const float*>(chains.xw[1])},
        {static_cast<const float*>(chains.whh[0]), static_cast<const float*>(chains.whh[1])},
        {static_cast<const float*>(chains.bhh[0]), static_cast<const float*>(chains.bhh[1])},
        {static_cast<float*>(chains.hs[0]), static_cast<float*>(chains.hs[1])},
        {nullptr, nullptr}};
    return tf32_scan::launch<GruCell>(tc, n_chains, B, T_len, H, tile, cluster, st);
  }
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const mma_scan::Chains mc = {
        {static_cast<const mma_scan::bf16*>(chains.xw[0]),
         static_cast<const mma_scan::bf16*>(chains.xw[1])},
        {static_cast<const mma_scan::bf16*>(chains.whh[0]),
         static_cast<const mma_scan::bf16*>(chains.whh[1])},
        {static_cast<const mma_scan::bf16*>(chains.bhh[0]),
         static_cast<const mma_scan::bf16*>(chains.bhh[1])},
        {static_cast<mma_scan::bf16*>(chains.hs[0]), static_cast<mma_scan::bf16*>(chains.hs[1])},
        {nullptr, nullptr}};
    return mma_scan::launch<GruCell>(mc, n_chains, B, T_len, H, tile, st);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fma<float>(chains, n_chains, B, T_len, H, tile, st);
  if (dtype == 1) return launch_fma<__nv_bfloat16>(chains, n_chains, B, T_len, H, tile, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xw, W_hh, b_hh and hs share it). All
// arrays are contiguous: xw (B, T, 3H), W_hh (H, 3H), b_hh (3H,), hs (B, T, H).
// path 0 (FMA, tile = R in {1, 2, 4}), 1 (tensor cores, bfloat16,
// H % 16 == 0 and H <= 128, tile = M in {16, 32}) or 2 (3xTF32, float32, the
// same H, tile = M in {16, 32, 64}, cluster = C in {2, 4} with H % 8C == 0),
// from ops/gru_scan.py:_plan; `cluster` is read on path 2 only.
// Returns a cudaError_t (0 on success). The Python wrapper validates every
// argument.
extern "C" int gru_scan_launch(const void* xw, const void* whh, const void* bhh, void* hs,
                               int dtype, int B, int T, int H, int path, int tile, int cluster,
                               void* stream) {
  Chains chains = {{xw, nullptr}, {whh, nullptr}, {bhh, nullptr}, {hs, nullptr}};
  return dispatch(chains, 1, dtype, B, T, H, path, tile, cluster, stream);
}

// Two chains of one shape: the forward one and the one over the reversed
// sequence, each with its own W_hh and b_hh; hs_b comes back in reversed
// time order.
extern "C" int gru_scan_bidir_launch(const void* xw_f, const void* xw_b, const void* whh_f,
                                     const void* whh_b, const void* bhh_f, const void* bhh_b,
                                     void* hs_f, void* hs_b, int dtype, int B, int T, int H,
                                     int path, int tile, int cluster, void* stream) {
  Chains chains = {{xw_f, xw_b}, {whh_f, whh_b}, {bhh_f, bhh_b}, {hs_f, hs_b}};
  return dispatch(chains, 2, dtype, B, T, H, path, tile, cluster, stream);
}

// The clusters of C blocks of the 3xTF32 kernel at hidden size H that the
// current card holds at once, each block on an SM of its own, into *clusters
// (what _plan fits a wave to).
extern "C" int gru_scan_tf32_clusters(int H, int C, int* clusters) {
  return tf32_scan::max_clusters<GruCell>(H, C, clusters);
}

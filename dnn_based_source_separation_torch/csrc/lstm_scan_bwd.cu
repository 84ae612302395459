// Reverse recurrence of the fused LSTM scans, for training (Hopper, sm_90a).
//
// Replaces the backward of the TPU kernels of
// dnn_based_source_separation_tpu/ops/pallas_lstm.py: the `jax.custom_vjp`
// backward `_lstm_bwd` (lstm_scan) and `_bidir_bwd` (lstm_scan_bidir), both
// of which run `_lstm_bwd_core`'s reverse `lax.scan` (:201-220). One launch
// takes one chain or both chains of a bidirectional layer.
//
// Per chain and sequence, walking t from T-1 down to 0 with dh_rec = dc_rec = 0:
//
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of gates[b, t, :]
//     tc = tanh(f32(cs[t]));  cp = f32(cs[t-1]) (0 at t = 0)
//     dh = f32(g_hs[t]) + dh_rec
//     da_o = dh * tc * o * (1 - o);   dc = dc_rec + dh * o * (1 - tc^2)
//     da_i = dc * g * i * (1 - i);    da_f = dc * cp * f * (1 - f)
//     da_g = dc * i * (1 - g^2)
//     das[b, t, :] = [da_i, da_f, da_g, da_o]              (f32)
//     dh_rec = da @ W_hh^T (f32);     dc_rec = dc * f
//
// The gate pre-activations `gates = f32(xw) + f32(h_prev) @ f32(W_hh)` come
// in as one (B, T, 4H) f32 array (one large matmul outside, as the JAX
// package computes it outside Pallas), and so do the products around the
// recurrence: d_W_hh = h_prev^T @ das. In bfloat16 the kernel also writes
// d_xw = das rounded to bfloat16 beside the f32 das (in f32 das is d_xw).
// cs is the forward kernel's cell state as written, in the input dtype, so
// in bfloat16 the backward sees the rounded c, as the Pallas kernel's does.
// W_hh is read in its own dtype: bfloat16 widens to f32 exactly.
//
// Four paths, chosen by the caller (ops/lstm_scan.py:_plan_bwd) from the dtype,
// the shape and the card's co-resident clusters before the launch, never after a
// failure:
//   * "tf32x3" (float32) and "tf32x2" (bfloat16) for H a multiple of 16 up to
//     128: the tensor-core kernel of csrc/recurrence_bwd_tf32.cuh with the
//     cell LstmBwdCell below, the product in three (f32 W) or two (bf16 W)
//     TF32 products on a cluster of 2 or 4 blocks; it reads W_hh (H, 4H);
//   * "wide" (either dtype) for many sequences at H = 256 (DPTNet training's 1278
//     and 200): the kernel of csrc/recurrence_wide_bwd.cuh, an M-row tile a cluster
//     of C blocks, each with its units' gate columns of W_hh on chip, the product on
//     the tensor cores and its partial sums reduce-scattered; it reads W_hh (H, 4H);
//   * "cluster" (either dtype) for few sequences at H = 256, 384 or 512 (musdb18
//     training's B = 16): the kernel of csrc/recurrence_cluster_bwd.cuh, one
//     sequence a cluster of 8 or 16 blocks with W_hh on chip; it reads W_hh (H, 4H);
//   * "fma": every other call (H = 40, many sequences at H = 384 and 512, ...), the
//     FMA kernel of this file; it reads W_hh^T (4H, H).
//
// What bounds the FMA kernel. The same as the forward (csrc/lstm_scan.cu): each
// step of a chain depends on the one after it, so time is a loop inside the
// block and only independent sequences run in parallel. Per step and sequence
// the recurrent product is 4H x H FMAs (65,536 at H = 128) against 4H gate
// values read and 4H derivatives written: FMA issue and shared-memory
// bandwidth inside each SM, not device memory.
//
// The FMA kernel's design (the forward kernel's structure):
//   * one block owns a tile of TB = groups * R sequences of one chain
//     (blockIdx.y is the chain). Thread (g, p) owns hidden units 2p and
//     2p + 1 of the R sequences of group g and computes the four gate
//     derivatives of both itself, so dh_rec and dc_rec stay in its
//     registers: the only values exchanged are the step's da;
//   * da is published in shared memory as f32, double-buffered by step
//     parity, so one __syncthreads() per step suffices: a thread that runs
//     ahead writes the other buffer, and the buffer it will write next is
//     read by nobody until every thread has passed the next barrier;
//   * W_hh^T is staged once into shared memory as (4H, H) row-major. A thread
//     reads its two adjacent columns of a row as one 4-byte (bf16) or 8-byte
//     (f32) load, so a warp reads 128 or 256 contiguous bytes with no bank
//     conflict. In bf16, H = 128 gives 128 KB, which fits; in f32 the 256 KB
//     do not, so the first KS rows that fit go to shared memory and the rest
//     are read from global memory (L2-resident: every block of the chain
//     reads the same matrix);
//   * the next step's gates, cs and g_hs are loaded into registers before
//     the recurrent product, so their latency hides behind it;
//   * R per group comes from the caller, by the forward's rule: the largest
//     of 4, 2, 1 that still gives every SM a block.
//
// Bound with ctypes (ops/_build.py); the C entry points return
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_bwd_tf32.cuh"
#include "recurrence_cluster_bwd.cuh"
#include "recurrence_wide_bwd.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling

struct Chains {
  const float* gates[2];  // (B, T, 4H) f32 pre-activations
  const void* cs[2];      // (B, T, H) cell states, input dtype
  const void* g_hs[2];    // (B, T, H) cotangent of hs, input dtype
  const void* w[2];       // W_hh^T (4H, H) on the FMA path, W_hh (H, 4H) on the others
  float* das[2];          // (B, T, 4H) f32 gate derivatives
  void* d_xw[2];          // (B, T, 4H) das rounded to bfloat16, or null (float32)
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
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// acc[r] += da[r, k0:k1] @ WT[k0:k1, u : u + 2] for the R sequences of the
// group. `wt` points at row 0 of the (4H, H) matrix, in shared (kShared) or
// global memory; da rows are 4H floats apart.
template <typename T, int R, bool kShared>
__device__ __forceinline__ void accumulate(const T* __restrict__ wt, int k0, int k1, int H, int u,
                                           const float* __restrict__ da, float2 (&acc)[R]) {
  const int G4 = 4 * H;
  for (int k = k0; k < k1; k += 4) {
    float dv[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(da + r * G4 + k);
      dv[r][0] = v.x; dv[r][1] = v.y; dv[r][2] = v.z; dv[r][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const T* row = wt + (long long)(k + kk) * H + u;
      const float2 w = kShared ? load_pair(row) : ldg_pair(row);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r].x = fmaf(dv[r][kk], w.x, acc[r].x);
        acc[r].y = fmaf(dv[r][kk], w.y, acc[r].y);
      }
    }
  }
}

// One step's inputs of the R sequences of a thread's group, its two units.
template <int R>
struct StepInputs {
  float2 a[R][4];  // gate pre-activations i, f, g, o
  float2 g[R];     // cotangent of h
  float2 c[R];     // c_t
  float2 cp[R];    // c_{t-1}
};

template <typename T, int R>
__device__ __forceinline__ void load_step(StepInputs<R>& in, const float* __restrict__ gates,
                                          const T* __restrict__ cs, const T* __restrict__ g_hs,
                                          long long b0, int B, int T_len, int H, int u, int t) {
  const long long G4 = 4LL * H;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long b = b0 + r;
    if (b < B) {
      const float* row = gates + (b * T_len + t) * G4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.a[r][q] = ldg_pair(row + q * H);
      const long long at = (b * T_len + t) * H + u;
      in.g[r] = ldg_pair(g_hs + at);
      in.c[r] = ldg_pair(cs + at);
      in.cp[r] = t > 0 ? ldg_pair(cs + at - H) : make_float2(0.f, 0.f);
    } else {
      // Padding rows: a zero cotangent keeps every derivative of the row zero.
#pragma unroll
      for (int q = 0; q < 4; ++q) in.a[r][q] = make_float2(0.f, 0.f);
      in.g[r] = in.c[r] = in.cp[r] = make_float2(0.f, 0.f);
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_kernel(Chains chains, int B, int T_len, int H, int groups, int KS) {
  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const float* __restrict__ gates = second ? chains.gates[1] : chains.gates[0];
  const T* __restrict__ cs = static_cast<const T*>(second ? chains.cs[1] : chains.cs[0]);
  const T* __restrict__ g_hs = static_cast<const T*>(second ? chains.g_hs[1] : chains.g_hs[0]);
  const T* __restrict__ wt = static_cast<const T*>(second ? chains.w[1] : chains.w[0]);
  float* __restrict__ das = second ? chains.das[1] : chains.das[0];
  T* __restrict__ d_xw = static_cast<T*>(second ? chains.d_xw[1] : chains.d_xw[0]);
  const int TB = groups * R;
  const int G4 = 4 * H;

  extern __shared__ float4 smem4[];
  float* dabuf = reinterpret_cast<float*>(smem4);     // [2][TB][4H], f32
  T* ws = reinterpret_cast<T*>(dabuf + 2 * TB * G4);  // [KS][H], rows 0..KS-1 of W_hh^T

  // Stage W_hh^T rows [0, KS) with 16-byte copies.
  {
    const int n16 = (int)((long long)KS * H * sizeof(T) / 16);
    const uint4* src = reinterpret_cast<const uint4*>(wt);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = __ldg(src + i);
  }
  __syncthreads();

  const int half = H / 2;
  const int g = threadIdx.x / half;
  const int u = 2 * (threadIdx.x - g * half);
  const long long b0 = (long long)blockIdx.x * TB + g * R;

  float2 dh_rec[R], dc_rec[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh_rec[r] = dc_rec[r] = make_float2(0.f, 0.f);

  StepInputs<R> in;
  load_step<T, R>(in, gates, cs, g_hs, b0, B, T_len, H, u, T_len - 1);
  for (int t = T_len - 1; t >= 0; --t) {
    float* da = dabuf + (t & 1) * TB * G4 + g * R * G4;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gi = sigmoid(e ? in.a[r][0].y : in.a[r][0].x);
        const float gf = sigmoid(e ? in.a[r][1].y : in.a[r][1].x);
        const float gg = tanhf(e ? in.a[r][2].y : in.a[r][2].x);
        const float go = sigmoid(e ? in.a[r][3].y : in.a[r][3].x);
        const float tc = tanhf(e ? in.c[r].y : in.c[r].x);
        const float cp = e ? in.cp[r].y : in.cp[r].x;
        const float dh = (e ? in.g[r].y : in.g[r].x) + (e ? dh_rec[r].y : dh_rec[r].x);
        const float dc = (e ? dc_rec[r].y : dc_rec[r].x) + dh * go * (1.f - tc * tc);
        d[0][e] = dc * gg * gi * (1.f - gi);
        d[1][e] = dc * cp * gf * (1.f - gf);
        d[2][e] = dc * gi * (1.f - gg * gg);
        d[3][e] = dh * tc * go * (1.f - go);
        if (e) dc_rec[r].y = dc * gf; else dc_rec[r].x = dc * gf;
      }
      const long long b = b0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = make_float2(d[q][0], d[q][1]);
        *reinterpret_cast<float2*>(da + r * G4 + q * H + u) = v;
        if (b < B) {
          const long long at = (b * T_len + t) * G4 + q * H + u;
          *reinterpret_cast<float2*>(das + at) = v;
          if (d_xw != nullptr) store_pair(d_xw + at, v.x, v.y);
        }
      }
    }
    __syncthreads();
    if (t > 0) load_step<T, R>(in, gates, cs, g_hs, b0, B, T_len, H, u, t - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) dh_rec[r] = make_float2(0.f, 0.f);
    accumulate<T, R, true>(ws, 0, KS, H, u, da, dh_rec);
    accumulate<T, R, false>(wt, KS, G4, H, u, da, dh_rec);  // rows that did not fit
  }
}

template <typename T, int R>
int launch_r(const Chains& chains, int n_chains, int B, int T_len, int H, int groups,
             cudaStream_t stream) {
  const int TB = groups * R;
  const long long dabytes = 2LL * TB * 4 * H * sizeof(float);
  const long long row_bytes = (long long)H * sizeof(T);
  long long ks = (kMaxShared - dabytes) / row_bytes;
  ks = ks < 4LL * H ? ks / 4 * 4 : 4LL * H;
  if (ks < 0) return (int)cudaErrorInvalidConfiguration;
  const int KS = (int)ks;
  const size_t smem = (size_t)(dabytes + KS * row_bytes);
  auto kernel = lstm_bwd_kernel<T, R>;
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

// The tensor-core path's cell: one row's two units u, u + 1 at a step.
template <typename T>
struct LstmBwdCell {
  static constexpr int kGates = 4;
  static constexpr bool kExactW = sizeof(T) == 2;  // a bfloat16 W is a TF32 value
  using Weight = T;
  using Chains = ::Chains;
  struct In {
    float2 a[4];  // gate pre-activations i, f, g, o
    float2 c, cp, g;  // c_t, c_{t-1}, cotangent of h
  };
  struct Out {
    float2 da[4];
  };

  const float* __restrict__ gates;
  const T* __restrict__ cs;
  const T* __restrict__ g_hs;
  const T* __restrict__ whh;
  float* __restrict__ das;
  T* __restrict__ d_xw;
  int T_len, H;

  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  __device__ LstmBwdCell(const Chains& ch, bool second, int T_len_, int H_)
      : gates(second ? ch.gates[1] : ch.gates[0]),
        cs(static_cast<const T*>(second ? ch.cs[1] : ch.cs[0])),
        g_hs(static_cast<const T*>(second ? ch.g_hs[1] : ch.g_hs[0])),
        whh(static_cast<const T*>(second ? ch.w[1] : ch.w[0])),
        das(second ? ch.das[1] : ch.das[0]),
        d_xw(static_cast<T*>(second ? ch.d_xw[1] : ch.d_xw[0])),
        T_len(T_len_),
        H(H_) {}

  __device__ __forceinline__ void load(In& in, long long b, int t, int u, bool valid) const {
    if (valid) {
      const float* row = gates + (b * T_len + t) * 4LL * H + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.a[q] = ldg_pair(row + q * H);
      const long long at = (b * T_len + t) * H + u;
      in.g = ldg_pair(g_hs + at);
      in.c = ldg_pair(cs + at);
      in.cp = t > 0 ? ldg_pair(cs + at - H) : make_float2(0.f, 0.f);
    } else {
      // Padding rows: a zero cotangent keeps every derivative of the row zero.
#pragma unroll
      for (int q = 0; q < 4; ++q) in.a[q] = make_float2(0.f, 0.f);
      in.g = in.c = in.cp = make_float2(0.f, 0.f);
    }
  }

  // da from the step's inputs, dh_rec and dc_rec (`dc`, updated); no carry.
  __device__ __forceinline__ void derive(const In& in, float2 dh_rec, float2& dc, Out& out,
                                         float2& carry) const {
    float d[4][2], dcn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float gi = tf32_bwd::sigmoid(e ? in.a[0].y : in.a[0].x);
      const float gf = tf32_bwd::sigmoid(e ? in.a[1].y : in.a[1].x);
      const float gg = tanhf(e ? in.a[2].y : in.a[2].x);
      const float go = tf32_bwd::sigmoid(e ? in.a[3].y : in.a[3].x);
      const float tc = tanhf(e ? in.c.y : in.c.x);
      const float cp = e ? in.cp.y : in.cp.x;
      const float dh = (e ? in.g.y : in.g.x) + (e ? dh_rec.y : dh_rec.x);
      const float dcv = (e ? dc.y : dc.x) + dh * go * (1.f - tc * tc);
      d[0][e] = dcv * gg * gi * (1.f - gi);
      d[1][e] = dcv * cp * gf * (1.f - gf);
      d[2][e] = dcv * gi * (1.f - gg * gg);
      d[3][e] = dh * tc * go * (1.f - go);
      dcn[e] = dcv * gf;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) out.da[q] = make_float2(d[q][0], d[q][1]);
    dc = make_float2(dcn[0], dcn[1]);
    carry = make_float2(0.f, 0.f);
  }

  __device__ __forceinline__ static float2 tile_value(const Out& out, int q) { return out.da[q]; }

  __device__ __forceinline__ void store(const Out& out, long long b, int t, int u) const {
    const long long row = (b * T_len + t) * 4LL * H + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      *reinterpret_cast<float2*>(das + row + q * H) = out.da[q];
      if (d_xw != nullptr) store_pair(d_xw + row + q * H, out.da[q].x, out.da[q].y);
    }
  }
};

cluster_bwd::Chains cluster_chains(const Chains& c) {
  return {{c.gates[0], c.gates[1]}, {c.cs[0], c.cs[1]}, {c.g_hs[0], c.g_hs[1]},
          {c.w[0], c.w[1]},         {c.das[0], c.das[1]}, {c.d_xw[0], c.d_xw[1]}};
}

// path 0: the FMA kernel with tile R (W_hh^T); path 2 (float32) / 3 (bfloat16):
// the tensor-core kernel with tile M and clusters of `cluster` blocks (W_hh);
// path 4: the cluster kernel, tile 1, one sequence a cluster of `cluster` blocks (W_hh);
// path 5: the wide kernel, tiles of M = `tile` rows a cluster of `cluster` blocks (W_hh).
int dispatch(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int path,
             int tile, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 5)
    return wide_bwd::launch(cluster_chains(chains), n_chains, dtype, B, T_len, H, tile, cluster,
                            true, st);
  if (path == 4) {
    if (tile != 1) return (int)cudaErrorInvalidValue;
    return cluster_bwd::launch(cluster_chains(chains), n_chains, dtype, B, T_len, H, cluster,
                               true, st);
  }
  if (path == 2 && dtype == 0)
    return tf32_bwd::launch<LstmBwdCell<float>>(chains, n_chains, B, T_len, H, tile, cluster, st);
  if (path == 3 && dtype == 1)
    return tf32_bwd::launch<LstmBwdCell<__nv_bfloat16>>(chains, n_chains, B, T_len, H, tile,
                                                        cluster, st);
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fma<float>(chains, n_chains, B, T_len, H, tile, st);
  if (dtype == 1) return launch_fma<__nv_bfloat16>(chains, n_chains, B, T_len, H, tile, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (cs, g_hs, w and d_xw share it; gates and
// das are f32; d_xw is null in float32). All arrays are contiguous: gates,
// das and d_xw (B, T, 4H), cs and g_hs (B, T, H), w W_hh^T (4H, H) on path 0
// and W_hh (H, 4H) on paths 2, 3 and 4. path 0 (FMA, tile = R in {1, 2, 4}),
// 2 (tensor cores, float32, three TF32 products) or 3 (tensor cores,
// bfloat16, two), both with H % 16 == 0, H <= 128, tile = M = 16 and
// cluster = C in {2, 4} with H % 8C == 0, 4 (cluster kernel, either dtype,
// H in {256, 384, 512}, tile = 1, cluster = C in {8, 16}: 8 or 16 at H = 256,
// 16 above) or 5 (wide kernel, either dtype, H = 256, tile = M in {16, 32, 64} and
// cluster = C in {8, 16} (float32) or {4, 8} (bfloat16) where the shared memory
// fits), from ops/lstm_scan.py:_plan_bwd.
// Returns a cudaError_t (0 on success). The Python wrapper validates every
// argument.
extern "C" int lstm_scan_bwd_launch(const float* gates, const void* cs, const void* g_hs,
                                    const void* w, float* das, void* d_xw, int dtype, int B,
                                    int T, int H, int path, int tile, int cluster,
                                    void* stream) {
  Chains chains = {{gates, nullptr}, {cs, nullptr}, {g_hs, nullptr}, {w, nullptr},
                   {das, nullptr}, {d_xw, nullptr}};
  return dispatch(chains, 1, dtype, B, T, H, path, tile, cluster, stream);
}

// Both chains of a bidirectional layer, each with its own arrays, in one launch.
extern "C" int lstm_scan_bidir_bwd_launch(const float* gates_f, const float* gates_b,
                                          const void* cs_f, const void* cs_b,
                                          const void* g_f, const void* g_b,
                                          const void* w_f, const void* w_b,
                                          float* das_f, float* das_b, void* d_xw_f,
                                          void* d_xw_b, int dtype, int B, int T, int H,
                                          int path, int tile, int cluster, void* stream) {
  Chains chains = {{gates_f, gates_b}, {cs_f, cs_b}, {g_f, g_b}, {w_f, w_b},
                   {das_f, das_b}, {d_xw_f, d_xw_b}};
  return dispatch(chains, 2, dtype, B, T, H, path, tile, cluster, stream);
}

// The clusters of C blocks of the tensor-core backward at hidden size H that
// the current card holds at once, each block on an SM of its own, into
// *clusters (what _plan_bwd fits a wave to; the same in both dtypes).
extern "C" int lstm_scan_bwd_tf32_clusters(int H, int C, int* clusters) {
  return tf32_bwd::max_clusters<LstmBwdCell<float>>(H, C, clusters);
}

// The clusters of C blocks of the cluster backward at hidden size H that the
// current card holds at once, each block on an SM of its own, into *clusters
// (0 where no GPC has C free SMs; what _plan_bwd fits a wave to).
extern "C" int lstm_scan_bwd_cluster_clusters(int H, int C, int* clusters) {
  return cluster_bwd::max_clusters(H, C, clusters);
}

// The cluster backward with its product compiled out (the serial floor: the
// reduction, the cell derivative and the exchange of da of every step), over one or
// two chains (the second chain's arrays null for one), C blocks a sequence. It
// writes das (and d_xw), not a recurrence's; chip_smoke.py times it beside the kernel.
extern "C" int lstm_scan_bwd_cluster_floor_launch(const float* gates_f, const float* gates_b,
                                                  const void* cs_f, const void* cs_b,
                                                  const void* g_f, const void* g_b,
                                                  const void* w_f, const void* w_b,
                                                  float* das_f, float* das_b, void* d_xw_f,
                                                  void* d_xw_b, int dtype, int B, int T, int H,
                                                  int cluster, void* stream) {
  const Chains chains = {{gates_f, gates_b}, {cs_f, cs_b}, {g_f, g_b}, {w_f, w_b},
                         {das_f, das_b}, {d_xw_f, d_xw_b}};
  return cluster_bwd::launch(cluster_chains(chains), gates_b == nullptr ? 1 : 2, dtype, B, T, H,
                             cluster, false, static_cast<cudaStream_t>(stream));
}

// The clusters of C blocks of the wide backward at hidden size H, tile M and dtype (0
// float32, 1 bfloat16) that the current card holds at once, each block on an SM of its
// own, into *clusters (0 where no GPC has C free SMs; what _plan_bwd fits a wave to).
extern "C" int lstm_scan_bwd_wide_clusters(int H, int M, int C, int dtype, int* clusters) {
  return wide_bwd::max_clusters(H, M, C, dtype, clusters);
}

// The wide backward with its product compiled out (the serial floor: the cell derivative,
// the exchange of the partial sums and their sums of every step), over one or two chains
// (the second chain's arrays null for one), tiles of M rows a cluster of C blocks. It
// writes das (and d_xw), not a recurrence's; chip_smoke.py times it beside the kernel.
extern "C" int lstm_scan_bwd_wide_floor_launch(const float* gates_f, const float* gates_b,
                                               const void* cs_f, const void* cs_b,
                                               const void* g_f, const void* g_b,
                                               const void* w_f, const void* w_b,
                                               float* das_f, float* das_b, void* d_xw_f,
                                               void* d_xw_b, int dtype, int B, int T, int H,
                                               int tile, int cluster, void* stream) {
  const Chains chains = {{gates_f, gates_b}, {cs_f, cs_b}, {g_f, g_b}, {w_f, w_b},
                         {das_f, das_b}, {d_xw_f, d_xw_b}};
  return wide_bwd::launch(cluster_chains(chains), gates_b == nullptr ? 1 : 2, dtype, B, T, H,
                          tile, cluster, false, static_cast<cudaStream_t>(stream));
}

// Reverse recurrence of the fused GRU scans, for training (Hopper, sm_90a).
//
// Replaces the backward of the TPU kernel of
// dnn_based_source_separation_tpu/ops/pallas_lstm.py: the `jax.custom_vjp`
// backward `_gru_bidir_bwd` of gru_scan_bidir, which runs `_gru_bwd_core`'s
// reverse `lax.scan` (:446-459) once per chain. One launch takes one chain
// (the port's one-chain gru_scan, which the JAX package differentiates
// through lax.scan) or both chains of a bidirectional layer.
//
// Per chain and sequence, walking t from T-1 down to 0 with dh_rec = 0 and
// torch gate order r, z, n:
//
//     r = sigmoid(x_r + hw_r);  z = sigmoid(x_z + hw_z);  n = tanh(x_n + r * hw_n)
//     dh   = f32(g_hs[t]) + dh_rec
//     da_z = dh * (h_prev - n) * z * (1 - z)
//     dn   = dh * (1 - z) * (1 - n^2)
//     da_r = dn * hw_n * r * (1 - r)
//     d_xw[b, t, :] = [da_r, da_z, dn]        (rounded to xw's dtype)
//     d_hw[b, t, :] = [da_r, da_z, dn * r]    (f32)
//     dh_rec = dh * z + d_hw[b, t, :] @ W_hh^T  (f32)
//
// with x = f32(xw[b, t, :]) and h_prev = f32(hs[b, t-1, :]) (0 at t = 0), hs
// as the forward kernel wrote it, in the input dtype: in bfloat16 the
// backward sees the rounded h the Pallas backward sees. The pre-activations
// `hw = f32(h_prev) @ f32(W_hh) + f32(b_hh)` come in as one (B, T, 3H) f32
// array (one large matmul outside, as the JAX package computes them outside
// Pallas), and so do the products around the recurrence: d_W_hh =
// h_prev^T @ d_hw and d_b_hh = sum over (b, t) of d_hw. W_hh is read in its
// own dtype: bfloat16 widens to f32 exactly.
//
// Two paths, chosen by the caller (ops/lstm_scan.py:_plan_bwd, which the GRU
// wrapper shares) from the dtype and the shape before the launch, never
// after a failure:
//   * "tf32x3" (float32) and "tf32x2" (bfloat16) for H a multiple of 16 up to
//     128: the tensor-core kernel of csrc/recurrence_bwd_tf32.cuh with the
//     cell GruBwdCell below, the product in three (f32 W) or two (bf16 W)
//     TF32 products on a cluster of 2 or 4 blocks; it reads W_hh (H, 3H);
//   * "fma": every other H (40, 256, 512, ...), the FMA kernel of this file;
//     it reads W_hh^T (3H, H).
//
// What bounds the FMA kernel. Each step of a chain depends on the one after it, so time
// is a loop inside the block and only independent sequences run in
// parallel. Per step and sequence the recurrent product is 3H x H FMAs
// (49,152 at H = 128) against 6H values read (xw, hw) and 6H written (d_xw,
// d_hw), a serial chain of T steps: FMA issue and shared-memory bandwidth
// inside each SM, and the step latency of the chain, not device memory.
//
// The FMA kernel's design (that of csrc/lstm_scan_bwd.cu with 3H for 4H):
//   * one block owns a tile of TB = groups * R sequences of one chain
//     (blockIdx.y is the chain). Thread (g, p) owns hidden units 2p and
//     2p + 1 of the R sequences of group g and computes the three gate
//     derivatives of both itself, so dh_rec stays in its registers: the only
//     values exchanged are the step's d_hw;
//   * d_hw is published in shared memory as f32, double-buffered by step
//     parity, so one __syncthreads() per step suffices: a thread that runs
//     ahead writes the other buffer, and the buffer it will write next is
//     read by nobody until every thread has passed the next barrier;
//   * W_hh^T is staged once into shared memory as (3H, H) row-major. A thread
//     reads its two adjacent columns of a row as one 4-byte (bf16) or 8-byte
//     (f32) load, so a warp reads 128 or 256 contiguous bytes with no bank
//     conflict. In bf16, H = 128 gives 96 KB, which fits; in f32 the 192 KB
//     fit beside the d_hw buffers only for small tiles, so the first KS rows
//     that fit go to shared memory and the rest are read from global memory
//     (L2-resident: every block of the chain reads the same matrix);
//   * the next step's xw, hw, hs and g_hs are loaded into registers before
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

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling

struct Chains {
  const void* xw[2];    // (B, T, 3H) input projections, input dtype
  const float* hw[2];   // (B, T, 3H) f32 recurrent pre-activations (b_hh included)
  const void* hs[2];    // (B, T, H) forward hidden states, input dtype
  const void* g_hs[2];  // (B, T, H) cotangent of hs, input dtype
  const void* w[2];     // W_hh^T (3H, H) on the FMA path, W_hh (H, 3H) on the others
  void* d_xw[2];        // (B, T, 3H) gradient of xw, input dtype
  float* d_hw[2];       // (B, T, 3H) f32 gradient of hw
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
__device__ __forceinline__ float lo_hi(float2 v, int e) { return e ? v.y : v.x; }

// acc[r] += da[r, k0:k1] @ WT[k0:k1, u : u + 2] for the R sequences of the
// group. `wt` points at row 0 of the (3H, H) matrix, in shared (kShared) or
// global memory; da rows are 3H floats apart.
template <typename T, int R, bool kShared>
__device__ __forceinline__ void accumulate(const T* __restrict__ wt, int k0, int k1, int H, int u,
                                           const float* __restrict__ da, float2 (&acc)[R]) {
  const int G3 = 3 * H;
  for (int k = k0; k < k1; k += 4) {
    float dv[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(da + r * G3 + k);
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
// The r and z pre-activations are summed as they load (x + hw, the same f32
// add the step would make), so a sequence costs 12 registers, not 16.
template <int R>
struct StepInputs {
  float2 ar[R];  // x_r + hw_r
  float2 az[R];  // x_z + hw_z
  float2 xn[R];  // x_n
  float2 hn[R];  // hw_n
  float2 g[R];   // cotangent of h
  float2 hp[R];  // h_{t-1}
};

template <typename T, int R>
__device__ __forceinline__ void load_step(StepInputs<R>& in, const T* __restrict__ xw,
                                          const float* __restrict__ hw,
                                          const T* __restrict__ hs, const T* __restrict__ g_hs,
                                          long long b0, int B, int T_len, int H, int u, int t) {
  const long long G3 = 3LL * H;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long b = b0 + r;
    if (b < B) {
      const T* xrow = xw + (b * T_len + t) * G3 + u;
      const float* hrow = hw + (b * T_len + t) * G3 + u;
      const float2 xr = ldg_pair(xrow), hr = ldg_pair(hrow);
      const float2 xz = ldg_pair(xrow + H), hz = ldg_pair(hrow + H);
      in.ar[r] = make_float2(xr.x + hr.x, xr.y + hr.y);
      in.az[r] = make_float2(xz.x + hz.x, xz.y + hz.y);
      in.xn[r] = ldg_pair(xrow + 2 * H);
      in.hn[r] = ldg_pair(hrow + 2 * H);
      const long long at = (b * T_len + t) * H + u;
      in.g[r] = ldg_pair(g_hs + at);
      in.hp[r] = t > 0 ? ldg_pair(hs + at - H) : make_float2(0.f, 0.f);
    } else {
      // Padding rows: a zero cotangent keeps every derivative of the row zero.
      in.ar[r] = in.az[r] = in.xn[r] = in.hn[r] = make_float2(0.f, 0.f);
      in.g[r] = in.hp[r] = make_float2(0.f, 0.f);
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_bwd_kernel(Chains chains, int B, int T_len, int H, int groups, int KS) {
  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const T* __restrict__ xw = static_cast<const T*>(second ? chains.xw[1] : chains.xw[0]);
  const float* __restrict__ hw = second ? chains.hw[1] : chains.hw[0];
  const T* __restrict__ hs = static_cast<const T*>(second ? chains.hs[1] : chains.hs[0]);
  const T* __restrict__ g_hs = static_cast<const T*>(second ? chains.g_hs[1] : chains.g_hs[0]);
  const T* __restrict__ wt = static_cast<const T*>(second ? chains.w[1] : chains.w[0]);
  T* __restrict__ d_xw = static_cast<T*>(second ? chains.d_xw[1] : chains.d_xw[0]);
  float* __restrict__ d_hw = second ? chains.d_hw[1] : chains.d_hw[0];
  const int TB = groups * R;
  const int G3 = 3 * H;

  extern __shared__ float4 smem4[];
  float* dabuf = reinterpret_cast<float*>(smem4);     // [2][TB][3H], f32
  T* ws = reinterpret_cast<T*>(dabuf + 2 * TB * G3);  // [KS][H], rows 0..KS-1 of W_hh^T

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

  float2 dh_rec[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh_rec[r] = make_float2(0.f, 0.f);

  StepInputs<R> in;
  load_step<T, R>(in, xw, hw, hs, g_hs, b0, B, T_len, H, u, T_len - 1);
  for (int t = T_len - 1; t >= 0; --t) {
    float* da = dabuf + (t & 1) * TB * G3 + g * R * G3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d[3][2], dn[2], carry[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hn = lo_hi(in.hn[r], e);
        const float rg = sigmoid(lo_hi(in.ar[r], e));
        const float zg = sigmoid(lo_hi(in.az[r], e));
        const float ng = tanhf(lo_hi(in.xn[r], e) + rg * hn);
        const float dh = lo_hi(in.g[r], e) + lo_hi(dh_rec[r], e);
        dn[e] = dh * (1.f - zg) * (1.f - ng * ng);
        d[0][e] = dn[e] * hn * rg * (1.f - rg);
        d[1][e] = dh * (lo_hi(in.hp[r], e) - ng) * zg * (1.f - zg);
        d[2][e] = dn[e] * rg;
        carry[e] = dh * zg;
      }
      const long long b = b0 + r;
      const long long row = (b * T_len + t) * G3 + u;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 v = make_float2(d[q][0], d[q][1]);
        *reinterpret_cast<float2*>(da + r * G3 + q * H + u) = v;
        if (b < B) *reinterpret_cast<float2*>(d_hw + row + q * H) = v;
      }
      if (b < B) {
        store_pair(d_xw + row, d[0][0], d[0][1]);
        store_pair(d_xw + row + H, d[1][0], d[1][1]);
        store_pair(d_xw + row + 2 * H, dn[0], dn[1]);
      }
      dh_rec[r] = make_float2(carry[0], carry[1]);
    }
    __syncthreads();
    if (t > 0) load_step<T, R>(in, xw, hw, hs, g_hs, b0, B, T_len, H, u, t - 1);
    accumulate<T, R, true>(ws, 0, KS, H, u, da, dh_rec);
    accumulate<T, R, false>(wt, KS, G3, H, u, da, dh_rec);  // rows that did not fit
  }
}

template <typename T, int R>
int launch_r(const Chains& chains, int n_chains, int B, int T_len, int H, int groups,
             cudaStream_t stream) {
  const int TB = groups * R;
  const long long dabytes = 2LL * TB * 3 * H * sizeof(float);
  const long long row_bytes = (long long)H * sizeof(T);
  long long ks = (kMaxShared - dabytes) / row_bytes;
  ks = ks < 3LL * H ? ks / 4 * 4 : 3LL * H;
  if (ks < 0) return (int)cudaErrorInvalidConfiguration;
  const int KS = (int)ks;
  const size_t smem = (size_t)(dabytes + KS * row_bytes);
  auto kernel = gru_bwd_kernel<T, R>;
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
struct GruBwdCell {
  static constexpr int kGates = 3;
  static constexpr bool kExactW = sizeof(T) == 2;  // a bfloat16 W is a TF32 value
  using Weight = T;
  using Chains = ::Chains;
  struct In {
    float2 ar, az;  // x_r + hw_r, x_z + hw_z
    float2 xn, hn;  // x_n, hw_n
    float2 g, hp;   // cotangent of h, h_{t-1}
  };
  struct Out {
    float2 d[3];  // d_hw: da_r, da_z, dn * r (the product's A operand)
    float2 dn;    // d_xw's n column
  };

  const T* __restrict__ xw;
  const float* __restrict__ hw;
  const T* __restrict__ hs;
  const T* __restrict__ g_hs;
  const T* __restrict__ whh;
  T* __restrict__ d_xw;
  float* __restrict__ d_hw;
  int T_len, H;

  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  __device__ GruBwdCell(const Chains& ch, bool second, int T_len_, int H_)
      : xw(static_cast<const T*>(second ? ch.xw[1] : ch.xw[0])),
        hw(second ? ch.hw[1] : ch.hw[0]),
        hs(static_cast<const T*>(second ? ch.hs[1] : ch.hs[0])),
        g_hs(static_cast<const T*>(second ? ch.g_hs[1] : ch.g_hs[0])),
        whh(static_cast<const T*>(second ? ch.w[1] : ch.w[0])),
        d_xw(static_cast<T*>(second ? ch.d_xw[1] : ch.d_xw[0])),
        d_hw(second ? ch.d_hw[1] : ch.d_hw[0]),
        T_len(T_len_),
        H(H_) {}

  __device__ __forceinline__ void load(In& in, long long b, int t, int u, bool valid) const {
    if (valid) {
      const long long row = (b * T_len + t) * 3LL * H + u;
      const float2 xr = ldg_pair(xw + row), hr = ldg_pair(hw + row);
      const float2 xz = ldg_pair(xw + row + H), hz = ldg_pair(hw + row + H);
      in.ar = make_float2(xr.x + hr.x, xr.y + hr.y);
      in.az = make_float2(xz.x + hz.x, xz.y + hz.y);
      in.xn = ldg_pair(xw + row + 2 * H);
      in.hn = ldg_pair(hw + row + 2 * H);
      const long long at = (b * T_len + t) * H + u;
      in.g = ldg_pair(g_hs + at);
      in.hp = t > 0 ? ldg_pair(hs + at - H) : make_float2(0.f, 0.f);
    } else {
      // Padding rows: a zero cotangent keeps every derivative of the row zero.
      in.ar = in.az = in.xn = in.hn = in.g = in.hp = make_float2(0.f, 0.f);
    }
  }

  // The step's derivatives from its inputs and dh_rec; carry = dh * z, the
  // part of the next dh_rec outside the product. No state.
  __device__ __forceinline__ void derive(const In& in, float2 dh_rec, float2&, Out& out,
                                         float2& carry) const {
    float d[3][2], dn[2], cy[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float hn = lo_hi(in.hn, e);
      const float rg = tf32_bwd::sigmoid(lo_hi(in.ar, e));
      const float zg = tf32_bwd::sigmoid(lo_hi(in.az, e));
      const float ng = tanhf(lo_hi(in.xn, e) + rg * hn);
      const float dh = lo_hi(in.g, e) + lo_hi(dh_rec, e);
      dn[e] = dh * (1.f - zg) * (1.f - ng * ng);
      d[0][e] = dn[e] * hn * rg * (1.f - rg);
      d[1][e] = dh * (lo_hi(in.hp, e) - ng) * zg * (1.f - zg);
      d[2][e] = dn[e] * rg;
      cy[e] = dh * zg;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) out.d[q] = make_float2(d[q][0], d[q][1]);
    out.dn = make_float2(dn[0], dn[1]);
    carry = make_float2(cy[0], cy[1]);
  }

  __device__ __forceinline__ static float2 tile_value(const Out& out, int q) { return out.d[q]; }

  __device__ __forceinline__ void store(const Out& out, long long b, int t, int u) const {
    const long long row = (b * T_len + t) * 3LL * H + u;
#pragma unroll
    for (int q = 0; q < 3; ++q) *reinterpret_cast<float2*>(d_hw + row + q * H) = out.d[q];
    store_pair(d_xw + row, out.d[0].x, out.d[0].y);
    store_pair(d_xw + row + H, out.d[1].x, out.d[1].y);
    store_pair(d_xw + row + 2 * H, out.dn.x, out.dn.y);
  }
};

// path 0: the FMA kernel with tile R (W_hh^T); path 2 (float32) / 3 (bfloat16):
// the tensor-core kernel with tile M and clusters of `cluster` blocks (W_hh).
int dispatch(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int path,
             int tile, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 2 && dtype == 0)
    return tf32_bwd::launch<GruBwdCell<float>>(chains, n_chains, B, T_len, H, tile, cluster, st);
  if (path == 3 && dtype == 1)
    return tf32_bwd::launch<GruBwdCell<__nv_bfloat16>>(chains, n_chains, B, T_len, H, tile,
                                                       cluster, st);
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fma<float>(chains, n_chains, B, T_len, H, tile, st);
  if (dtype == 1) return launch_fma<__nv_bfloat16>(chains, n_chains, B, T_len, H, tile, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xw, hs, g_hs, w and d_xw share it; hw
// and d_hw are f32). All arrays are contiguous: xw, hw, d_xw and d_hw
// (B, T, 3H), hs and g_hs (B, T, H), w W_hh^T (3H, H) on path 0 and W_hh
// (H, 3H) on paths 2 and 3. path 0 (FMA, tile = R in {1, 2, 4}), 2 (tensor
// cores, float32, three TF32 products) or 3 (tensor cores, bfloat16, two),
// both with H % 16 == 0, H <= 128, tile = M = 16 and cluster = C in
// {2, 4} with H % 8C == 0, from ops/lstm_scan.py:_plan_bwd. Returns a
// cudaError_t (0 on success). The Python wrapper validates every argument.
extern "C" int gru_scan_bwd_launch(const void* xw, const float* hw, const void* hs,
                                   const void* g_hs, const void* w, void* d_xw, float* d_hw,
                                   int dtype, int B, int T, int H, int path, int tile,
                                   int cluster, void* stream) {
  Chains chains = {{xw, nullptr}, {hw, nullptr}, {hs, nullptr}, {g_hs, nullptr},
                   {w, nullptr}, {d_xw, nullptr}, {d_hw, nullptr}};
  return dispatch(chains, 1, dtype, B, T, H, path, tile, cluster, stream);
}

// Both chains of a bidirectional layer, each with its own arrays, in one launch.
extern "C" int gru_scan_bidir_bwd_launch(const void* xw_f, const void* xw_b, const float* hw_f,
                                         const float* hw_b, const void* hs_f, const void* hs_b,
                                         const void* g_f, const void* g_b, const void* w_f,
                                         const void* w_b, void* d_xw_f, void* d_xw_b,
                                         float* d_hw_f, float* d_hw_b, int dtype, int B, int T,
                                         int H, int path, int tile, int cluster, void* stream) {
  Chains chains = {{xw_f, xw_b}, {hw_f, hw_b}, {hs_f, hs_b}, {g_f, g_b},
                   {w_f, w_b}, {d_xw_f, d_xw_b}, {d_hw_f, d_hw_b}};
  return dispatch(chains, 2, dtype, B, T, H, path, tile, cluster, stream);
}

// The clusters of C blocks of the tensor-core backward at hidden size H that
// the current card holds at once, each block on an SM of its own, into
// *clusters (what _plan_bwd fits a wave to; the same in both dtypes).
extern "C" int gru_scan_bwd_tf32_clusters(int H, int C, int* clusters) {
  return tf32_bwd::max_clusters<GruBwdCell<float>>(H, C, clusters);
}

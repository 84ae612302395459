// Fused LSTM recurrences for the dual-path separators (Hopper, sm_90a).
//
// Replaces the TPU kernels of dnn_based_source_separation_tpu/ops/pallas_lstm.py:
//   lstm_scan        (_lstm_kernel):  one chain;
//   lstm_scan_bidir  (_bidir_kernel): two chains, the second over a sequence
//                    the caller has already reversed in time.
// Forward only; the cell state is not written (it is a VJP residual there).
//
// Per chain and sequence, with h = c = 0 at the start and gate order i, f, g, o:
//
//     gates = f32(xw[b, t, :]) + f32(h rounded to the weight dtype) @ f32(W_hh)
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g);   h = sigmoid(o) * tanh(c)
//     hs[b, t, :] = h rounded to the dtype
//
// xw (B, T, 4H) and W_hh (H, 4H) share one dtype, float32 or bfloat16; the
// products are exact in f32 and summed in f32, and h and c are carried in
// f32, as the Pallas kernels carry them in f32 VMEM scratch.
//
// What bounds it. Every step of a chain depends on the step before, so time
// is a loop inside the block, and only independent sequences run in
// parallel. Per step and sequence the recurrent product is H x 4H FMAs
// (65,536 at H = 128) against 4H values of xw read and H written: the
// kernel is bound by FMA issue and shared-memory bandwidth inside each SM,
// not by device memory.
//
// Design (simple and right first; tensor cores, clusters and TMA are later work):
//   * one block owns a tile of TB = groups * R sequences of one chain
//     (blockIdx.y is the chain). Thread (g, p) of the block owns hidden units
//     2p and 2p + 1 of the R sequences of group g, so it computes all four
//     gates of its units itself: the cell update needs no exchange, and the
//     only barrier per step is the one that publishes h;
//   * W_hh is staged once into shared memory in its (H, 4H) row-major layout.
//     A thread reads its two adjacent columns of a row as one 4-byte (bf16)
//     or 8-byte (f32) load, so a warp reads 128 or 256 contiguous bytes with
//     no bank conflict. In bf16, H = 128 gives 128 KB, which fits. In f32 the
//     256 KB do not fit a block's 227 KB: the first KS rows that fit go to
//     shared memory and the remaining rows are read from global memory
//     (L2-resident: every block of the chain reads the same 256 KB);
//   * h is published in shared memory as f32 (already rounded to the weight
//     dtype), double-buffered by step parity, so one __syncthreads() per step
//     suffices. Each group reads its own R rows of h as 16-byte broadcasts;
//   * the step's xw values are loaded into registers before the recurrent
//     product, so their latency hides behind it;
//   * the tile size R per group is picked by the launcher: the largest of
//     4, 2, 1 that still gives at least one block per SM, because a
//     single request (about 255 sequences per chain at B = 1) cannot fill 132
//     SMs with large tiles, and per-step latency grows with R.
//
// Bound with ctypes (ops/_build.py); the C entry points return
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling

struct Chains {
  const void* xw[2];
  const void* whh[2];
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

// acc[r][q] += h[r, k0:k1] @ W[k0:k1, q*H + u : q*H + u + 2] for the R
// sequences of the group. `w` points at row 0 of the (H, 4H) matrix, in
// shared (kShared) or global memory; h rows are H floats apart.
template <typename T, int R, bool kShared>
__device__ __forceinline__ void accumulate(const T* __restrict__ w, int k0, int k1, int H, int u,
                                           const float* __restrict__ h, float2 (&acc)[R][4]) {
  const long long ld = 4LL * H;
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
      float2 wq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wq[q] = kShared ? load_pair(row + q * H) : ldg_pair(row + q * H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q].x = fmaf(hv[r][kk], wq[q].x, acc[r][q].x);
          acc[r][q].y = fmaf(hv[r][kk], wq[q].y, acc[r][q].y);
        }
      }
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_kernel(Chains chains, int B, int T_len, int H, int groups, int KS) {
  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const T* __restrict__ xw = static_cast<const T*>(second ? chains.xw[1] : chains.xw[0]);
  const T* __restrict__ whh = static_cast<const T*>(second ? chains.whh[1] : chains.whh[0]);
  T* __restrict__ hs = static_cast<T*>(second ? chains.hs[1] : chains.hs[0]);
  const int TB = groups * R;
  const long long G4 = 4LL * H;

  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);     // [2][TB][H], f32
  T* ws = reinterpret_cast<T*>(hbuf + 2 * TB * H);   // [KS][4H], rows 0..KS-1 of W_hh

  // Stage W_hh rows [0, KS) with 16-byte copies; zero h for step 0.
  {
    const int n16 = (int)(KS * G4 * (long long)sizeof(T) / 16);
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

  float c[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r][0] = c[r][1] = 0.f;

  for (int t = 0; t < T_len; ++t) {
    const float* hprev = hbuf + (t & 1) * TB * H + g * R * H;
    float* hnext = hbuf + ((t + 1) & 1) * TB * H + g * R * H;

    float2 xv[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long b = b0 + r;
      if (b < B) {
        const T* row = xw + (b * T_len + t) * G4 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[r][q] = ldg_pair(row + q * H);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[r][q] = make_float2(0.f, 0.f);
      }
    }

    float2 acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = make_float2(0.f, 0.f);
    accumulate<T, R, true>(ws, 0, KS, H, u, hprev, acc);
    accumulate<T, R, false>(whh, KS, H, H, u, hprev, acc);  // rows that did not fit

#pragma unroll
    for (int r = 0; r < R; ++r) {
      float hv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gi = sigmoid((e ? xv[r][0].y : xv[r][0].x) + (e ? acc[r][0].y : acc[r][0].x));
        const float gf = sigmoid((e ? xv[r][1].y : xv[r][1].x) + (e ? acc[r][1].y : acc[r][1].x));
        const float gg = tanhf((e ? xv[r][2].y : xv[r][2].x) + (e ? acc[r][2].y : acc[r][2].x));
        const float go = sigmoid((e ? xv[r][3].y : xv[r][3].x) + (e ? acc[r][3].y : acc[r][3].x));
        c[r][e] = gf * c[r][e] + gi * gg;
        hv[e] = go * tanhf(c[r][e]);
      }
      const long long b = b0 + r;
      if (b < B) store_pair(hs + (b * T_len + t) * H + u, hv[0], hv[1]);
      // The next product reads h rounded to the weight dtype, as Pallas does.
      *reinterpret_cast<float2*>(hnext + r * H + u) =
          make_float2(round_to(hv[0], whh), round_to(hv[1], whh));
    }
    __syncthreads();
  }
}

int sm_count() {
  static int cached_device = -1, sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  if (device != cached_device) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    cached_device = device;
  }
  return sms;
}

template <typename T, int R>
int launch_r(const Chains& chains, int n_chains, int B, int T_len, int H, int groups,
             cudaStream_t stream) {
  const int TB = groups * R;
  const long long hbytes = 2LL * TB * H * sizeof(float);
  const long long row_bytes = 4LL * H * sizeof(T);
  long long ks = (kMaxShared - hbytes) / row_bytes;
  ks = ks < H ? ks / 4 * 4 : H;
  if (ks < 0) return (int)cudaErrorInvalidConfiguration;
  const int KS = (int)ks;
  const size_t smem = (size_t)(hbytes + KS * row_bytes);
  auto kernel = lstm_kernel<T, R>;
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

template <typename T, int NC>
int launch(const Chains& chains, int B, int T_len, int H, cudaStream_t stream) {
  if (H < 4 || H % 4 || H / 2 > kMaxThreads || B < 1 || T_len < 1)
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return sms < 0 ? -sms : (int)cudaErrorInvalidDevice;
  int groups = kMaxThreads / (H / 2);
  if (groups > 4) groups = 4;
  // The largest tile that still gives every SM a block; else the smallest.
  auto blocks = [&](int r) { return (long long)NC * ((B + groups * r - 1) / (groups * r)); };
  if (blocks(4) >= sms) return launch_r<T, 4>(chains, NC, B, T_len, H, groups, stream);
  if (blocks(2) >= sms) return launch_r<T, 2>(chains, NC, B, T_len, H, groups, stream);
  return launch_r<T, 1>(chains, NC, B, T_len, H, groups, stream);
}

template <int NC>
int dispatch(const Chains& chains, int dtype, int B, int T_len, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, NC>(chains, B, T_len, H, st);
  if (dtype == 1) return launch<__nv_bfloat16, NC>(chains, B, T_len, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xw, W_hh and hs share it). All arrays are
// contiguous: xw (B, T, 4H), W_hh (H, 4H), hs (B, T, H). Returns a
// cudaError_t (0 on success). The Python wrapper validates every argument.
extern "C" int lstm_scan_launch(const void* xw, const void* whh, void* hs, int dtype, int B,
                                int T, int H, void* stream) {
  Chains chains = {{xw, nullptr}, {whh, nullptr}, {hs, nullptr}};
  return dispatch<1>(chains, dtype, B, T, H, stream);
}

// Two chains of one shape: the forward one and the one over the reversed
// sequence, each with its own W_hh; hs_b comes back in reversed time order.
extern "C" int lstm_scan_bidir_launch(const void* xw_f, const void* xw_b, const void* whh_f,
                                      const void* whh_b, void* hs_f, void* hs_b, int dtype,
                                      int B, int T, int H, void* stream) {
  Chains chains = {{xw_f, xw_b}, {whh_f, whh_b}, {hs_f, hs_b}};
  return dispatch<2>(chains, dtype, B, T, H, stream);
}

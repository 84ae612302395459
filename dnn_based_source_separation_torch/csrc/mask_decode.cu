// Fused mask x latent -> synthesis matmul for the TasNet decoder (Hopper, sm_90a).
//
// Replaces the TPU kernel dnn_based_source_separation_tpu/ops/pallas_kernels.py:
// fused_mask_decode (_mask_decode_kernel):
//
//     frames[b, s, t, :] = (w[b, t, :] * mask[b, s, t, :]) @ K        K: (N, CL)
//
// The product w * mask is rounded in the input dtype, then accumulated in f32,
// as the Pallas kernel does. Output is f32 (B, S, T', CL). Overlap-add stays
// outside (ops/filterbank.py), as in the JAX package.
//
// What bounds it. At the paper serving shape (B=8, S=2, T'=3999, N=512, CL=16,
// bf16) the kernel reads mask (65.5 MB) and w (32.8 MB, once), writes 4.1 MB
// of f32 frames and does about 1.05 GFLOP: about 11 FLOP per byte, far below
// the ~295 FLOP/byte an H100 needs before compute is the limit. So device
// memory bounds it, with a floor of about 30 us at 3.35 TB/s, and this kernel
// uses no wgmma or TMA. It reads every input byte once from device memory,
// with coalesced 16-byte loads, and never writes w * mask anywhere. Inside the
// SM the next limits are shared-memory bandwidth for K (every product meets
// CL values of K) and FMA issue; the design keeps both below the memory time:
//
//   * K sits in shared memory as f32, staged once per block, in a swizzled
//     layout: slot ((step * VEC + v) * 32 + lane) holds the row
//     n = step * 32 * VEC + lane * VEC + v that lane `lane` needs for its v-th
//     element in step `step`; each slot is padded by 4 floats, so a warp's
//     128-bit shared loads hit distinct banks;
//   * a unit of work is one output row (b, s, t). Units are ordered t-major,
//     s-minor, so the sources of one t are neighbours and the second read of
//     its w row hits L1. A warp takes R = 32 / CL-bucket units (at least 1)
//     at a time and applies each K value it loads from shared memory to all R
//     of them (register blocking), which divides shared-memory traffic by R;
//   * per step each lane issues 2R independent 16-byte loads (w and mask of R
//     units), keeping enough bytes in flight to cover memory latency;
//   * the grid is persistent: as many blocks as fit on the card at once, each
//     warp striding over unit groups, so there is no tail wave;
//   * the 32 lanes' partial sums are reduced with a halving shuffle tree:
//     at each of 5 steps a lane keeps half of its columns and receives its
//     partner's sums for them, so CL-wide rows reduce in about CL shuffles;
//   * the ragged edges (last unit group, N past the last vector) are masked,
//     not padded.
//
// Bound with ctypes (ops/_build.py); the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
// Units (output rows) a warp carries per pass: R = kUnits / CL-bucket. At the
// serving shape on an H100, 32 (R = 2 at CL = 16) ran faster than 64 (R = 4):
// a larger R cuts shared-memory traffic but needs more registers than two
// resident blocks per SM allow.
constexpr int kUnits = 32;

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float get(const uint4& r, int v) {
    return __uint_as_float(v == 0 ? r.x : v == 1 ? r.y : v == 2 ? r.z : r.w);
  }
  __device__ static float round_product(float a, float b) { return a * b; }
  __device__ static float to_float(float x) { return x; }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits.
  __device__ static float get(const uint4& r, int v) {
    const unsigned word = v < 2 ? r.x : v < 4 ? r.y : v < 6 ? r.z : r.w;
    return __uint_as_float((v & 1) ? (word & 0xffff0000u) : (word << 16));
  }
  // The product of two bf16 values is exact in f32; rounding it to bf16 gives
  // the input-dtype product that the plain version and the TPU kernel form.
  __device__ static float round_product(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(a * b));
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
};

// One level of the halving reduction tree, unrolled at compile time so the
// accumulators keep constant indices and stay in registers (a runtime loop
// over levels put them in local memory). At offset o = 16 >> H a lane keeps
// the upper or lower half of its columns (by its bit o) and adds its
// partner's sums for that half; once one column is left, the remaining
// levels are plain butterfly adds.
template <int CLB, int H>
__device__ __forceinline__ void reduce_tree(float (&a)[CLB], int lane) {
  if constexpr (H < 5) {
    constexpr int o = 16 >> H;
    constexpr int cur = CLB >> H;
    if constexpr (cur >= 2) {
      constexpr int half = cur / 2;
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float lo = a[i], hi = a[i + half];
        a[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, o);
      }
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], o);
    }
    reduce_tree<CLB, H + 1>(a, lane);
  }
}

// CLB: CL rounded up to a bucket (16, 32 or 64); columns >= CL of K are zero.
// Two resident blocks per SM cap registers at 128; at CLB = 64, K alone takes
// more than half of the shared memory, so one block fits and the cap would
// only force spills.
template <typename T, int CLB>
__global__ void __launch_bounds__(kWarps * 32, CLB == 64 ? 1 : 2)
mask_decode_kernel(const T* __restrict__ w, const T* __restrict__ mask,
                   const T* __restrict__ kern, float* __restrict__ out,
                   int S, int Tp, int N, int CL, int n_steps, long long n_units,
                   long long w_sb, long long w_st,
                   long long m_sb, long long m_ss, long long m_st) {
  constexpr int kVec = Traits<T>::kVec;
  constexpr int kSlot = CLB + 4;                  // padded floats per K slot
  constexpr int R = kUnits >= CLB ? kUnits / CLB : 1;  // units per warp pass
  constexpr int kSpread = CLB == 16 ? 1 : 0;      // lanes sharing a column after the tree
  constexpr int kLeft = CLB == 64 ? 2 : 1;        // columns per lane after the tree
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  const int n_slots = n_steps * 32 * kVec;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Stage K (N, CL) into the swizzled f32 layout, zero-filled past N and CL.
  for (int idx = threadIdx.x; idx < n_slots * CLB; idx += blockDim.x) {
    const int n = idx / CLB;
    const int j = idx - n * CLB;
    const int step = n / (32 * kVec);
    const int within = n - step * 32 * kVec;
    const int slot = (step * kVec + within % kVec) * 32 + within / kVec;
    float v = 0.f;
    if (n < N && j < CL) v = Traits<T>::to_float(kern[(long long)n * CL + j]);
    ks[slot * kSlot + j] = v;
  }
  __syncthreads();

  const long long n_groups = (n_units + R - 1) / R;
  const long long per_b = (long long)Tp * S;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < n_groups;
       g += (long long)gridDim.x * kWarps) {
    const T* wp[R];
    const T* mp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long u0 = g * R + r;
      const long long u = u0 < n_units ? u0 : n_units - 1;  // past the end: recompute, don't store
      const long long b = u / per_b;
      const long long rem = u - b * per_b;
      const long long t = rem / S;
      wp[r] = w + b * w_sb + t * w_st;
      mp[r] = mask + b * m_sb + (rem - t * S) * m_ss + t * m_st;
    }

    float acc[R][CLB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < CLB; ++j) acc[r][j] = 0.f;

    for (int step = 0; step < n_steps; ++step) {
      const int n0 = step * 32 * kVec + lane * kVec;
      if (n0 < N) {  // N % kVec == 0: a vector is wholly in or out
        uint4 wr[R], mr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          wr[r] = __ldg(reinterpret_cast<const uint4*>(wp[r] + n0));
          mr[r] = __ldg(reinterpret_cast<const uint4*>(mp[r] + n0));
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          float p[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            p[r] = Traits<T>::round_product(Traits<T>::get(wr[r], v), Traits<T>::get(mr[r], v));
          const float4* kr = reinterpret_cast<const float4*>(
              ks + ((step * kVec + v) * 32 + lane) * kSlot);
#pragma unroll
          for (int q = 0; q < CLB / 4; ++q) {
            const float4 k = kr[q];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][4 * q] = fmaf(p[r], k.x, acc[r][4 * q]);
              acc[r][4 * q + 1] = fmaf(p[r], k.y, acc[r][4 * q + 1]);
              acc[r][4 * q + 2] = fmaf(p[r], k.z, acc[r][4 * q + 2]);
              acc[r][4 * q + 3] = fmaf(p[r], k.w, acc[r][4 * q + 3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      reduce_tree<CLB, 0>(acc[r], lane);
      // Lane l now holds the full sums of columns (l >> kSpread) * kLeft + i.
      const long long u = g * R + r;
      if (u < n_units && (lane & ((1 << kSpread) - 1)) == 0) {
        const long long b = u / per_b;
        const long long rem = u - b * per_b;
        const long long t = rem / S;
        float* orow = out + ((b * S + (rem - t * S)) * Tp + t) * CL;
#pragma unroll
        for (int i = 0; i < kLeft; ++i) {
          const int col = (lane >> kSpread) * kLeft + i;
          if (col < CL) orow[col] = acc[r][i];
        }
      }
    }
  }
}

template <typename T, int CLB>
int launch(const void* w, const void* mask, const void* kern, void* out,
           int B, int S, int Tp, int N, int CL,
           long long w_sb, long long w_st, long long m_sb, long long m_ss,
           long long m_st, cudaStream_t stream) {
  constexpr int kVec = Traits<T>::kVec;
  constexpr int R = kUnits >= CLB ? kUnits / CLB : 1;
  const int n_steps = (N + 32 * kVec - 1) / (32 * kVec);
  const size_t smem = sizeof(float) * (size_t)n_steps * 32 * kVec * (CLB + 4);
  auto kernel = mask_decode_kernel<T, CLB>;
  // Per instantiation: the largest dynamic shared size opted into so far,
  // and the resident-grid size computed for the last shared size.
  static size_t opted_in = 0, grid_for_smem = 0;
  static int resident_blocks = 0;
  cudaError_t err;
  if (smem > opted_in) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  if (smem != grid_for_smem) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident_blocks = sms * per_sm;
    grid_for_smem = smem;
  }
  const long long n_units = (long long)B * S * Tp;
  const long long n_groups = (n_units + R - 1) / R;
  const long long wanted = (n_groups + kWarps - 1) / kWarps;
  const int grid = (int)(wanted < resident_blocks ? wanted : resident_blocks);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(mask),
      static_cast<const T*>(kern), static_cast<float*>(out),
      S, Tp, N, CL, n_steps, n_units, w_sb, w_st, m_sb, m_ss, m_st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* w, const void* mask, const void* kern, void* out,
             int B, int S, int Tp, int N, int CL,
             long long w_sb, long long w_st, long long m_sb, long long m_ss,
             long long m_st, cudaStream_t stream) {
  if (CL <= 16)
    return launch<T, 16>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st, m_sb, m_ss, m_st, stream);
  if (CL <= 32)
    return launch<T, 32>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st, m_sb, m_ss, m_st, stream);
  return launch<T, 64>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st, m_sb, m_ss, m_st, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w, mask and K share it). Strides are in
// elements; the last dimension of w and mask is contiguous. Returns a
// cudaError_t (0 on success). The Python wrapper validates every argument.
extern "C" int mask_decode_launch(const void* w, const void* mask, const void* kern,
                                  void* out, int dtype, int B, int S, int Tp, int N,
                                  int CL, long long w_sb, long long w_st,
                                  long long m_sb, long long m_ss, long long m_st,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st, m_sb, m_ss, m_st, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st, m_sb, m_ss, m_st, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory the launch needs, so the wrapper can refuse a shape
// that does not fit before launching.
extern "C" long long mask_decode_smem_bytes(int dtype, int N, int CL) {
  const int vec = dtype == 1 ? 8 : 4;
  const int clb = CL <= 16 ? 16 : (CL <= 32 ? 32 : 64);
  const long long n_steps = (N + 32 * vec - 1) / (32 * vec);
  return 4LL * n_steps * 32 * vec * (clb + 4);
}

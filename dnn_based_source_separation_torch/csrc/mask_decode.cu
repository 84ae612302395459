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
// the ~295 FLOP/byte an H100 needs before compute is the limit. DPRNN-TasNet's
// decoder (N=64, CL=2, T'=31999) moves as many bytes with an eighth of the
// FLOPs. So device memory bounds every width, with a floor of about 30 us in
// bf16 and 60 us in f32 at 3.35 TB/s. Every path reads each input byte once
// from device memory with coalesced loads and never writes w * mask anywhere.
// What stands between a path and that floor is bytes in flight (about 20 KB a
// SM covers the latency) and the issue of the product's instructions.
//
// Three paths; the wrapper's `_plan` (ops/mask_decode.py) picks one per call
// from dtype, shape and alignment, and the entry point refuses a path that
// cannot take the call:
//
//   * "rows": f32 at DPRNN-TasNet's decoder width, N = 64, CL = 2 (the only
//     instantiation; the template takes N = G x 4 with G a power of two and CL
//     an exact template value). A group of G = 16 lanes takes one frame (b, t)
//     with two sources, so each lane loads its vector of w once for both; a
//     warp takes 32 / G frames at consecutive t. Each lane holds its 4 rows x
//     CL of K in registers (no shared memory) and issues the loads of U = 4
//     frames before it uses the first, 3U 16-byte loads. The 2 U CL partial
//     sums reduce over the G lanes with the halving tree below, log2(G)
//     levels. Frame indices are 32-bit.
//   * "mma": bf16 with N a multiple of 8 and CL <= 16 (one or two n8 tiles:
//     Conv-TasNet's N = 512, CL = 16 and DPRNN-TasNet's N = 64, CL = 2), on
//     the tensor cores with mma.sync m16n8k16 (bf16 in, f32 out). A warp's
//     tile is 8 frames x two sources: rows g and g + 8 are the two sources of
//     frame g, so w is loaded once for both. Lane (g, c) loads, with one
//     16-byte load each, the 8 consecutive n = 32 j + 8 c .. 8 c + 7 of w and
//     of the two mask rows, forms w * mask in f32 and rounds it to bf16 pairs
//     (cvt.rn.bf16x2.f32): exactly the product the plain version rounds, built
//     as the A fragment in registers. The sum over n is order-free, so K is
//     permuted instead of the loads: physical 8c + 4s + {0, 1} is logical k
//     2c + {0, 1} of k-step s, 8c + 4s + {2, 3} is 2c + 8 + {0, 1}. K is
//     staged once per block in shared memory in that order, as whole B
//     fragments: one 16-byte shared load gives a lane both k-steps' fragments
//     of an n8 tile.
//   * "generic": every other call (f32 at N = 512, N = 500 or 61, CL beyond
//     16, rows not 16-byte aligned):
//       - K sits in shared memory as f32, staged once per block, in a swizzled
//         layout: slot ((step * VEC + v) * 32 + lane) holds the row
//         n = step * 32 * VEC + lane * VEC + v that lane `lane` needs for its
//         v-th element in step `step`; each slot is padded by 4 floats, so a
//         warp's 128-bit shared loads hit distinct banks;
//       - a unit of work is one output row (b, s, t). Units are ordered
//         t-major, s-minor, so the sources of one t are neighbours and the
//         second read of its w row hits L1. A warp takes R = 32 / CL-bucket
//         units (at least 1) at a time and applies each K value it loads from
//         shared memory to all R of them;
//       - per step each lane issues 2R independent 16-byte loads (w and mask
//         of R units); R = 4 ran no faster than 2 at the serving shape on an
//         H100;
//       - a unit's (b, s, t) comes from 32-bit divisions wherever B S T' fits
//         32 bits (faster at f32 N=512 than 64-bit ones on an H100);
//       - the 32 lanes' partial sums are reduced with the halving shuffle
//         tree: at each of 5 steps a lane keeps half of its columns and
//         receives its partner's sums for them, so CL-wide rows reduce in
//         about CL shuffles;
//       - the ragged edges (last unit group, N past the last vector) are
//         masked, not padded.
//     Rows whose N or strides are not multiples of the vector width are 8-,
//     4- or 2-byte aligned only: a second instantiation loads each lane's
//     vector with the widest loads its row allows and reads the ragged tail
//     element by element. C·L beyond 64 is cut into column blocks of at most
//     64, and an N whose K rows do not fit shared memory into row blocks whose
//     partial sums the later launches add to the output; each launch stages
//     its block of K.
//
// Every path runs a persistent grid: as many blocks as fit on the card at
// once, each warp striding over its work items, so there is no tail wave.
//
// Bound with ctypes (ops/_build.py); the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling
constexpr int kMaxCols = 64;        // the widest column block (bucket) of K
// Units (output rows) a warp carries per pass: R = kUnits / CL-bucket. At the
// serving shape on an H100, 32 (R = 2 at CL = 16) ran as fast as or faster
// than 64 (R = 4): a larger R cuts shared-memory traffic but needs more
// registers than two resident blocks per SM allow.
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

// The kVec elements of a lane's vector at p, `valid` of them in range (the
// rest read as zero), with the widest loads p's alignment allows.
template <typename T>
__device__ __forceinline__ uint4 load_vector(const T* p, int valid) {
  constexpr int kVec = Traits<T>::kVec;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (valid >= kVec) {
    if ((a & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(p));
    if ((a & 7) == 0) {
      const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
      const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p) + 1);
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if ((a & 3) == 0) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
      return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    }
  }
  // Element by element: the ragged tail, or bf16 rows aligned to 2 bytes.
  unsigned word[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < valid) word[v] = __ldg(reinterpret_cast<const unsigned*>(p) + v);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int v = 0; v < 8; ++v)
      if (v < valid) word[v >> 1] |= (unsigned)__ldg(q + v) << (16 * (v & 1));
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// One level of the halving reduction tree over groups of kLanes lanes,
// unrolled at compile time so the accumulators keep constant indices and stay
// in registers (a runtime loop over levels put them in local memory). At
// offset o = kLanes / 2 >> H a lane keeps the upper or lower half of its
// columns (by its bit o) and adds its partner's sums for that half; once one
// column is left, the remaining levels are plain butterfly adds. After the
// log2(kLanes) levels lane l of a group holds the sums
// (l / spread) * left + i, i < left, where left = CLB / kLanes and spread = 1
// for CLB >= kLanes, else left = 1 and spread = kLanes / CLB.
template <int CLB, int H, int kLanes = 32>
__device__ __forceinline__ void reduce_tree(float (&a)[CLB], int lane) {
  if constexpr ((kLanes >> (H + 1)) >= 1) {
    constexpr int o = kLanes >> (H + 1);
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
    reduce_tree<CLB, H + 1, kLanes>(a, lane);
  }
}

// (b, s, t) of output row u = (b T' + t) S + s, with 32-bit divisions where
// every row index fits 32 bits (the served shapes), else 64-bit ones.
__device__ __forceinline__ void unit_bst(long long u, long long n_units, int S, int Tp,
                                         long long& b, long long& s, long long& t) {
  if (n_units <= 0x7fffffffLL) {
    const unsigned f = (unsigned)u / (unsigned)S;
    const unsigned bb = f / (unsigned)Tp;
    s = (unsigned)u - f * (unsigned)S;
    b = bb;
    t = f - bb * (unsigned)Tp;
  } else {
    const long long f = u / S;
    s = u - f * S;
    b = f / Tp;
    t = f - b * Tp;
  }
}

// One column block of K: CW columns (K's rows ldk elements apart) into the
// output's columns (rows ldo floats apart); CLB is CW rounded up to a bucket
// (16, 32 or 64), columns >= CW of K read as zero. `accumulate` adds to the
// output (a later row block of K) instead of writing it. kAligned: N is
// whole vectors and every row is 16-byte aligned.
// Two resident blocks per SM cap registers at 128; at CLB = 64, K alone takes
// more than half of the shared memory, so one block fits and the cap would
// only force spills.
template <typename T, int CLB, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32, CLB == 64 ? 1 : 2)
mask_decode_kernel(const T* __restrict__ w, const T* __restrict__ mask,
                   const T* __restrict__ kern, float* __restrict__ out,
                   int S, int Tp, int N, int ldk, int CW, int ldo, bool accumulate,
                   int n_steps, long long n_units,
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

  // Stage K (N, CW) into the swizzled f32 layout, zero-filled past N and CW.
  for (int idx = threadIdx.x; idx < n_slots * CLB; idx += blockDim.x) {
    const int n = idx / CLB;
    const int j = idx - n * CLB;
    const int step = n / (32 * kVec);
    const int within = n - step * 32 * kVec;
    const int slot = (step * kVec + within % kVec) * 32 + within / kVec;
    float v = 0.f;
    if (n < N && j < CW) v = Traits<T>::to_float(kern[(long long)n * ldk + j]);
    ks[slot * kSlot + j] = v;
  }
  __syncthreads();

  const long long n_groups = (n_units + R - 1) / R;
  for (long long g = (long long)blockIdx.x * kWarps + warp; g < n_groups;
       g += (long long)gridDim.x * kWarps) {
    const T* wp[R];
    const T* mp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long u0 = g * R + r;
      const long long u = u0 < n_units ? u0 : n_units - 1;  // past the end: recompute, don't store
      long long b, s, t;
      unit_bst(u, n_units, S, Tp, b, s, t);
      wp[r] = w + b * w_sb + t * w_st;
      mp[r] = mask + b * m_sb + s * m_ss + t * m_st;
    }

    float acc[R][CLB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < CLB; ++j) acc[r][j] = 0.f;

    for (int step = 0; step < n_steps; ++step) {
      const int n0 = step * 32 * kVec + lane * kVec;
      if (n0 < N) {
        uint4 wr[R], mr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if constexpr (kAligned) {  // a vector is wholly in or out
            wr[r] = __ldg(reinterpret_cast<const uint4*>(wp[r] + n0));
            mr[r] = __ldg(reinterpret_cast<const uint4*>(mp[r] + n0));
          } else {
            wr[r] = load_vector(wp[r] + n0, N - n0);
            mr[r] = load_vector(mp[r] + n0, N - n0);
          }
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
        long long b, s, t;
        unit_bst(u, n_units, S, Tp, b, s, t);
        float* orow = out + ((b * S + s) * Tp + t) * ldo;
#pragma unroll
        for (int i = 0; i < kLeft; ++i) {
          const int col = (lane >> kSpread) * kLeft + i;
          if (col < CW) orow[col] = accumulate ? orow[col] + acc[r][i] : acc[r][i];
        }
      }
    }
  }
}

// Blocks of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory, opting the kernel into that much first; cached by the
// caller per instantiation (`blocks`, for `for_smem` bytes).
template <typename Kernel>
int resident_grid(Kernel kernel, size_t smem, int& blocks, size_t& for_smem) {
  if (blocks > 0 && smem == for_smem) return 0;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  for_smem = smem;
  return 0;
}

template <typename T, int CLB, bool kAligned>
int launch(const T* w, const T* mask, const T* kern, float* out, int B, int S, int Tp, int N,
           int ldk, int CW, int ldo, bool accumulate,
           long long w_sb, long long w_st, long long m_sb, long long m_ss,
           long long m_st, cudaStream_t stream) {
  constexpr int kVec = Traits<T>::kVec;
  constexpr int R = kUnits >= CLB ? kUnits / CLB : 1;
  const int n_steps = (N + 32 * kVec - 1) / (32 * kVec);
  const size_t smem = sizeof(float) * (size_t)n_steps * 32 * kVec * (CLB + 4);
  auto kernel = mask_decode_kernel<T, CLB, kAligned>;
  static int resident_blocks = 0;  // per instantiation, for the last shared size
  static size_t grid_for_smem = 0;
  const int err = resident_grid(kernel, smem, resident_blocks, grid_for_smem);
  if (err != 0) return err;
  const long long n_units = (long long)B * S * Tp;
  const long long n_groups = (n_units + R - 1) / R;
  const long long wanted = (n_groups + kWarps - 1) / kWarps;
  const int grid = (int)(wanted < resident_blocks ? wanted : resident_blocks);
  kernel<<<grid, kWarps * 32, smem, stream>>>(w, mask, kern, out, S, Tp, N, ldk, CW, ldo,
                                              accumulate, n_steps, n_units, w_sb, w_st, m_sb,
                                              m_ss, m_st);
  return (int)cudaGetLastError();
}

template <typename T, bool kAligned>
int launch_block(const T* w, const T* mask, const T* kern, float* out, int B, int S, int Tp,
                 int N, int ldk, int CW, int ldo, bool accumulate, long long w_sb,
                 long long w_st, long long m_sb, long long m_ss, long long m_st,
                 cudaStream_t stream) {
  if (CW <= 16)
    return launch<T, 16, kAligned>(w, mask, kern, out, B, S, Tp, N, ldk, CW, ldo, accumulate,
                                   w_sb, w_st, m_sb, m_ss, m_st, stream);
  if (CW <= 32)
    return launch<T, 32, kAligned>(w, mask, kern, out, B, S, Tp, N, ldk, CW, ldo, accumulate,
                                   w_sb, w_st, m_sb, m_ss, m_st, stream);
  return launch<T, 64, kAligned>(w, mask, kern, out, B, S, Tp, N, ldk, CW, ldo, accumulate,
                                 w_sb, w_st, m_sb, m_ss, m_st, stream);
}

// Column blocks of at most kMaxCols, and within each, row blocks of K that
// fit shared memory; the shapes of the served models take one launch.
template <typename T>
int decode(const void* w_, const void* mask_, const void* kern_, void* out_, int B, int S,
           int Tp, int N, int CL, long long w_sb, long long w_st, long long m_sb,
           long long m_ss, long long m_st, cudaStream_t stream) {
  constexpr int kVec = Traits<T>::kVec;
  const T* w = static_cast<const T*>(w_);
  const T* mask = static_cast<const T*>(mask_);
  const T* kern = static_cast<const T*>(kern_);
  float* out = static_cast<float*>(out_);
  const bool aligned = N % kVec == 0 && w_sb % kVec == 0 && w_st % kVec == 0 &&
                       m_sb % kVec == 0 && m_ss % kVec == 0 && m_st % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  for (int col0 = 0; col0 < CL; col0 += kMaxCols) {
    const int cw = CL - col0 < kMaxCols ? CL - col0 : kMaxCols;
    const int clb = cw <= 16 ? 16 : (cw <= 32 ? 32 : 64);
    // K rows one launch stages: whole warp steps (32 lanes x kVec) that fit.
    const int rows = kMaxShared / (4 * (clb + 4)) / (32 * kVec) * (32 * kVec);
    for (int n0 = 0; n0 < N; n0 += rows) {
      const int nn = N - n0 < rows ? N - n0 : rows;
      auto block = aligned ? &launch_block<T, true> : &launch_block<T, false>;
      const int err = block(w + n0, mask + n0, kern + (long long)n0 * CL + col0, out + col0, B, S,
                            Tp, nn, CL, cw, CL, n0 > 0, w_sb, w_st, m_sb, m_ss, m_st, stream);
      if (err != 0) return err;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The "rows" and "mma" paths. Both take rows that are 16-byte aligned with N
// whole vectors, and B x S x T' < 2^30 (32-bit frame and row indices, with
// room for a work item past the last frame).

// One call's arguments; strides in elements.
template <typename T>
struct Call {
  const T* w;
  const T* mask;
  const T* kern;
  float* out;
  int B, S, Tp, N, CL;
  long long w_sb, w_st, m_sb, m_ss, m_st;
};

// (b, t) of frame f = b T' + t, with one 32-bit division.
__device__ __forceinline__ void frame_bt(int f, int Tp, int& b, int& t) {
  b = (int)((unsigned)f / (unsigned)Tp);
  t = f - b * Tp;
}

// "rows": frames a lane group carries in flight at once (its loads issued
// before the first is used), from the registers its partial sums take.
template <int CL>
__host__ __device__ constexpr int rows_iterations() {
  return CL <= 4 ? 4 : (CL == 8 ? 2 : 1);
}

// A work item is kFrames consecutive frames (U iterations of 32 / G frames,
// one frame a lane group) with one pair of sources (s0, s0 + 1); items are
// ordered frame-major, pair-minor. With S odd the last pair's second source
// is loaded as s0 again and not stored.
template <int G, int CL>
__global__ void __launch_bounds__(kWarps * 32, 2)
rows_kernel(Call<float> a, int n_frames, int n_items) {
  constexpr int kVec = Traits<float>::kVec;
  constexpr int kGroups = 32 / G;  // frames a warp takes per iteration
  constexpr int U = rows_iterations<CL>();
  constexpr int kFrames = U * kGroups;
  constexpr int P = U * 2 * CL;  // a lane's partial sums, index (2 u + source) CL + column
  constexpr int kLeft = P >= G ? P / G : 1;    // sums a lane holds after the tree
  constexpr int kSpread = P >= G ? 1 : G / P;  // lanes that hold the same sum
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane & (G - 1);  // lane within its group
  const int gi = lane / G;        // the group: which frame of an iteration
  const int n0 = li * kVec;
  const int n_pairs = (a.S + 1) >> 1;

  float k[kVec][CL];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
#pragma unroll
    for (int c = 0; c < CL; ++c) k[v][c] = a.kern[(n0 + v) * CL + c];

  for (int item = blockIdx.x * kWarps + warp; item < n_items; item += gridDim.x * kWarps) {
    const int batch = item / n_pairs;
    const int s0 = 2 * (item - batch * n_pairs);
    const int s1 = s0 + 1 < a.S ? s0 + 1 : s0;
    float4 wr[U], m0[U], m1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int f = batch * kFrames + u * kGroups + gi;
      f = f < n_frames ? f : n_frames - 1;  // past the end: recompute, don't store
      int b, t;
      frame_bt(f, a.Tp, b, t);
      const float* wp = a.w + b * a.w_sb + t * a.w_st + n0;
      const float* mp = a.mask + b * a.m_sb + t * a.m_st + n0;
      wr[u] = __ldg(reinterpret_cast<const float4*>(wp));
      m0[u] = __ldg(reinterpret_cast<const float4*>(mp + s0 * a.m_ss));
      m1[u] = __ldg(reinterpret_cast<const float4*>(mp + s1 * a.m_ss));
    }
    float acc[P];
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float x[4] = {wr[u].x, wr[u].y, wr[u].z, wr[u].w};
      const float y0[4] = {m0[u].x, m0[u].y, m0[u].z, m0[u].w};
      const float y1[4] = {m1[u].x, m1[u].y, m1[u].z, m1[u].w};
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float p0 = x[v] * y0[v];
        const float p1 = x[v] * y1[v];
#pragma unroll
        for (int c = 0; c < CL; ++c) {
          acc[2 * u * CL + c] = fmaf(p0, k[v][c], acc[2 * u * CL + c]);
          acc[(2 * u + 1) * CL + c] = fmaf(p1, k[v][c], acc[(2 * u + 1) * CL + c]);
        }
      }
    }
    reduce_tree<P, 0, G>(acc, lane);
    if (li % kSpread == 0) {
#pragma unroll
      for (int i = 0; i < kLeft; ++i) {
        const int j = li / kSpread * kLeft + i;
        const int u = j / (2 * CL);
        const int s = s0 + (j / CL) % 2;
        const int f = batch * kFrames + u * kGroups + gi;
        if (f < n_frames && s < a.S) {
          int b, t;
          frame_bt(f, a.Tp, b, t);
          a.out[((long long)(b * a.S + s) * a.Tp + t) * CL + j % CL] = acc[i];
        }
      }
    }
  }
}

template <int G, int CL>
int launch_rows(const Call<float>& a, cudaStream_t stream) {
  constexpr int kFrames = rows_iterations<CL>() * (32 / G);
  auto kernel = rows_kernel<G, CL>;
  static int resident = 0;
  static size_t for_smem = 0;
  const int err = resident_grid(kernel, 0, resident, for_smem);
  if (err != 0) return err;
  const int n_frames = a.B * a.Tp;
  const int n_items = (n_frames + kFrames - 1) / kFrames * ((a.S + 1) / 2);
  const int wanted = (n_items + kWarps - 1) / kWarps;
  kernel<<<wanted < resident ? wanted : resident, kWarps * 32, 0, stream>>>(a, n_frames, n_items);
  return (int)cudaGetLastError();
}

// The served width only: N = 64 (16 lanes a frame), CL = 2.
int rows(const Call<float>& a, cudaStream_t stream) {
  if (a.N == 64 && a.CL == 2) return launch_rows<16, 2>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// "mma": bf16 on the tensor cores.
constexpr int kChunk = 32;       // n of one 16-byte load by each of a row's 4 lanes
constexpr int kMmaBatch = 4;     // chunks whose loads a lane issues before the first product
constexpr int kMmaMaxCols = 16;  // CL up to 2 n8 tiles

// d += a (16 x 16, row) @ b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to a bf16 pair (cvt.rn.bf16x2.f32), `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__host__ __device__ constexpr int mma_chunks(int N) { return (N + kChunk - 1) / kChunk; }

// Shared memory of K's B fragments: [chunk][n8 tile][lane], 16 bytes each.
template <int NT>
size_t mma_shared(int N) {
  return sizeof(uint4) * (size_t)mma_chunks(N) * NT * 32;
}

// NT n8 tiles cover CL <= 8 NT columns. A work item is a tile of 8 frames
// with one pair of sources, ordered frame-major, pair-minor (as in "rows").
template <int NT>
__global__ void __launch_bounds__(kWarps * 32, 2)
mma_kernel(Call<__nv_bfloat16> a, int n_frames, int n_items) {
  extern __shared__ uint4 kfrag[];
  const int n_chunks = mma_chunks(a.N);
  // Stage K. Lane (g, c) of n8 tile j and chunk ch takes, for k-step s, rows
  // n = 32 ch + 8 c + 4 s + {0, 1, 2, 3} of column 8 j + g: logical k 2c,
  // 2c + 1, 2c + 8, 2c + 9, the order its A fragment holds the products in.
  // Word q = 2 s + h holds rows 32 ch + 8 c + 2 q + {0, 1}; zero past N and CL.
  const unsigned short* kb = reinterpret_cast<const unsigned short*>(a.kern);
  for (int idx = threadIdx.x; idx < n_chunks * NT * 32; idx += blockDim.x) {
    const int l = idx & 31;
    const int j = (idx >> 5) % NT;
    const int ch = (idx >> 5) / NT;
    const int col = 8 * j + (l >> 2);
    const int nb = kChunk * ch + 8 * (l & 3);
    unsigned word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = nb + 2 * q;
      const unsigned lo = col < a.CL && n < a.N ? kb[n * a.CL + col] : 0u;
      const unsigned hi = col < a.CL && n + 1 < a.N ? kb[(n + 1) * a.CL + col] : 0u;
      word[q] = lo | (hi << 16);
    }
    kfrag[idx] = make_uint4(word[0], word[1], word[2], word[3]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the tile row: frame g; rows g and g + 8 its two sources
  const int c = lane & 3;
  const int n_pairs = (a.S + 1) >> 1;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int item = blockIdx.x * kWarps + warp; item < n_items; item += gridDim.x * kWarps) {
    const int tile = item / n_pairs;
    const int s0 = 2 * (item - tile * n_pairs);
    const int s1 = s0 + 1 < a.S ? s0 + 1 : s0;
    const int f_row = tile * 8 + g;
    int b, t;
    frame_bt(f_row < n_frames ? f_row : n_frames - 1, a.Tp, b, t);
    const __nv_bfloat16* wp = a.w + b * a.w_sb + t * a.w_st + 8 * c;
    const __nv_bfloat16* mp = a.mask + b * a.m_sb + t * a.m_st + 8 * c;
    const __nv_bfloat16* m0p = mp + s0 * a.m_ss;
    const __nv_bfloat16* m1p = mp + s1 * a.m_ss;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int ch0 = 0; ch0 < n_chunks; ch0 += kMmaBatch) {
      uint4 wr[kMmaBatch], x0[kMmaBatch], x1[kMmaBatch];
#pragma unroll
      for (int d = 0; d < kMmaBatch; ++d) {  // lanes past N (and chunks past the last) read zero
        const int off = kChunk * (ch0 + d);
        const bool valid = off + 8 * c < a.N;
        wr[d] = valid ? __ldg(reinterpret_cast<const uint4*>(wp + off)) : zero;
        x0[d] = valid ? __ldg(reinterpret_cast<const uint4*>(m0p + off)) : zero;
        x1[d] = valid ? __ldg(reinterpret_cast<const uint4*>(m1p + off)) : zero;
      }
#pragma unroll
      for (int d = 0; d < kMmaBatch; ++d) {
        const int ch = ch0 + d;
        if (ch < n_chunks) {
          float p[8], q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float x = Traits<__nv_bfloat16>::get(wr[d], e);
            p[e] = x * Traits<__nv_bfloat16>::get(x0[d], e);
            q[e] = x * Traits<__nv_bfloat16>::get(x1[d], e);
          }
          unsigned frag[2][4];  // A of k-steps 0 and 1: rows g, g + 8 x logical k 2c.., 2c + 8..
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            frag[s][0] = pack_bf16(p[4 * s], p[4 * s + 1]);
            frag[s][1] = pack_bf16(q[4 * s], q[4 * s + 1]);
            frag[s][2] = pack_bf16(p[4 * s + 2], p[4 * s + 3]);
            frag[s][3] = pack_bf16(q[4 * s + 2], q[4 * s + 3]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint4 kv = kfrag[(ch * NT + j) * 32 + lane];
            mma_bf16(acc[j], frag[0], kv.x, kv.y);
            mma_bf16(acc[j], frag[1], kv.z, kv.w);
          }
        }
      }
    }
    // C fragment: (row g, columns 8 j + 2 c, + 1) in [0], [1]; row g + 8 in [2], [3].
    if (f_row < n_frames) {
      float* o0 = a.out + ((long long)(b * a.S + s0) * a.Tp + t) * a.CL;
      float* o1 = o0 + (long long)a.Tp * a.CL;
      const bool second = s0 + 1 < a.S;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + 2 * c + h;
          if (col < a.CL) {
            o0[col] = acc[j][h];
            if (second) o1[col] = acc[j][2 + h];
          }
        }
      }
    }
  }
}

template <int NT>
int launch_mma(const Call<__nv_bfloat16>& a, cudaStream_t stream) {
  auto kernel = mma_kernel<NT>;
  static int resident = 0;
  static size_t for_smem = 0;
  const size_t smem = mma_shared<NT>(a.N);
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  const int err = resident_grid(kernel, smem, resident, for_smem);
  if (err != 0) return err;
  const int n_frames = a.B * a.Tp;
  const int n_items = (n_frames + 7) / 8 * ((a.S + 1) / 2);
  const int wanted = (n_items + kWarps - 1) / kWarps;
  kernel<<<wanted < resident ? wanted : resident, kWarps * 32, smem, stream>>>(a, n_frames,
                                                                              n_items);
  return (int)cudaGetLastError();
}

int mma(const Call<__nv_bfloat16>& a, cudaStream_t stream) {
  if (a.N % 8 != 0 || a.CL > kMmaMaxCols) return (int)cudaErrorInvalidValue;
  return a.CL <= 8 ? launch_mma<1>(a, stream) : launch_mma<2>(a, stream);
}

// path: 1 = "rows", 2 = "mma".
template <typename T>
int decode_planned(int path, const void* w, const void* mask, const void* kern, void* out, int B,
                   int S, int Tp, int N, int CL, long long w_sb, long long w_st, long long m_sb,
                   long long m_ss, long long m_st, cudaStream_t stream) {
  constexpr int kVec = Traits<T>::kVec;
  const Call<T> a{static_cast<const T*>(w), static_cast<const T*>(mask),
                  static_cast<const T*>(kern), static_cast<float*>(out), B, S, Tp, N, CL,
                  w_sb, w_st, m_sb, m_ss, m_st};
  const bool aligned = N % kVec == 0 && w_sb % kVec == 0 && w_st % kVec == 0 &&
                       m_sb % kVec == 0 && m_ss % kVec == 0 && m_st % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  if (!aligned || (long long)B * S * Tp >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (path == 1) return rows(a, stream);
  } else {
    if (path == 2) return mma(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w, mask and K share it). path: 0 =
// "generic", 1 = "rows", 2 = "mma" (ops/mask_decode.py:_plan). Strides are in
// elements; the last dimension of w and mask is contiguous, K (N, CL) is
// contiguous. The generic path takes any N, C·L, stride and element
// alignment; "rows" and "mma" refuse (cudaErrorInvalidValue) a call they
// cannot take. Returns a cudaError_t (0 on success). The Python wrapper
// validates every argument.
extern "C" int mask_decode_launch(const void* w, const void* mask, const void* kern,
                                  void* out, int dtype, int path, int B, int S, int Tp, int N,
                                  int CL, long long w_sb, long long w_st,
                                  long long m_sb, long long m_ss, long long m_st,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Tp < 1 || N < 1 || CL < 1 || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return path == 0 ? decode<float>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st, m_sb, m_ss,
                                     m_st, st)
                     : decode_planned<float>(path, w, mask, kern, out, B, S, Tp, N, CL, w_sb,
                                             w_st, m_sb, m_ss, m_st, st);
  if (dtype == 1)
    return path == 0 ? decode<__nv_bfloat16>(w, mask, kern, out, B, S, Tp, N, CL, w_sb, w_st,
                                             m_sb, m_ss, m_st, st)
                     : decode_planned<__nv_bfloat16>(path, w, mask, kern, out, B, S, Tp, N, CL,
                                                     w_sb, w_st, m_sb, m_ss, m_st, st);
  return (int)cudaErrorInvalidValue;
}

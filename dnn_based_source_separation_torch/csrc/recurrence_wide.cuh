// Tensor-core forward of the LSTM recurrences at H = 256 and 384 for many sequences (Hopper,
// sm_90a): an M-row tile of independent sequences of one chain held by a thread-block cluster.
//
// Included by csrc/lstm_scan.cu only, after csrc/recurrence_mma.cuh,
// csrc/recurrence_tf32.cuh and csrc/recurrence_cluster.cuh (whose fragment, cluster and
// mbarrier helpers it uses), and launched there as path 5, "wide"
// (ops/lstm_scan.py:_plan picks it and the tile (M, C)). ops/_build.py hashes this
// header into the key of every source. For these calls it replaces the TPU kernels of
// dnn_based_source_separation_tpu/ops/pallas_lstm.py:
//   lstm_scan        (:139, _lstm_kernel):  one chain;
//   lstm_scan_bidir  (:310, _bidir_kernel): two chains, the second over a sequence
//                    the caller has already reversed in time.
//
// It computes the FMA kernel's function (csrc/lstm_scan.cu): per step
//     gates = f32(xw[b, t, :]) + f32(h rounded to W's dtype) @ f32(W_hh)
// in gate order i, f, g, o; c and h carried in f32; hs (and cs, when the caller asks
// for it) rounded to the dtype on write. The product runs on the tensor cores in both
// dtypes: in bfloat16 as mma.sync m16n8k16 bf16 x bf16 -> f32 (each product of two bf16
// values exact, the sums f32, as on the "mma" path); in float32 as three TF32 products on
// m16n8k8 (hi/lo splits, lo * lo dropped, as on the "tf32x3" path). The sigmoid divides
// with div.approx (2 ulp), as on the other tensor-core paths.
//
// What bounds it. DPTNet serves 5112 sequences of 100 steps (intra-chunk, two chains)
// and 800 of 639 (inter-chunk) at H = 256: 0.536 TFLOP of recurrent product a launch.
// The FMA kernel ran it on CUDA cores in f32 in both dtypes and re-read the part of
// W_hh its shared memory could not hold (512 KB in bf16, 1 MB in f32) from L2 on every
// step. Here W_hh never leaves the chip after the start, and the product runs on the
// tensor cores; a step of a tile is its product (the A and B fragments read from shared
// memory, about 3/32 byte a FLOP in bf16, which shared memory's 128 bytes a clock bounds
// below the tensor cores' rate; in f32 also the hi/lo splits), the cell update and the
// exchange of h between the blocks, one after the other. Measured on an H100 at DPTNet's
// tiles (PERF.md; scripts/probe_wide_recurrence.py takes each part out), the product is
// about half of a bf16 step and two thirds of an f32 one, the cell and the exchange
// about a fifth each in bf16.
//
// Design:
//   * a cluster of C blocks, one SM each (at least kOwnSm of shared memory), owns an
//     M-row tile of independent sequences of one chain (blockIdx.x = C tile + rank,
//     blockIdx.y the chain). Rank r owns hidden units [r H/C, (r+1) H/C) and all four
//     gate columns of them: an mma C fragment holds the same (row, unit) positions for
//     every n8 tile, so the cell update runs in registers with no exchange. The warps
//     split units and rows: warp (wm, wu) owns 8 units x 16 MTW rows (MTW m16 tiles:
//     in f32 two, so that each W split serves both; in bf16 one, or two where one
//     tile a warp would pass kMaxWarps warps);
//   * each rank stages its H x 4H/C slice of W_hh once into shared memory in fragment
//     order (bf16: 128 KB at C = 4, 64 KB at C = 8; f32: 128 KB at C = 8, 64 KB at
//     C = 16), and a lane reads its B fragment of a gate as one 8-byte load, a warp 256
//     contiguous bytes: no bank conflict, no L2 traffic for W after the start;
//   * h goes into a double-buffered M x H tile (bf16, rounded, in the bf16 instantiation;
//     f32 in the f32 one), laid out rank-major: C blocks of M rows x H/C columns, one a
//     rank, each row padded by 16 bytes so that ldmatrix and the fragment writes hit
//     distinct banks. A rank's M x H/C columns are one contiguous block: its threads
//     write their pairs into it, and after one block barrier C - 1 threads copy the
//     whole block into the other ranks' tiles, one cp.async.bulk (shared::cta to
//     shared::cluster) each, which completes its bytes on that rank's mbarrier of the
//     buffer. Thread 0 arms its rank's mbarrier for the next step's bytes and every
//     thread waits on it before the next product: a rank waits for the data it reads
//     and for nothing else. On an H100 (PERF.md; scripts/probe_wide_recurrence.py
//     rebuilds the others) the copies took 13-15% less time than each pair sent by
//     st.async onto the mbarriers (as in csrc/recurrence_cluster.cuh) and 15-30% less
//     than each pair stored with st.shared::cluster before one barrier.cluster a step
//     (as in csrc/recurrence_tf32.cuh), but at bf16's 64-row tiles, where the three
//     were within 2%: C - 1 copies a step in place of M H/C / 2 remote stores to each
//     rank;
//   * the hidden size is a template parameter. H = 256 serves DPTNet; H = 384 serves
//     DANet's, ADANet's and deep clustering's H = 300 training batches, zero-padded by the
//     caller (ops/lstm_scan.py:cluster_width; exact). At 384 a rank's W slice is 144 KB at
//     f32 C = 16 and bf16 C = 8, so f32 runs M = 16 (3 warps over 24 units a rank) and bf16
//     M = 16 or 32 (6 warps over 48 units, 1 or 2 over rows); H / C stays a multiple of the
//     k-step, so each k-step's columns lie in one rank's block;
//   * xw streams straight into registers one step ahead: each thread loads the pairs of
//     its C fragment positions of step t + 1 while the tensor cores run step t. A
//     shared-memory ring does not fit beside W at M = 64. Rows past B read zeros, are
//     computed and exchanged like the others, and are never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recurrence_cluster.cuh"
#include "recurrence_mma.cuh"
#include "recurrence_tf32.cuh"

namespace wide_scan {

constexpr int kGates = 4;
constexpr int kMaxWarps = 16;          // 512 threads, 128 registers each
constexpr size_t kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling
constexpr size_t kOwnSm = 120 * 1024;  // no two blocks on one SM

struct Chains {
  const void* xw[2];
  const void* whh[2];
  void* hs[2];
  void* cs[2];  // null: do not write the cell state
};

// The tile's geometry: H / C units a rank, 8 a warp (NWU warps over units); M / 16 m16
// tiles, MTW a warp (NWM warps over rows). bf16: one tile a warp, two where one would
// pass kMaxWarps warps; f32: two where the tile has two, so that each split of a B
// fragment (hi and lo of W) serves both.
template <typename T, int H, int M, int C>
struct Geometry {
  static constexpr int HU = H / C;
  static constexpr int NWU = HU / 8;
  static constexpr int MTW = NWU * (M / 16) > kMaxWarps  ? NWU * (M / 16) / kMaxWarps
                             : sizeof(T) == 4 && M >= 32 ? 2
                                                         : 1;
  static constexpr int NWM = M / 16 / MTW;
  static constexpr int kWarps = NWU * NWM;
  static constexpr int kThreads = 32 * kWarps;
};

// Shared memory: two mbarriers (16 bytes), the W slice (H x 4 H/C values of `elem`
// bytes) and h [2][C][M][H/C + 16 / elem]; at least kOwnSm.
__host__ __device__ constexpr size_t w_bytes(int H, int C, size_t elem) {
  return (size_t)H * kGates * (H / C) * elem;
}
__host__ __device__ constexpr size_t smem_need(int H, int M, int C, size_t elem) {
  return 16 + w_bytes(H, C, elem) + 2 * (size_t)M * (H * elem + 16 * (size_t)C);
}
__host__ __device__ constexpr size_t smem_bytes(int H, int M, int C, size_t elem) {
  return smem_need(H, M, C, elem) > kOwnSm ? smem_need(H, M, C, elem) : kOwnSm;
}

// H = 256 or 384, the cluster sizes of each dtype (bf16: 4 or 8; f32: 8 or 16, 16 a
// non-portable size), M = 16, 32 or 64, and the shared memory within kMaxShared.
inline bool shape_ok(int dtype, int H, int M, int C) {
  const bool sizes = dtype == 1 ? (C == 4 || C == 8) : dtype == 0 && (C == 8 || C == 16);
  return (H == 256 || H == 384) && sizes && (M == 16 || M == 32 || M == 64) &&
         smem_need(H, M, C, dtype == 1 ? 2 : 4) <= kMaxShared;
}

// A pair of adjacent values of the dtype in registers (bf16: one 32-bit word, the lower
// address in the low half; f32: float2) and their f32 values.
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = unsigned;
  __device__ __forceinline__ static type zero() { return 0u; }
  __device__ __forceinline__ static type load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
  __device__ __forceinline__ static float lo(type v) { return mma_scan::low_f32(v); }
  __device__ __forceinline__ static float hi(type v) { return mma_scan::high_f32(v); }
  __device__ __forceinline__ static type pack(float a, float b) { return mma_scan::pack_bf16(a, b); }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<unsigned*>(p) = pack(a, b);
  }
};
template <>
struct Pair<float> {
  using type = float2;
  __device__ __forceinline__ static type zero() { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ static type load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ static float lo(type v) { return v.x; }
  __device__ __forceinline__ static float hi(type v) { return v.y; }
  __device__ __forceinline__ static type pack(float a, float b) { return make_float2(a, b); }
  __device__ __forceinline__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// `bytes` of this block's shared memory at `src` into another rank's at `dst` (a
// shared::cluster address), completing them on that rank's mbarrier `mbar`.
__device__ __forceinline__ void copy_bulk(unsigned dst, unsigned src, unsigned bytes,
                                          unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// Fragment position j of m16 tile mt of a warp is row 16 (wm MTW + mt) + gid + 8 (j >> 1)
// of the tile and unit r H/C + 8 wu + 2 tig + (j & 1).
template <typename T, int H, int M, int C>
__global__ void __launch_bounds__(Geometry<T, H, M, C>::kThreads, 1)
scan_wide_kernel(Chains chains, int B, int T_len) {
  using G = Geometry<T, H, M, C>;
  using P = Pair<T>;
  using PT = typename P::type;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int HU = G::HU, NWU = G::NWU, MTW = G::MTW;
  constexpr int KK = kBf16 ? 16 : 8;          // k of an mma
  constexpr int KS = H / KK;                  // k-steps of the product
  static_assert(HU % KK == 0 && HU % 8 == 0 && G::kWarps <= kMaxWarps, "tile");
  constexpr int LDB = HU + 16 / (int)sizeof(T);  // a rank block's row, padded by 16 bytes
  constexpr int BLOCK = M * LDB;                 // a rank's block of the h tile
  constexpr long long G4 = (long long)kGates * H;

  // Constant indices: a runtime index into the parameter arrays would copy them to
  // local memory.
  const bool second = blockIdx.y != 0;
  const T* __restrict__ xw = static_cast<const T*>(second ? chains.xw[1] : chains.xw[0]);
  const T* __restrict__ whh = static_cast<const T*>(second ? chains.whh[1] : chains.whh[0]);
  T* __restrict__ hs = static_cast<T*>(second ? chains.hs[1] : chains.hs[0]);
  T* __restrict__ cs = static_cast<T*>(second ? chains.cs[1] : chains.cs[0]);

  extern __shared__ float4 smem_wide[];
  uint64_t* mbars = reinterpret_cast<uint64_t*>(smem_wide);  // [2]: h of the buffer arrived
  // A lane's B fragment of one gate and k-step: two words (bf16 pairs or f32 values).
  using FT = typename std::conditional<kBf16, uint2, float2>::type;
  FT* wsm = reinterpret_cast<FT*>(smem_wide + 1);  // [KS][NWU][4 q][32 lanes]
  T* htile = reinterpret_cast<T*>(reinterpret_cast<char*>(wsm) + w_bytes(H, C, sizeof(T)));  // [2][C][M][LDB]

  const unsigned rank = tf32_scan::cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wu = warp % NWU, wm = warp / NWU;
  const int gid = lane >> 2, tig = lane & 3;
  const int ubase = (int)rank * HU;
  const int u = ubase + 8 * wu + 2 * tig;  // this thread's units u and u + 1
  const int row0 = 16 * MTW * wm + gid;    // its first row in the tile
  const long long b0 = (long long)(blockIdx.x / C) * M;

  // W_hh (H, 4H) row-major -> this rank's B fragments. Pair e of lane l's fragment
  // (k-step ks, warp column wu, gate q) holds column q H + ubase + 8 wu + l / 4 at
  // rows 16 ks + 2 (l % 4) + 8 e and the row after it (bf16: both halves of a word,
  // the lower row in the low half), or at rows 8 ks + l % 4 + 4 e (f32: .x for e = 0,
  // .y for e = 1).
  for (int i = tid; i < KS * NWU * kGates * 32 * 2; i += G::kThreads) {
    const int e = i & 1, l = (i >> 1) & 31, q = (i >> 6) & 3;
    const int rest = i >> 8, w = rest % NWU, ks = rest / NWU;
    const long long col = (long long)q * H + ubase + 8 * w + (l >> 2);
    if constexpr (kBf16) {
      const unsigned short* w16 = reinterpret_cast<const unsigned short*>(whh);
      const long long row = KK * ks + 2 * (l & 3) + 8 * e;
      reinterpret_cast<unsigned*>(wsm)[i] =
          (unsigned)__ldg(w16 + row * G4 + col) | ((unsigned)__ldg(w16 + (row + 1) * G4 + col) << 16);
    } else {
      reinterpret_cast<float*>(wsm)[i] = __ldg(whh + (long long)(KK * ks + (l & 3) + 4 * e) * G4 + col);
    }
  }
  {  // h = 0 before step 0 (buffer 0)
    unsigned* h0 = reinterpret_cast<unsigned*>(htile);
    for (int i = tid; i < C * BLOCK * (int)sizeof(T) / 4; i += G::kThreads) h0[i] = 0u;
  }
  const unsigned mbar = tf32_scan::smem_addr(mbars);
  if (tid == 0) {
    cluster_scan::mbar_init(mbar);
    cluster_scan::mbar_init(mbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The xw pairs of this thread's fragment positions at step t.
  auto load_x = [&](PT (&x)[MTW][kGates][2], int t) {
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long b = b0 + row0 + 16 * mt + 8 * half;
        const T* row = xw + (b * T_len + t) * G4 + u;
#pragma unroll
        for (int q = 0; q < kGates; ++q) x[mt][q][half] = b < B ? P::load(row + q * H) : P::zero();
      }
  };
  PT xn[MTW][kGates][2];
  load_x(xn, 0);

  // This block's shared memory; the other ranks' have the same layout.
  const unsigned base = tf32_scan::smem_addr(smem_wide);
  const unsigned h_off = tf32_scan::smem_addr(htile) - base;
  const FT* wfrag = wsm + wu * kGates * 32 + lane;
  // ldmatrix's row of this lane in an m16 tile and its column: bf16, the 16 x 16 A
  // tile; f32, the 16 x 8 one.
  const int arow = kBf16 ? (lane & 15) : (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = kBf16 ? 8 * (lane >> 4) : 4 * (lane >> 4);
  const T* afrag = htile + (16 * MTW * wm + arow) * LDB + acol;
  // This thread's h pairs in its rank's block of a buffer: row row0 + 16 mt + 8 half.
  const int hpos = (int)rank * BLOCK + row0 * LDB + (u - ubase);

  float c[MTW][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[mt][j] = 0.f;

  // W staged, h zeroed and the mbarriers set up in every block, and every block
  // running, before any write to another's shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();

  // Step t reads h_{t-1} from buffer t % 2 and writes h_t into buffer (t+1) % 2 of every
  // rank. A rank copies its block of h_t only after it has all of h_{t-1}, which every
  // rank copied after the block barrier that followed its warps' reads of step t - 1:
  // so no buffer is written while it is read, and a block is not rewritten before its
  // copies of two steps back, which the receivers awaited before they copied what this
  // rank awaited since, have landed.
#pragma unroll 1
  for (int t = 0; t < T_len; ++t) {
    const int cur = (t & 1) * C * BLOCK, next = ((t + 1) & 1) * C * BLOCK;
    const unsigned next_mbar = 8u * (unsigned)((t + 1) & 1);
    // The other ranks' blocks, padding and all (this rank writes its own itself).
    constexpr unsigned kBytes = (unsigned)((C - 1) * BLOCK * sizeof(T));
    if (tid == 0 && t + 1 < T_len) cluster_scan::mbar_expect(mbar + next_mbar, kBytes);
    if (t > 0) cluster_scan::mbar_wait(mbar + 8u * (unsigned)(t & 1), (unsigned)((t - 1) >> 1) & 1u);
    float acc[MTW][kGates][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        acc[mt][q][0] = P::lo(xn[mt][q][0]);
        acc[mt][q][1] = P::hi(xn[mt][q][0]);
        acc[mt][q][2] = P::lo(xn[mt][q][1]);
        acc[mt][q][3] = P::hi(xn[mt][q][1]);
      }
    if (t + 1 < T_len) load_x(xn, t + 1);

    const T* a_t = afrag + cur;
    if constexpr (kBf16) {
#pragma unroll 2
      for (int ks = 0; ks < KS; ++ks) {
        uint2 bw[kGates];
#pragma unroll
        for (int q = 0; q < kGates; ++q) bw[q] = wfrag[(ks * NWU * kGates + q) * 32];
        const T* a_k = a_t + (KK * ks / HU) * BLOCK + KK * ks % HU;
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          unsigned a[4];
          mma_scan::ldmatrix_x4(a, a_k + 16 * mt * LDB);
#pragma unroll
          for (int q = 0; q < kGates; ++q) mma_scan::mma_bf16(acc[mt][q], a, bw[q].x, bw[q].y);
        }
      }
    } else {
      // Unrolled so that one k-step's loads and splits overlap another's products: at
      // most 8 warps a block, 2 a scheduler.
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        unsigned bhi[kGates][2], blo[kGates][2];
#pragma unroll
        for (int q = 0; q < kGates; ++q) {
          const float2 w = wfrag[(ks * NWU * kGates + q) * 32];
          tf32_scan::split(w.x, bhi[q][0], blo[q][0]);
          tf32_scan::split(w.y, bhi[q][1], blo[q][1]);
        }
        const T* a_k = a_t + (KK * ks / HU) * BLOCK + KK * ks % HU;
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          unsigned a[4], ahi[4], alo[4];
          tf32_scan::ldmatrix_x4(a, a_k + 16 * mt * LDB);
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_scan::split(__uint_as_float(a[i]), ahi[i], alo[i]);
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            tf32_scan::mma_tf32(acc[mt][q], alo, bhi[q]);
            tf32_scan::mma_tf32(acc[mt][q], ahi, blo[q]);
            tf32_scan::mma_tf32(acc[mt][q], ahi, bhi[q]);
          }
        }
      }
    }

    // The cell, then h (rounded to the dtype in bf16, as the next product reads it)
    // into this rank's block of buffer (t+1) % 2.
    float hv[MTW][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gi = mma_scan::sigmoid(acc[mt][0][j]), gf = mma_scan::sigmoid(acc[mt][1][j]);
        const float gg = tanhf(acc[mt][2][j]), go = mma_scan::sigmoid(acc[mt][3][j]);
        c[mt][j] = gf * c[mt][j] + gi * gg;
        hv[mt][j] = go * tanhf(c[mt][j]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = next + hpos + (16 * mt + 8 * half) * LDB;
        *reinterpret_cast<PT*>(htile + off) = P::pack(hv[mt][2 * half], hv[mt][2 * half + 1]);
      }
    }
    if (t + 1 < T_len) {
      // The block's writes, seen by the async proxy that copies them, and by the other
      // warps of this rank at the next step, before its copies to the other ranks.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid < C && tid != (int)rank) {
        const unsigned own = h_off + (unsigned)((next + (int)rank * BLOCK) * (int)sizeof(T));
        const unsigned there = tf32_scan::map_to_rank(base, (unsigned)tid);
        copy_bulk(there + own, base + own, (unsigned)(BLOCK * sizeof(T)), there + next_mbar);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long b = b0 + row0 + 16 * mt + 8 * half;
        if (b < B) {
          const long long o = (b * T_len + t) * H + u;
          P::store(hs + o, hv[mt][2 * half], hv[mt][2 * half + 1]);
          if (cs != nullptr) P::store(cs + o, c[mt][2 * half], c[mt][2 * half + 1]);
        }
      }
  }
  // No block leaves while another may still write to its shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();
}

// static: the flag is this library's, even beside another build of this header in the
// process (a template's local static is otherwise one object process-wide).
template <typename T, int H, int M, int C>
static cudaError_t prepare() {
  static bool done = false;  // per instantiation
  return cluster_scan::allow(scan_wide_kernel<T, H, M, C>, done);
}

template <typename T, int H, int M, int C>
inline cudaLaunchConfig_t config_of(cudaLaunchAttribute* cluster, int tiles, int n_chains,
                                    cudaStream_t stream) {
  return cluster_scan::cluster_config(cluster, tiles, n_chains, C,
                                      (unsigned)Geometry<T, H, M, C>::kThreads,
                                      smem_bytes(H, M, C, sizeof(T)), stream);
}

template <typename T, int H, int M, int C>
int launch_k(const Chains& chains, int n_chains, int B, int T_len, cudaStream_t stream) {
  if constexpr (smem_need(H, M, C, sizeof(T)) > kMaxShared) {
    return (int)cudaErrorInvalidValue;
  } else {
    cudaError_t err = prepare<T, H, M, C>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t config =
        config_of<T, H, M, C>(&cluster, (B + M - 1) / M, n_chains, stream);
    err = cudaLaunchKernelEx(&config, scan_wide_kernel<T, H, M, C>, chains, B, T_len);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

template <typename T, int H, int C>
int launch_c(const Chains& chains, int n_chains, int B, int T_len, int M, cudaStream_t stream) {
  if (M == 16) return launch_k<T, H, 16, C>(chains, n_chains, B, T_len, stream);
  if (M == 32) return launch_k<T, H, 32, C>(chains, n_chains, B, T_len, stream);
  if (M == 64) return launch_k<T, H, 64, C>(chains, n_chains, B, T_len, stream);
  return (int)cudaErrorInvalidValue;
}

// The "wide" path: dtype 0 float32 on clusters of C = 8 or 16 blocks, 1 bfloat16 on 4 or
// 8; tiles of M rows; H = 256, or 384 on the clusters whose W slice fits (f32 16, bf16 8).
inline int launch(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int M,
                  int C, cudaStream_t stream) {
  if (B < 1 || T_len < 1 || !shape_ok(dtype, H, M, C)) return (int)cudaErrorInvalidValue;
  if (H == 384)
    return dtype == 1 ? launch_c<__nv_bfloat16, 384, 8>(chains, n_chains, B, T_len, M, stream)
                      : launch_c<float, 384, 16>(chains, n_chains, B, T_len, M, stream);
  if (dtype == 1)
    return C == 4 ? launch_c<__nv_bfloat16, 256, 4>(chains, n_chains, B, T_len, M, stream)
                  : launch_c<__nv_bfloat16, 256, 8>(chains, n_chains, B, T_len, M, stream);
  return C == 8 ? launch_c<float, 256, 8>(chains, n_chains, B, T_len, M, stream)
                : launch_c<float, 256, 16>(chains, n_chains, B, T_len, M, stream);
}

// How many clusters of C blocks of the kernel at this (H, M, C, dtype) the card holds at
// once (cudaOccupancyMaxActiveClusters), each block on an SM of its own; 0 where no GPC
// has C free SMs.
template <typename T, int H, int M, int C>
int max_clusters_k(int* clusters) {
  if constexpr (smem_need(H, M, C, sizeof(T)) > kMaxShared) {
    return (int)cudaErrorInvalidValue;
  } else {
    cudaError_t err = prepare<T, H, M, C>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t config = config_of<T, H, M, C>(&cluster, 1, 1, nullptr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, scan_wide_kernel<T, H, M, C>, &config);
  }
}

template <typename T, int H, int C>
int max_clusters_c(int M, int* clusters) {
  if (M == 16) return max_clusters_k<T, H, 16, C>(clusters);
  if (M == 32) return max_clusters_k<T, H, 32, C>(clusters);
  return max_clusters_k<T, H, 64, C>(clusters);
}

inline int max_clusters(int H, int M, int C, int dtype, int* clusters) {
  if (!shape_ok(dtype, H, M, C)) return (int)cudaErrorInvalidValue;
  if (H == 384)
    return dtype == 1 ? max_clusters_c<__nv_bfloat16, 384, 8>(M, clusters)
                      : max_clusters_c<float, 384, 16>(M, clusters);
  if (dtype == 1)
    return C == 4 ? max_clusters_c<__nv_bfloat16, 256, 4>(M, clusters)
                  : max_clusters_c<__nv_bfloat16, 256, 8>(M, clusters);
  return C == 8 ? max_clusters_c<float, 256, 8>(M, clusters)
                : max_clusters_c<float, 256, 16>(M, clusters);
}

}  // namespace wide_scan

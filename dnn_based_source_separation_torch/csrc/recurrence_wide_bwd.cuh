// Tensor-core reverse recurrence of the LSTM at H = 256 and 384 for many sequences (Hopper,
// sm_90a): an M-row tile of independent sequences of one chain held by a thread-block cluster.
//
// Included by csrc/lstm_scan_bwd.cu only, after csrc/recurrence_cluster_bwd.cuh (whose
// Chains it takes), and launched there as path 5, "wide" (ops/lstm_scan.py:_plan_bwd picks
// it and the tile (M, C)). ops/_build.py hashes this header into the key of every source.
// For these calls it replaces the backward of the TPU kernels of
// dnn_based_source_separation_tpu/ops/pallas_lstm.py: `_lstm_bwd` (:230) of lstm_scan and
// `_bidir_bwd` (:339) of lstm_scan_bidir, both `_lstm_bwd_core` (:182-227), whose reverse
// `lax.scan` this is.
//
// It computes the FMA backward's function (csrc/lstm_scan_bwd.cu): per chain and sequence,
// walking t from T-1 down to 0 with dh_rec = dc_rec = 0,
//     i, f, g, o from gates[b, t, :] (the f32 pre-activations of one addmm outside)
//     dh = f32(g_hs[t]) + dh_rec;  dc = dc_rec + dh o (1 - tanh(c_t)^2)
//     da = [da_i, da_f, da_g, da_o] -> das[b, t, :] (f32), and d_xw in bfloat16
//     dh_rec = da @ W_hh^T;  dc_rec = dc f
// reading W_hh (H, 4H) in its own dtype. The product runs on the tensor cores as mma.sync
// m16n8k8 TF32 products summed in f32, as csrc/recurrence_bwd_tf32.cuh forms it: in f32
// three (da and W split into hi and lo TF32 values, lo x lo dropped), in bf16 two (a bf16
// W is a TF32 value: lo_da W, hi_da W); da itself is never rounded to bf16.
//
// What bounds it. DPTNet's recipe training (B = 2 x 4 s) runs the backward over 1278
// sequences of 100 steps (intra-chunk, two chains) and 200 of 639 (inter-chunk, two
// chains, or one when causal) at H = 256: 0.134 TFLOP of recurrent product an intra
// launch. The FMA backward gave a tile of R <= 4 sequences a block, which re-read
// W_hh^T (1 MiB in f32) from L2 every step and ran the product at the f32 FMA rate; the
// cluster backward (csrc/recurrence_cluster_bwd.cuh) keeps W on chip but gives a cluster
// of 8 SMs to one sequence, so 200 sequences ran in many waves of mostly serial steps.
// Here W_hh never leaves the chip after the start and the product runs on the tensor
// cores; a step of a tile is the cell derivative of the rank's units, the product (its
// operands read from shared memory, the hi/lo splits) and the exchange of the partial
// sums between the blocks, one after the other. Measured on an H100 at DPTNet's f32 tile
// (PERF.md), the serial floor (all but the product) is about half of a step.
//
// Design (csrc/recurrence_wide.cuh's, in reverse):
//   * a cluster of C blocks, one SM each (at least kOwnSm of shared memory), owns an M-row
//     tile of independent sequences of one chain (blockIdx.x = C tile + rank, blockIdx.y
//     the chain; the second chain arrives reversed in time). Rank r owns hidden units
//     [r H/C, (r+1) H/C): it derives their da from their gates, c and dh alone, so dc_rec
//     stays in registers, and it keeps the forward's slice of W_hh, its units' four gate
//     columns (H x 4H/C), staged once in shared memory as B fragments of W_own^T;
//   * the recurrent product is a reduce-scatter. Each rank multiplies its own columns of
//     da by W_own^T, dh_part = da_own (M x 4H/C) @ W_own^T (4H/C x H), a partial sum for
//     all H units; rank p needs the sum over the ranks of the columns of its units. da
//     goes from the cell's registers into a padded M x 4H/C f32 tile, which ldmatrix reads
//     back as A fragments (rows padded by 16 bytes: distinct banks). The warps split the
//     H output units, H / 8 a warp (H / 64 n8 tiles: four at 256, six at 384), each over all M
//     rows;
//   * the partial sums go into a double-buffered receive tile [2][C][M][H/C + 8] f32, block
//     r of a rank's buffer holding what rank r summed for its units (rows padded by 32
//     bytes, so a warp's 8-byte fragment stores hit distinct banks). The block of the
//     rank's own units goes into its own block of the buffer the next step reads; the
//     block for peer p goes into block p of the buffer this step read, which p's last copy
//     filled and this step's sum has read, and from there, after a block barrier and
//     fence.proxy.async, one cp.async.bulk a peer copies it into block r of p's next
//     buffer, completing its bytes on p's mbarrier of that buffer. Thread 0 arms its
//     mbarrier for the next step's (C - 1) blocks and every thread waits on it. A rank then
//     sums the C blocks in the fixed order of the ranks, so the result does not depend on
//     the order in which the copies arrive and repeats bit for bit. A rank sends H/C values
//     a row to each peer, as the forward does; the cluster backward sends 4H/C;
//   * a block of p's buffer is not rewritten before its last copy has landed: p copies its
//     next blocks only after it has this rank's, which this rank copied after it read what
//     p sent the step before. A block this rank uses to stage a copy is rewritten by p only
//     after p has received it;
//   * the step's gates (the rank's own columns), c_t, c_{t-1} and g_hs stream into
//     registers one step ahead. Each warp of the first (M / 16) (H / 8C) runs the cell of
//     16 rows x 8 units, a thread the m16n8 C-fragment positions of that tile. Rows past B
//     read zeros, which keep every derivative of the row zero, and are never stored.
//   * kProduct = false compiles the product out (the serial floor: the cell, the
//     exchange and the sums of every step), as the cluster kernels do;
//   * the hidden size is a template parameter, as in the forward: H = 256 (DPTNet) and
//     H = 384 (H = 300 zero-padded by the caller). At 384 the W slice is 144 KB at f32
//     C = 16 and bf16 C = 8, which leaves M = 16: f32 3 cell tiles of 16 rows x 8 units
//     (24 units a rank) and 6 n8 output tiles a warp, bf16 6 cell tiles (48 units). A
//     receive row of 24 + 8 floats is 128 bytes in f32, so there a warp's fragment stores
//     to its eight rows share banks (more padding does not fit beside W).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recurrence_cluster.cuh"
#include "recurrence_cluster_bwd.cuh"
#include "recurrence_tf32.cuh"
#include "recurrence_wide.cuh"

namespace wide_bwd {

using Chains = cluster_bwd::Chains;

constexpr int kGates = 4;
constexpr int kWarps = 8;  // H / 8 output units a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPadDa = 4;     // floats after a row of the da tile (ldmatrix: distinct banks)
constexpr int kPadBlock = 8;  // floats after a row of a received block (8-byte stores)
constexpr size_t kMaxShared = 232448;  // a Hopper block's dynamic shared-memory ceiling
constexpr size_t kOwnSm = 120 * 1024;  // no two blocks on one SM

// Shared memory: two mbarriers (16 bytes), the W slice (H x 4 H/C values of `elem` bytes),
// the da tile [M][4 H/C + kPadDa] and the receive tile [2][C][M][H/C + kPadBlock], f32.
__host__ __device__ constexpr size_t w_bytes(int H, int C, size_t elem) {
  return (size_t)H * kGates * (H / C) * elem;
}
__host__ __device__ constexpr size_t block_floats(int H, int M, int C) {
  return (size_t)M * (H / C + kPadBlock);
}
__host__ __device__ constexpr size_t smem_need(int H, int M, int C, size_t elem) {
  return 16 + w_bytes(H, C, elem) + 4 * (size_t)M * (kGates * (H / C) + kPadDa) +
         4 * 2 * (size_t)C * block_floats(H, M, C);
}
__host__ __device__ constexpr size_t smem_bytes(int H, int M, int C, size_t elem) {
  return smem_need(H, M, C, elem) > kOwnSm ? smem_need(H, M, C, elem) : kOwnSm;
}
// The cell's tiles of 16 rows x 8 units, one a warp, and the shared memory within
// kMaxShared.
__host__ __device__ constexpr bool fits(int H, int M, int C, size_t elem) {
  return M / 16 * (H / C / 8) <= kWarps && smem_need(H, M, C, elem) <= kMaxShared;
}

// H = 256 or 384, the cluster sizes of each dtype (bf16: 4 or 8; f32: 8 or 16, 16 a
// non-portable size), M = 16, 32 or 64, and what fits.
inline bool shape_ok(int dtype, int H, int M, int C) {
  const bool sizes = dtype == 1 ? (C == 4 || C == 8) : dtype == 0 && (C == 8 || C == 16);
  return (H == 256 || H == 384) && sizes && (M == 16 || M == 32 || M == 64) &&
         fits(H, M, C, dtype == 1 ? 2 : 4);
}

__device__ __forceinline__ float2 ldg_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg_pair(const __nv_bfloat16* p) {
  const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One step's inputs of a thread's row and two units.
struct StepIn {
  float2 a[kGates];  // gate pre-activations i, f, g, o
  float2 g, c, cp;   // cotangent of h, c_t, c_{t-1} (0 at t = 0)
};

// A thread's cell positions are rows 16 cm + gid + 8 h (h = 0, 1) of the tile and units
// r H/C + 8 cu + 2 tig, + 1 of cell tile (cm, cu) = its warp; its product outputs are the
// m16n8 C fragments of every m16 tile and of n8 tiles NT warp .. NT warp + NT - 1 of the
// H units.
template <typename T, int H, int M, int C, bool kProduct>
__global__ void __launch_bounds__(kThreads, 1)
bwd_wide_kernel(Chains chains, int B, int T_len) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int HU = H / C;
  constexpr int K = kGates * HU;       // this rank's gate columns: the product's K
  constexpr int KS = K / 8;            // its k-steps
  constexpr int MT = M / 16;           // m16 tiles
  constexpr int NTILES = H / 8;        // n8 tiles of the output
  constexpr int NT = NTILES / kWarps;  // of a warp
  constexpr int LDA = K + kPadDa;
  constexpr int LDR = HU + kPadBlock;
  constexpr int BLOCK = M * LDR;       // a received block, floats
  constexpr int NCT = MT * (HU / 8);   // cell tiles
  constexpr long long G4 = (long long)kGates * H;
  static_assert(NCT <= kWarps && HU % 8 == 0 && NTILES % kWarps == 0, "tile");

  // Constant indices: a runtime index into the parameter arrays would copy them to
  // local memory.
  const bool second = blockIdx.y != 0;
  const float* __restrict__ gates = second ? chains.gates[1] : chains.gates[0];
  const T* __restrict__ cs = static_cast<const T*>(second ? chains.cs[1] : chains.cs[0]);
  const T* __restrict__ g_hs = static_cast<const T*>(second ? chains.g_hs[1] : chains.g_hs[0]);
  const T* __restrict__ whh = static_cast<const T*>(second ? chains.whh[1] : chains.whh[0]);
  float* __restrict__ das = second ? chains.das[1] : chains.das[0];
  T* __restrict__ d_xw = static_cast<T*>(second ? chains.d_xw[1] : chains.d_xw[0]);

  extern __shared__ float4 smem_wide_bwd[];
  uint64_t* mbars = reinterpret_cast<uint64_t*>(smem_wide_bwd);  // [2]: a buffer's blocks arrived
  // A lane's B fragment of one n8 tile and k-step: two f32 values, or two bf16 in a word.
  using FT = typename std::conditional<kBf16, unsigned, float2>::type;
  FT* wsm = reinterpret_cast<FT*>(smem_wide_bwd + 1);  // [KS][NTILES][32 lanes]
  float* dtile = reinterpret_cast<float*>(reinterpret_cast<char*>(wsm) + w_bytes(H, C, sizeof(T)));
  float* recv = dtile + M * LDA;  // [2][C][M][LDR]

  const unsigned rank = tf32_scan::cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ubase = (int)rank * HU;
  const long long b0 = (long long)(blockIdx.x / C) * M;

  // W_hh (H, 4H) row-major -> B fragments of W_own^T, whose row k is this rank's gate
  // column q H + ubase + j (k = q H/C + j): element e of lane l's fragment (k-step ks,
  // n8 tile nt) is W_own^T[8 ks + l % 4 + 4 e][8 nt + l / 4], that is
  // W_hh[8 nt + l / 4][column of k = 8 ks + l % 4 + 4 e] (bf16: e = 0 in the low half).
  for (int i = tid; i < KS * NTILES * 32; i += kThreads) {
    const int l = i & 31, nt = (i >> 5) % NTILES, ks = (i >> 5) / NTILES;
    const long long row = (long long)(8 * nt + (l >> 2)) * G4;
    const int k0 = 8 * ks + (l & 3), k1 = k0 + 4;
    const long long c0 = (long long)(k0 / HU) * H + ubase + k0 % HU;
    const long long c1 = (long long)(k1 / HU) * H + ubase + k1 % HU;
    if constexpr (kBf16) {
      const unsigned short* w16 = reinterpret_cast<const unsigned short*>(whh);
      wsm[i] = (unsigned)__ldg(w16 + row + c0) | ((unsigned)__ldg(w16 + row + c1) << 16);
    } else {
      wsm[i] = make_float2(__ldg(whh + row + c0), __ldg(whh + row + c1));
    }
  }
  const unsigned mbar = tf32_scan::smem_addr(mbars);
  if (tid == 0) {
    cluster_scan::mbar_init(mbar);
    cluster_scan::mbar_init(mbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The cell's tile of this warp: rows 16 cm + gid (+ 8), units j and j + 1 of the rank.
  const bool cell = warp < NCT;
  const int cm = warp / (HU / 8), cu = warp % (HU / 8);
  const int row0 = 16 * cm + gid;
  const int j = 8 * cu + 2 * tig;
  const int u = ubase + j;
  auto load = [&](StepIn (&in)[2], int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long b = b0 + row0 + 8 * h;
      if (b < B) {
        const float* g = gates + (b * T_len + t) * G4 + u;
#pragma unroll
        for (int q = 0; q < kGates; ++q) in[h].a[q] = ldg_pair(g + q * H);
        const long long at = (b * T_len + t) * H + u;
        in[h].g = ldg_pair(g_hs + at);
        in[h].c = ldg_pair(cs + at);
        in[h].cp = t > 0 ? ldg_pair(cs + at - H) : make_float2(0.f, 0.f);
      } else {
#pragma unroll
        for (int q = 0; q < kGates; ++q) in[h].a[q] = make_float2(0.f, 0.f);
        in[h].g = in[h].c = in[h].cp = make_float2(0.f, 0.f);
      }
    }
  };
  StepIn nxt[2];
  if (cell) load(nxt, T_len - 1);
  float2 dc_rec[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};

  // This block's shared memory; the other ranks' have the same layout.
  const unsigned base = tf32_scan::smem_addr(smem_wide_bwd);
  const unsigned recv_off = tf32_scan::smem_addr(recv) - base;
  // ldmatrix's row of this lane in an m16 x k8 A tile and its column.
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int acol = 4 * (lane >> 4);
  const float* afrag = dtile + arow * LDA + acol;
  const FT* bfrag = wsm + NT * warp * 32 + lane;

  // W staged and the mbarriers set up in every block, and every block running, before
  // any copy into another's shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();

  // Step s (t = T - 1 - s) sums the blocks of buffer s % 2 (the partial sums of da of
  // step s - 1), derives da and sends its partial sums into buffer (s + 1) % 2.
#pragma unroll 1
  for (int s = 0; s < T_len; ++s) {
    const int t = T_len - 1 - s;
    const int cur = s & 1, next = (s + 1) & 1;
    constexpr unsigned kBytes = (unsigned)((C - 1) * BLOCK * sizeof(float));
    if (tid == 0 && s + 1 < T_len) cluster_scan::mbar_expect(mbar + 8u * next, kBytes);
    if (s > 0) cluster_scan::mbar_wait(mbar + 8u * cur, (unsigned)((s - 1) >> 1) & 1u);

    if (cell) {
      StepIn in[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) in[h] = nxt[h];
      if (t > 0) load(nxt, t - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        float2 dh_rec = make_float2(0.f, 0.f);
        if (s > 0) {  // the C blocks, in the order of the ranks
          const float* blk = recv + cur * C * BLOCK + row * LDR + j;
#pragma unroll
          for (int r = 0; r < C; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(blk + r * BLOCK);
            dh_rec.x += v.x;
            dh_rec.y += v.y;
          }
        }
        float d[kGates][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gi = cluster_scan::sigmoid(e ? in[h].a[0].y : in[h].a[0].x);
          const float gf = cluster_scan::sigmoid(e ? in[h].a[1].y : in[h].a[1].x);
          const float gg = tanhf(e ? in[h].a[2].y : in[h].a[2].x);
          const float go = cluster_scan::sigmoid(e ? in[h].a[3].y : in[h].a[3].x);
          const float tc = tanhf(e ? in[h].c.y : in[h].c.x);
          const float cp = e ? in[h].cp.y : in[h].cp.x;
          const float dh = (e ? in[h].g.y : in[h].g.x) + (e ? dh_rec.y : dh_rec.x);
          const float dc = (e ? dc_rec[h].y : dc_rec[h].x) + dh * go * (1.f - tc * tc);
          d[0][e] = dc * gg * gi * (1.f - gi);
          d[1][e] = dc * cp * gf * (1.f - gf);
          d[2][e] = dc * gi * (1.f - gg * gg);
          d[3][e] = dh * tc * go * (1.f - go);
          if (e) dc_rec[h].y = dc * gf; else dc_rec[h].x = dc * gf;
        }
        const long long b = b0 + row;
#pragma unroll
        for (int q = 0; q < kGates; ++q) {
          const float2 v = make_float2(d[q][0], d[q][1]);
          *reinterpret_cast<float2*>(dtile + row * LDA + q * HU + j) = v;
          if (b < B) {
            const long long at = (b * T_len + t) * G4 + q * H + u;
            *reinterpret_cast<float2*>(das + at) = v;
            if constexpr (kBf16) store_pair(d_xw + at, v.x, v.y);
          }
        }
      }
    }
    if (s + 1 == T_len) break;
    // da in the tile for every warp, and buffer `cur` read, before the product.
    __syncthreads();

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
    if constexpr (kProduct) {
      // Unrolled so that one k-step's loads and splits overlap another's products.
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        unsigned bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const FT w = bfrag[(ks * NTILES + n) * 32];
          if constexpr (kBf16) {
            bhi[n][0] = w << 16;
            bhi[n][1] = w & 0xffff0000u;
          } else {
            tf32_scan::split(w.x, bhi[n][0], blo[n][0]);
            tf32_scan::split(w.y, bhi[n][1], blo[n][1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned a[4], ahi[4], alo[4];
          tf32_scan::ldmatrix_x4(a, afrag + 16 * mt * LDA + 8 * ks);
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_scan::split(__uint_as_float(a[i]), ahi[i], alo[i]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            tf32_scan::mma_tf32(acc[mt][n], alo, bhi[n]);
            if constexpr (!kBf16) tf32_scan::mma_tf32(acc[mt][n], ahi, blo[n]);
            tf32_scan::mma_tf32(acc[mt][n], ahi, bhi[n]);
          }
        }
      }
    }

    // Each n8 tile's units belong to one rank p: its block goes into block p of buffer
    // `next` where p is this rank, else into block p of buffer `cur`, to be copied.
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int unit = 8 * (NT * warp + n);
      const int p = unit / HU;
      float* blk = recv + ((p == (int)rank ? next : cur) * C + p) * BLOCK + unit % HU + 2 * tig;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(blk + (16 * mt + gid + 8 * half) * LDR) =
              make_float2(acc[mt][n][2 * half], acc[mt][n][2 * half + 1]);
    }
    // The blocks written, seen by the async proxy that copies them, and by the other
    // warps at the next step.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid < C && tid != (int)rank) {
      const unsigned there = tf32_scan::map_to_rank(base, (unsigned)tid);
      const unsigned src = recv_off + (unsigned)((cur * C + tid) * BLOCK * sizeof(float));
      const unsigned dst = recv_off + (unsigned)((next * C + (int)rank) * BLOCK * sizeof(float));
      wide_scan::copy_bulk(there + dst, base + src, (unsigned)(BLOCK * sizeof(float)),
                           there + 8u * next);
    }
  }
  // No block leaves while another may still copy into its shared memory.
  tf32_scan::cluster_arrive();
  tf32_scan::cluster_wait();
}

// static: the flag is this library's, even beside another build of this header in the
// process (a template's local static is otherwise one object process-wide).
template <typename T, int H, int M, int C, bool kProduct>
static cudaError_t prepare() {
  static bool done = false;  // per instantiation
  return cluster_scan::allow(bwd_wide_kernel<T, H, M, C, kProduct>, done);
}

template <typename T, int H, int M, int C>
inline cudaLaunchConfig_t config_of(cudaLaunchAttribute* cluster, int tiles, int n_chains,
                                    cudaStream_t stream) {
  return cluster_scan::cluster_config(cluster, tiles, n_chains, C, (unsigned)kThreads,
                                      smem_bytes(H, M, C, sizeof(T)), stream);
}

template <typename T, int H, int M, int C, bool kProduct>
int launch_k(const Chains& chains, int n_chains, int B, int T_len, cudaStream_t stream) {
  if constexpr (!fits(H, M, C, sizeof(T))) {
    return (int)cudaErrorInvalidValue;
  } else {
    cudaError_t err = prepare<T, H, M, C, kProduct>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t config =
        config_of<T, H, M, C>(&cluster, (B + M - 1) / M, n_chains, stream);
    err = cudaLaunchKernelEx(&config, bwd_wide_kernel<T, H, M, C, kProduct>, chains, B, T_len);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

template <typename T, int H, int C, bool kProduct>
int launch_c(const Chains& chains, int n_chains, int B, int T_len, int M, cudaStream_t stream) {
  if (M == 16) return launch_k<T, H, 16, C, kProduct>(chains, n_chains, B, T_len, stream);
  if (M == 32) return launch_k<T, H, 32, C, kProduct>(chains, n_chains, B, T_len, stream);
  if (M == 64) return launch_k<T, H, 64, C, kProduct>(chains, n_chains, B, T_len, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kProduct>
int launch_p(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int M,
             int C, cudaStream_t stream) {
  if (H == 384)
    return dtype == 1
               ? launch_c<__nv_bfloat16, 384, 8, kProduct>(chains, n_chains, B, T_len, M, stream)
               : launch_c<float, 384, 16, kProduct>(chains, n_chains, B, T_len, M, stream);
  if (dtype == 1)
    return C == 4
               ? launch_c<__nv_bfloat16, 256, 4, kProduct>(chains, n_chains, B, T_len, M, stream)
               : launch_c<__nv_bfloat16, 256, 8, kProduct>(chains, n_chains, B, T_len, M, stream);
  return C == 8 ? launch_c<float, 256, 8, kProduct>(chains, n_chains, B, T_len, M, stream)
                : launch_c<float, 256, 16, kProduct>(chains, n_chains, B, T_len, M, stream);
}

// The "wide" backward: dtype 0 float32 on clusters of C = 8 or 16 blocks, 1 bfloat16 on 4
// or 8; tiles of M rows; H = 256, or 384 on the clusters whose W slice fits (f32 16, bf16
// 8). `product` false launches the serial floor.
inline int launch(const Chains& chains, int n_chains, int dtype, int B, int T_len, int H, int M,
                  int C, bool product, cudaStream_t stream) {
  if (B < 1 || T_len < 1 || !shape_ok(dtype, H, M, C)) return (int)cudaErrorInvalidValue;
  return product ? launch_p<true>(chains, n_chains, dtype, B, T_len, H, M, C, stream)
                 : launch_p<false>(chains, n_chains, dtype, B, T_len, H, M, C, stream);
}

// How many clusters of C blocks of the kernel at this (H, M, C, dtype) the card holds at
// once (cudaOccupancyMaxActiveClusters), each block on an SM of its own; 0 where no GPC
// has C free SMs.
template <typename T, int H, int M, int C>
int max_clusters_k(int* clusters) {
  if constexpr (!fits(H, M, C, sizeof(T))) {
    return (int)cudaErrorInvalidValue;
  } else {
    cudaError_t err = prepare<T, H, M, C, true>();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t config = config_of<T, H, M, C>(&cluster, 1, 1, nullptr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, bwd_wide_kernel<T, H, M, C, true>,
                                               &config);
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

}  // namespace wide_bwd

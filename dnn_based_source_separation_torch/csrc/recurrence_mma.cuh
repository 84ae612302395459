// Tensor-core forward of the bf16 LSTM and GRU recurrences (Hopper, sm_90a).
//
// Included by csrc/lstm_scan.cu and csrc/gru_scan.cu, which define the cell
// (LstmCell, GruCell) and launch this kernel for bf16 inputs with H a
// multiple of 16 up to 128 (the wrappers' `_plan` picks the path and the
// tile). Every other call keeps those files' FMA kernel. ops/_build.py
// hashes this header into the key of every source, so an edit rebuilds both.
//
// It computes the FMA kernels' function: per step the gates are
// f32(xw[t]) + f32(h rounded to bf16) @ f32(W_hh), h (or c) carried in f32,
// hs (and cs) written rounded to bf16. mma.sync m16n8k16 bf16 x bf16 -> f32
// forms each product of two bf16 values exactly and sums in f32, in its own
// order; the results differ from the FMA kernel's by that summation order and
// by the sigmoid's approximate division (below), both far under a bf16 ulp.
//
// What bounds it. A step of a chain depends on the step before, so time is
// a loop inside the block and only independent sequences run in parallel.
// At the serving shapes (about 4,000 sequences over two chains, H = 128) the
// device-memory bound (xw read, hs written once, 0.39 ms for the LSTM) is
// about three times the tensor-core time. Measured on an H100, neither
// binds: an m16 tile's step costs about the same with one block per chain
// (B = 3) as with a block on every SM, so a step is bound by the issue of
// the cell update (3 sigmoids and 2 tanhs a unit in the LSTM, 4 units a
// thread per m16 tile) behind its chain of 8 dependent mma, once per tile.
//
// Design:
//   * a block owns an M-row tile (M = 16 or 32) of independent sequences of
//     one chain; blockIdx.y is the chain. It has H / 8 warps, and warp w owns
//     hidden units 8w .. 8w + 7 and computes every gate of them: its n8 tiles
//     are the G gate columns of those units. An mma C fragment holds the same
//     (row, unit) positions in the same thread for every n8 tile, so the cell
//     update runs in registers with no exchange, and the carried state (c,
//     or the GRU's f32 h) never leaves them;
//   * W_hh lives in registers as mma B fragments for the whole loop:
//     H / 16 k-steps x G gates x 2 registers (64 a thread for the LSTM at
//     H = 128, where the block has 512 threads and 128 registers each). It is
//     staged once through shared memory (the ring's space, before the ring
//     is used) and read into fragments with ldmatrix.trans: loading the bf16
//     pairs of a fragment straight from device memory kept 128 loads in
//     flight and spilled at H = 128;
//   * the step's h, rounded to bf16, goes into a double-buffered M x H tile
//     in shared memory, rows padded by 16 bytes so that ldmatrix and the
//     4-byte writes hit distinct banks. The next step loads its A fragments
//     from it with ldmatrix. One __syncthreads() a step;
//   * the same tile is the step's hs rows: during the next step the block
//     copies it to device memory with 16-byte stores (a row of one step is
//     2H contiguous bytes). cs, when asked for, goes through a second tile;
//   * xw streams in with cp.async through a ring of kStages steps in shared
//     memory (rows padded by 16 bytes), kStages - 1 steps ahead; each thread
//     starts its accumulators from its gate values there. Rows past B are
//     zero-filled and never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_scan {

using bf16 = __nv_bfloat16;

constexpr int kStages = 4;  // xw steps in flight in shared memory
static_assert((kStages & (kStages - 1)) == 0, "kStages must be a power of two");

struct Chains {
  const bf16* xw[2];
  const bf16* whh[2];
  const bf16* bhh[2];  // GRU; null for the LSTM
  bf16* hs[2];
  bf16* cs[2];         // LSTM training; else null
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A fragment of a 16 x 16 bf16 tile, each lane giving one row address.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// B fragments of row-major [k][n] bf16 tiles: four (x4) or two (x2) 8 x 8
// matrices, transposed, so a thread holds k = 2 tig, 2 tig + 1 at n = gid.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row) @ b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A bf16 pair in a 32-bit word (lower address in the low half) as f32: exact.
__device__ __forceinline__ float low_f32(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high_f32(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The cells' sigmoid, 1 / (1 + e^-x), divides with div.approx (within 2 ulp
// of IEEE division; 1 / inf is 0): the cell update, not the product or the
// bytes, bounds a step, and IEEE division's longer sequence made the kernel
// about a quarter slower on the card (PERF.md). That is the only departure
// from the FMA kernels' arithmetic besides the tensor cores' summation order.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

// Cell: kGates; kBias (b_hh read); kCellState (the state is written as cs);
// start(acc, x, bias) sets the accumulators before the product; update(acc,
// x, j, state) finishes fragment position j and returns its new h.
// Fragment position j of an m16 tile is row gid + 8 * (j >> 1) and unit
// 8 * warp + 2 * tig + (j & 1), with gid = lane / 4 and tig = lane % 4.
template <class Cell, int H, int M>
__global__ void __launch_bounds__(4 * H, 1)
scan_mma_kernel(Chains chains, int B, int T_len) {
  constexpr int G = Cell::kGates;
  constexpr int kThreads = 4 * H;  // H / 8 warps
  constexpr int KS = H / 16;       // k-steps of the product
  constexpr int MT = M / 16;       // m16 tiles of the block
  constexpr int LDX = G * H + 8;   // ring row, bf16, padded by 16 bytes
  constexpr int LDH = H + 8;       // h / c tile row, bf16, padded by 16 bytes
  constexpr int XCH = G * H / 8;   // 16-byte chunks of an xw row
  constexpr int HCH = H / 8;       // 16-byte chunks of an hs row

  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const bf16* __restrict__ xw = second ? chains.xw[1] : chains.xw[0];
  const bf16* __restrict__ whh = second ? chains.whh[1] : chains.whh[0];
  const bf16* __restrict__ bhh = second ? chains.bhh[1] : chains.bhh[0];
  bf16* __restrict__ hs = second ? chains.hs[1] : chains.hs[0];
  bf16* __restrict__ cs = second ? chains.cs[1] : chains.cs[0];

  extern __shared__ uint4 smem_mma[];
  bf16* ring = reinterpret_cast<bf16*>(smem_mma);  // [kStages][M][LDX]; first W_hh
  bf16* htile = ring + kStages * M * LDX;          // [2][M][LDH]
  bf16* ctile = htile + 2 * M * LDH;               // [2][M][LDH], Cell::kCellState only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int u = 8 * warp + 2 * tig;  // this thread's units u and u + 1
  const long long b0 = (long long)blockIdx.x * M;
  const long long seq_x = (long long)T_len * G * H;  // xw elements of one sequence

  auto load_step = [&](int t) {
    bf16* dst = ring + (t & (kStages - 1)) * M * LDX;
#pragma unroll 1
    for (int i = tid; i < M * XCH; i += kThreads) {
      const int r = i / XCH, ch = i - r * XCH;
      const bool in = b0 + r < B;
      const bf16* src = in ? xw + (b0 + r) * seq_x + (long long)t * G * H + ch * 8 : xw;
      cp_async16(dst + r * LDX + ch * 8, src, in);
    }
  };
  auto store_step = [&](const bf16* tile, bf16* out, int t) {
#pragma unroll 1
    for (int i = tid; i < M * HCH; i += kThreads) {
      const int r = i / HCH, ch = i - r * HCH;
      if (b0 + r < B)
        *reinterpret_cast<uint4*>(out + ((b0 + r) * T_len + t) * H + ch * 8) =
            *reinterpret_cast<const uint4*>(tile + r * LDH + ch * 8);
    }
  };

  // W_hh (H, G*H) row-major, staged through shared memory into B fragments:
  // register `half` of k-step kk, gate q holds rows k, k + 1 (k = 16 kk +
  // 2 tig + 8 half) of column q H + 8 warp + gid, the lower row in the low
  // half. An x4 load takes gates q and q + 1 (lanes 16-31 point at q + 1).
  {
    const uint4* src = reinterpret_cast<const uint4*>(whh);
    uint4* dst = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < H * G * H / 8; i += kThreads) dst[i] = __ldg(src + i);
  }
  __syncthreads();
  unsigned wf[KS][G][2];
  {
    const bf16* wrow = ring + ((lane & 7) + 8 * ((lane >> 3) & 1)) * (G * H) + 8 * warp;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int q = 0; q + 1 < G; q += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, wrow + 16 * kk * (G * H) + (q + (lane >> 4)) * H);
        wf[kk][q][0] = r[0];
        wf[kk][q][1] = r[1];
        wf[kk][q + 1][0] = r[2];
        wf[kk][q + 1][1] = r[3];
      }
      if constexpr (G % 2 == 1) {
        unsigned r[2];
        ldmatrix_x2_trans(r, wrow + 16 * kk * (G * H) + (G - 1) * H);
        wf[kk][G - 1][0] = r[0];
        wf[kk][G - 1][1] = r[1];
      }
    }
  }
  __syncthreads();  // the staging space becomes the ring

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T_len) load_step(s);
    cp_async_commit();
  }
  float bias[G][2];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias[q][e] = Cell::kBias ? __bfloat162float(bhh[q * H + u + e]) : 0.f;

  {  // h = 0 before step 0
    unsigned* h0 = reinterpret_cast<unsigned*>(htile);
    for (int i = tid; i < M * LDH / 2; i += kThreads) h0[i] = 0u;
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // The carried state of the thread's positions in the m16 tile in hand
  // (cur) and in the other one (other, when M = 32). The tiles run one after
  // the other in a loop that is not unrolled, swapping the two, so the
  // scheduler cannot overlap them: overlapped, their registers spilled.
  float cur[4] = {0.f, 0.f, 0.f, 0.f}, other[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll 1
  for (int t = 0; t < T_len; ++t) {
    // The ring slot of step t + kStages - 1 was read in step t - 1, before
    // the barrier that ended it.
    if (t + kStages - 1 < T_len) load_step(t + kStages - 1);
    cp_async_commit();
    const bf16* hcur = htile + (t & 1) * M * LDH;  // h of step t - 1
    bf16* hnext = htile + ((t + 1) & 1) * M * LDH;
    bf16* cnext = ctile + ((t + 1) & 1) * M * LDH;
    if (t > 0) {
      store_step(hcur, hs, t - 1);
      if (Cell::kCellState && cs != nullptr) store_step(ctile + (t & 1) * M * LDH, cs, t - 1);
    }
    const bf16* x = ring + (t & (kStages - 1)) * M * LDX;
#pragma unroll 1
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = 16 * mt + gid;  // this thread's rows r0 and r0 + 8
      float xv[G][4], acc[G][4];
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned v =
              *reinterpret_cast<const unsigned*>(x + (r0 + 8 * half) * LDX + q * H + u);
          xv[q][2 * half] = low_f32(v);
          xv[q][2 * half + 1] = high_f32(v);
        }
      Cell::start(acc, xv, bias);
      const bf16* arow = hcur + (16 * mt + (lane & 15)) * LDH + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, arow + 16 * kk);
#pragma unroll
        for (int q = 0; q < G; ++q) mma_bf16(acc[q], a, wf[kk][q][0], wf[kk][q][1]);
      }
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = Cell::update(acc, xv, j, cur[j]);
      *reinterpret_cast<unsigned*>(hnext + r0 * LDH + u) = pack_bf16(hv[0], hv[1]);
      *reinterpret_cast<unsigned*>(hnext + (r0 + 8) * LDH + u) = pack_bf16(hv[2], hv[3]);
      if (Cell::kCellState && cs != nullptr) {
        *reinterpret_cast<unsigned*>(cnext + r0 * LDH + u) = pack_bf16(cur[0], cur[1]);
        *reinterpret_cast<unsigned*>(cnext + (r0 + 8) * LDH + u) = pack_bf16(cur[2], cur[3]);
      }
      if constexpr (MT == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float keep = cur[j];
          cur[j] = other[j];
          other[j] = keep;
        }
      }
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of step t + 1 have landed
    __syncthreads();
  }
  store_step(htile + (T_len & 1) * M * LDH, hs, T_len - 1);
  if (Cell::kCellState && cs != nullptr) store_step(ctile + (T_len & 1) * M * LDH, cs, T_len - 1);
}

template <class Cell, int H, int M>
int launch_hm(const Chains& chains, int n_chains, int B, int T_len, cudaStream_t stream) {
  constexpr int G = Cell::kGates;
  constexpr size_t loop = sizeof(bf16) * ((size_t)kStages * M * (G * H + 8) +
                                          (size_t)(Cell::kCellState ? 4 : 2) * M * (H + 8));
  constexpr size_t staged_w = sizeof(bf16) * (size_t)H * G * H;  // before the loop, over it
  constexpr size_t smem = loop > staged_w ? loop : staged_w;
  auto kernel = scan_mma_kernel<Cell, H, M>;
  static bool opted_in = false;  // per instantiation
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)((B + M - 1) / M), (unsigned)n_chains);
  kernel<<<grid, 4 * H, smem, stream>>>(chains, B, T_len);
  return (int)cudaGetLastError();
}

template <class Cell, int M>
int launch_m(const Chains& chains, int n_chains, int B, int T_len, int H, cudaStream_t stream) {
  switch (H) {
    case 16: return launch_hm<Cell, 16, M>(chains, n_chains, B, T_len, stream);
    case 32: return launch_hm<Cell, 32, M>(chains, n_chains, B, T_len, stream);
    case 48: return launch_hm<Cell, 48, M>(chains, n_chains, B, T_len, stream);
    case 64: return launch_hm<Cell, 64, M>(chains, n_chains, B, T_len, stream);
    case 80: return launch_hm<Cell, 80, M>(chains, n_chains, B, T_len, stream);
    case 96: return launch_hm<Cell, 96, M>(chains, n_chains, B, T_len, stream);
    case 112: return launch_hm<Cell, 112, M>(chains, n_chains, B, T_len, stream);
    case 128: return launch_hm<Cell, 128, M>(chains, n_chains, B, T_len, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core path for H in {16, 32, ..., 128} and M in {16, 32}.
template <class Cell>
int launch(const Chains& chains, int n_chains, int B, int T_len, int H, int M,
           cudaStream_t stream) {
  if (B < 1 || T_len < 1) return (int)cudaErrorInvalidValue;
  if (M == 16) return launch_m<Cell, 16>(chains, n_chains, B, T_len, H, stream);
  if (M == 32) return launch_m<Cell, 32>(chains, n_chains, B, T_len, H, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma_scan

// Tensor-core forward of the f32 LSTM and GRU recurrences in 3xTF32 (Hopper, sm_90a).
//
// Included by csrc/lstm_scan.cu and csrc/gru_scan.cu after
// csrc/recurrence_mma.cuh; they define the cell (LstmCell, GruCell, shared
// with the bf16 tensor-core path) and launch this kernel for float32 inputs
// with H a multiple of 16 up to 128 (the wrappers' `_plan` picks the path, the
// tile and the cluster). ops/_build.py hashes this header into the key of
// every source.
//
// It computes the FMA kernels' f32 function: per step the gates are
// f32(xw[t]) + h @ W_hh (GRU: g = h @ W_hh + b_hh, n = tanh(x_n + r * g_n)),
// h (or c) carried in f32, hs (and cs) written in f32. Each f32 product is
// formed as three TF32 products on mma.sync m16n8k8: every operand x splits
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32), and the
// accumulator takes lo_h * hi_W, then hi_h * lo_W, then hi_h * hi_W per
// k-step. The term dropped, lo_h * lo_W, is about 2^-22 of the product, so
// the sums keep f32's accuracy; one TF32 product alone keeps about three
// decimal digits, and its error grows through the recurrence past the f32
// limit (tests/test_torch_tf32x3.py emulates both on the CPU). The cells'
// sigmoid divides with div.approx, as on the bf16 path (2 ulp).
//
// What bounds it. A step of a chain depends on the step before, so time is a
// loop inside the block and only independent sequences run in parallel. At
// the intra serving shape (2 chains x 2040 sequences, 250 steps, H = 128)
// the three TF32 products are 3 x 134 GFLOP: 0.81 ms at the tensor cores'
// 495 TFLOP/s, against 0.78 ms for the bytes (xw read, hs written). Measured
// on an H100 (PERF.md, variants timed in one run), a step at M = 64 is the
// product on mma.sync and its splits (about 40%), then the cell update
// (about half), then the cluster barrier (under a tenth): the tensor cores
// idle while the cells run.
//
// Design:
//   * a cluster of C blocks (C = 2 or 4) owns an M-row tile (M = 16, 32 or
//     64) of independent sequences of one chain (blockIdx.x = C tile + rank,
//     blockIdx.y is the chain). Rank r owns hidden units [r H/C, (r+1) H/C)
//     and every gate of them: its H / 8C warps own 8 units each, and a
//     warp's n8 tiles are the G gate columns of its units, so the cell update
//     runs in registers with no exchange, as on the bf16 path (the m16n8k8
//     C fragment has m16n8k16's layout). The caller's plan takes C = 2 where
//     the tiles fill the card (at M = 64, 64 clusters at the intra serving
//     shape); C = 4 spreads a small grid (a streamed hop's three chunks a
//     chain) over twice the SMs, each with half of a step's work: 15-19% faster
//     there on an H100, where 8-block clusters were slower than 4-block
//     ones (the barrier and the remote writes grow with C). Every block
//     takes an SM of its own (kOwnSm);
//   * W_hh stays in shared memory for the whole loop, never read from device
//     memory or L2 after the start: each block stages its H x G H/C f32
//     slice once (at C = 2 and H = 128, 128 KB for the LSTM and 96 KB for the
//     GRU), in fragment order, so a lane reads its two values of a B fragment
//     with one conflict-free 8-byte load. It is split into hi and lo at each
//     use: a pre-split second copy does not fit beside the LSTM's slice;
//   * h goes into a double-buffered M x H f32 tile in shared memory, rows
//     padded by 16 bytes so that ldmatrix (which loads the tf32 A fragments
//     as pairs of b16) hits distinct banks. Each block writes its M x H/C
//     columns into its own tile and into every other block's through
//     distributed shared memory (mapa), then one cluster barrier a step
//     publishes them (barrier.cluster arrive has release, wait acquire
//     semantics). Between the arrive and the wait the block stores its hs
//     (and cs) columns;
//   * xw streams straight into registers one step ahead: each thread loads
//     the 8-byte pairs of its C fragment positions of step t + 1 while the
//     tensor cores run step t. Rows past B read zeros and are never stored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32_scan {

constexpr int kMaxHidden = 128;
constexpr int kMaxThreads = 2 * kMaxHidden;  // H / 8C warps, C >= 2

struct Chains {
  const float* xw[2];
  const float* whh[2];
  const float* bhh[2];  // GRU; null for the LSTM
  float* hs[2];
  float* cs[2];         // LSTM training; else null
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_to_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster_f32x2(unsigned addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}
// Not the .aligned forms: the wait follows the hs stores of the rows below B,
// a branch that splits a warp where B is not a multiple of 16, and an
// .aligned barrier that a split warp reaches is undefined.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Four 8 x 4 f32 matrices, each lane giving one 16-byte row address: lane
// gets word (lane % 4) of row (lane / 4) of each, the m16n8k8 tf32 A layout.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The nearest TF32 value, ties away from zero, in an f32 bit pattern: what
// cvt.rna.tf32.f32 gives, as two integer operations (half an ulp of the
// 10-bit mantissa added to the magnitude, the low 13 bits cut). On the H100
// the cvt made the kernel 12-20% slower (PERF.md).
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + (under 2^-22 |x|), hi and lo TF32 values in f32 bit patterns.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) @ b (8 x 8, col); tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The shared memory of a block: its W_hh slice and the two h tiles, but at
// least kOwnSm, so that no two blocks share an SM: a step's latency bounds
// the kernel, and a second block on the SM would lengthen every step of both.
constexpr size_t kOwnSm = 120 * 1024;

template <class Cell>
__host__ __device__ constexpr size_t smem_bytes(int H, int M, int C) {
  const size_t need =
      sizeof(float) * ((size_t)H * Cell::kGates * (H / C) + 2 * (size_t)M * (H + 4));
  return need > kOwnSm ? need : kOwnSm;
}

// Cell: as in csrc/recurrence_mma.cuh. Fragment position j of an m16 tile is
// row gid + 8 * (j >> 1) and unit r H/C + 8 * warp + 2 * tig + (j & 1).
template <class Cell, int M, int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
scan_tf32_kernel(Chains chains, int B, int T_len, int H) {
  constexpr int G = Cell::kGates;
  constexpr int MT = M / 16;  // m16 tiles of the block
  const int HU = H / C;       // units of this block
  const int LDH = H + 4;      // h tile row, f32, padded by 16 bytes
  const int KS = H / 8;       // k-steps of the product
  const int warps = HU / 8;
  const long long GH = (long long)G * H;

  // Constant indices: a runtime index into the parameter arrays would copy
  // them to local memory.
  const bool second = blockIdx.y != 0;
  const float* __restrict__ xw = second ? chains.xw[1] : chains.xw[0];
  const float* __restrict__ whh = second ? chains.whh[1] : chains.whh[0];
  const float* __restrict__ bhh = second ? chains.bhh[1] : chains.bhh[0];
  float* __restrict__ hs = second ? chains.hs[1] : chains.hs[0];
  float* __restrict__ cs = second ? chains.cs[1] : chains.cs[0];

  extern __shared__ float4 smem_tf32[];
  float* wsm = reinterpret_cast<float*>(smem_tf32);  // [KS][warps][G][32 lanes][2]
  float* htile = wsm + (size_t)H * G * HU;           // [2][M][LDH]

  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ubase = (int)rank * HU;
  const int u = ubase + 8 * warp + 2 * tig;  // this thread's units u and u + 1
  const long long b0 = (long long)(blockIdx.x / C) * M;

  // W_hh (H, G*H) row-major -> this block's B fragments: element e of lane
  // l's fragment (k-step ks, warp w, gate q) is row 8 ks + l % 4 + 4 e of
  // column q H + ubase + 8 w + l / 4.
  for (int i = tid; i < H * G * HU; i += blockDim.x) {
    const int e = i & 1, l = (i >> 1) & 31;
    int rest = i >> 6;
    const int q = rest % G;
    rest /= G;
    const int w = rest % warps, ks = rest / warps;
    wsm[i] = __ldg(whh + (long long)(8 * ks + (l & 3) + 4 * e) * GH + q * H + ubase + 8 * w +
                   (l >> 2));
  }
  for (int i = tid; i < M * LDH; i += blockDim.x) htile[i] = 0.f;  // h = 0 before step 0

  float bias[G][2];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[q][e] = Cell::kBias ? __ldg(bhh + q * H + u + e) : 0.f;

  // The xw pairs of this thread's fragment positions at step t.
  auto load_x = [&](float (&x)[MT][G][4], int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long b = b0 + 16 * mt + gid + 8 * half;
        const float* row = xw + (b * T_len + t) * GH + u;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const float2 v = b < B ? __ldg(reinterpret_cast<const float2*>(row + q * H))
                                 : make_float2(0.f, 0.f);
          x[mt][q][2 * half] = v.x;
          x[mt][q][2 * half + 1] = v.y;
        }
      }
  };
  float xn[MT][G][4];
  load_x(xn, 0);

  // The h tile of every other block of the cluster: the same offsets there.
  unsigned peer_htile[C - 1];
#pragma unroll
  for (int p = 0; p < C - 1; ++p)
    peer_htile[p] = map_to_rank(smem_addr(htile), (rank + 1 + p) % C);
  const float2* wfrag = reinterpret_cast<const float2*>(wsm) + warp * G * 32 + lane;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix row of this lane
  const int acol = 4 * (lane >> 4);                     // and its column

  float state[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) state[mt][j] = 0.f;

  // W staged and h zeroed in every block, and every block running, before
  // any write to another's shared memory.
  cluster_arrive();
  cluster_wait();

#pragma unroll 1
  for (int t = 0; t < T_len; ++t) {
    const float* hcur = htile + (t & 1) * M * LDH;  // h of step t - 1
    const int next = ((t + 1) & 1) * M * LDH;
    float acc[MT][G][4], xv[MT][G][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[mt][q][j] = xn[mt][q][j];
      Cell::start(acc[mt], xv[mt], bias);
    }
    if (t + 1 < T_len) load_x(xn, t + 1);

#pragma unroll 1
    for (int ks = 0; ks < KS; ++ks) {
      unsigned bhi[G][2], blo[G][2];
      const float2* wk = wfrag + (size_t)ks * warps * G * 32;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float2 w = wk[q * 32];
        split(w.x, bhi[q][0], blo[q][0]);
        split(w.y, bhi[q][1], blo[q][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4], ahi[4], alo[4];
        ldmatrix_x4(a, hcur + (16 * mt + arow) * LDH + 8 * ks + acol);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ahi[i], alo[i]);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          mma_tf32(acc[mt][q], alo, bhi[q]);
          mma_tf32(acc[mt][q], ahi, blo[q]);
          mma_tf32(acc[mt][q], ahi, bhi[q]);
        }
      }
    }

    float hv[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[mt][j] = Cell::update(acc[mt], xv[mt], j, state[mt][j]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = next + (16 * mt + gid + 8 * half) * LDH + u;
        const float2 v = make_float2(hv[mt][2 * half], hv[mt][2 * half + 1]);
        *reinterpret_cast<float2*>(htile + off) = v;
#pragma unroll
        for (int p = 0; p < C - 1; ++p) st_cluster_f32x2(peer_htile[p] + 4u * off, v.x, v.y);
      }
    }
    cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long b = b0 + 16 * mt + gid + 8 * half;
        if (b < B) {
          const long long o = (b * T_len + t) * H + u;
          *reinterpret_cast<float2*>(hs + o) = make_float2(hv[mt][2 * half], hv[mt][2 * half + 1]);
          if (Cell::kCellState && cs != nullptr)
            *reinterpret_cast<float2*>(cs + o) =
                make_float2(state[mt][2 * half], state[mt][2 * half + 1]);
        }
      }
    cluster_wait();
  }
}

template <class Cell, int M, int C>
cudaError_t opt_in() {
  static bool done = false;  // per instantiation: the ceiling of H = kMaxHidden
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(scan_tf32_kernel<Cell, M, C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<Cell>(kMaxHidden, M, C));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <class Cell, int M, int C>
cudaLaunchConfig_t config_of(cudaLaunchAttribute* cluster, int tiles, int n_chains, int H,
                             cudaStream_t stream) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = C;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(C * tiles), (unsigned)n_chains);
  config.blockDim = dim3((unsigned)(4 * H / C));
  config.dynamicSmemBytes = smem_bytes<Cell>(H, M, C);
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  return config;
}

template <class Cell, int M, int C>
int launch_mc(const Chains& chains, int n_chains, int B, int T_len, int H, cudaStream_t stream) {
  cudaError_t err = opt_in<Cell, M, C>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config =
      config_of<Cell, M, C>(&cluster, (B + M - 1) / M, n_chains, H, stream);
  err = cudaLaunchKernelEx(&config, scan_tf32_kernel<Cell, M, C>, chains, B, T_len, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// H / C units a block, 8 a warp: H a multiple of 8C, up to kMaxHidden.
inline bool shape_ok(int H, int C) {
  return (C == 2 || C == 4) && H >= 8 * C && H <= kMaxHidden && H % (8 * C) == 0;
}

template <class Cell, int C>
int launch_c(const Chains& chains, int n_chains, int B, int T_len, int H, int M,
             cudaStream_t stream) {
  if (M == 16) return launch_mc<Cell, 16, C>(chains, n_chains, B, T_len, H, stream);
  if (M == 32) return launch_mc<Cell, 32, C>(chains, n_chains, B, T_len, H, stream);
  if (M == 64) return launch_mc<Cell, 64, C>(chains, n_chains, B, T_len, H, stream);
  return (int)cudaErrorInvalidValue;
}

// The 3xTF32 path: tiles of M in {16, 32, 64} rows, clusters of C in {2, 4}
// blocks, H a multiple of 8C up to 128.
template <class Cell>
int launch(const Chains& chains, int n_chains, int B, int T_len, int H, int M, int C,
           cudaStream_t stream) {
  if (B < 1 || T_len < 1 || !shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  if (C == 2) return launch_c<Cell, 2>(chains, n_chains, B, T_len, H, M, stream);
  return launch_c<Cell, 4>(chains, n_chains, B, T_len, H, M, stream);
}

// How many clusters of C blocks of the kernel at this H the card holds at
// once (cudaOccupancyMaxActiveClusters), each block on an SM of its own.
template <class Cell>
int max_clusters(int H, int C, int* clusters) {
  if (!shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t config;
  cudaError_t err;
  if (C == 2) {
    err = opt_in<Cell, 16, 2>();
    config = config_of<Cell, 16, 2>(&cluster, 1, 1, H, nullptr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(clusters, scan_tf32_kernel<Cell, 16, 2>, &config);
  } else {
    err = opt_in<Cell, 16, 4>();
    config = config_of<Cell, 16, 4>(&cluster, 1, 1, H, nullptr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(clusters, scan_tf32_kernel<Cell, 16, 4>, &config);
  }
  return (int)err;
}

}  // namespace tf32_scan

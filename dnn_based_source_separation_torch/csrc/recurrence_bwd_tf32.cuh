// Tensor-core reverse recurrence of the LSTM and GRU scans, for training (Hopper, sm_90a).
//
// Included by csrc/lstm_scan_bwd.cu and csrc/gru_scan_bwd.cu, which define the
// backward cells (LstmBwdCell, GruBwdCell) and launch this kernel for H a
// multiple of 16 up to 128 in either dtype (the wrappers' `_plan_bwd` picks
// the path, the tile and the cluster). ops/_build.py hashes this header into
// the key of every source.
//
// It computes the FMA backward kernels' function (see the two sources): per
// step, walking t from T-1 down to 0, the cell turns the step's inputs and
// the carried dh_rec (and, for the LSTM, dc_rec) into the gate derivatives
// da (G = 4 or 3 values a unit), and the reverse-recurrent product
//
//     dh_rec = carry + da (M x G H) @ W_hh^T (G H x H)
//
// feeds the step before (carry is dh * z for the GRU, 0 for the LSTM). That
// product is formed in f32 from TF32 products on mma.sync m16n8k8, as JAX's
// `_lstm_bwd_core` and `_gru_bwd_core` form it in f32 in both dtypes
// (`jnp.dot(da, w_hh.astype(f32).T, preferred_element_type=f32)`):
//   * f32 W ("tf32x3"): every operand x splits into hi = tf32(x) and lo =
//     tf32(x - hi), and the accumulator takes lo_da hi_W, hi_da lo_W, hi_da
//     hi_W per k-step, as the 3xTF32 forward (csrc/recurrence_tf32.cuh) does;
//   * bf16 W ("tf32x2"): a bf16 value has 8 significant bits, so W widened to
//     f32 is already a TF32 value and its lo term is zero: lo_da W, hi_da W.
// Both keep f32's accuracy (the dropped term is about 2^-22 of the product);
// one TF32 product does not (tests/test_torch_bwd_tf32.py emulates all three
// on the CPU). da itself is never rounded to bf16.
//
// What bounds it. A step of a chain depends on the step after it, so time is
// a loop inside the block and only independent sequences run in parallel. At
// the training shape (2 chains x 510 sequences, 250 steps, H = 128, f32) the
// LSTM kernel moves 1.3 GB (gates and das in f32, cs and g_hs): 0.39 ms at
// 3.35 TB/s, against 0.20 ms for its three TF32 products at 495 TFLOP/s. A
// step's latency is the cell, the exchange of da and the product in turn;
// measured on an H100 (PERF.md, scripts/probe_bwd_recurrence.py), the product
// is about 40% of an f32 LSTM step, and most of the rest is the step's
// global loads (a warp reads 8 rows x 32 bytes).
//
// Design (that of the 3xTF32 forward, with the product transposed):
//   * a cluster of C blocks (C = 2 or 4) owns an M-row tile (M = 16) of
//     independent sequences of one chain (blockIdx.x = C tile + rank,
//     blockIdx.y the chain). Rank r owns hidden units [r H/C, (r+1) H/C): each
//     of its H / 8C warps runs the cell of one n8 tile of 8 units, and a
//     thread's m16n8k8 C fragment positions of that tile (rows gid, gid + 8;
//     units 2 tig, 2 tig + 1) are the positions whose G gate derivatives it
//     derives, so dh_rec and dc_rec stay in its registers from one step to
//     the next;
//   * a block holds the columns of W_hh^T for its units, G H x H/C f32 (the
//     LSTM's 128 KB and the GRU's 96 KB at C = 2, H = 128), staged once in
//     B-fragment order straight from W_hh (no transposed copy), and reads no
//     W_hh from L2 or device memory in the loop;
//   * the A operand is the whole da row, so each block writes its M x G H/C
//     columns of da into its own tile and every other block's through
//     distributed shared memory (mapa): at M = 16, C = 2 and f32, 16 KB of
//     remote writes a block a step. The tile is double-buffered by step
//     parity, rows padded by 16 bytes so that ldmatrix (which loads the tf32
//     A fragments as pairs of b16) hits distinct banks; one cluster barrier a
//     step publishes it (barrier.cluster arrive has release, wait acquire
//     semantics), and the step's global stores (das, d_xw, d_hw) go between
//     the arrive and the wait;
//   * the product's K is split between pairs of warps where a block has an
//     even number of them (S = 2 K-slices): each warp of a pair multiplies
//     half of the k-steps for both warps' n8 tiles, so each loads and splits
//     half of the A fragments, keeps 2 G independent accumulators (one a
//     gate's block of K and n-tile), and hands its partner the partial sum
//     of the partner's tile through shared memory (a named barrier of the
//     pair); the owner adds the carry. The k-loop is unrolled by 4 (6-11%
//     faster than rolled on an H100, PERF.md);
//   * the step before's inputs stream into registers one step ahead: they
//     are loaded at the top of a step and used at the top of the next. Rows
//     past B read zeros, which keep every derivative of the row zero, and are
//     never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence_tf32.cuh"

namespace tf32_bwd {

using tf32_scan::cluster_arrive;
using tf32_scan::cluster_rank;
using tf32_scan::cluster_wait;
using tf32_scan::ldmatrix_x4;
using tf32_scan::map_to_rank;
using tf32_scan::mma_tf32;
using tf32_scan::smem_addr;
using tf32_scan::split;
using tf32_scan::st_cluster_f32x2;

constexpr int kMaxHidden = 128;
constexpr int kMaxThreads = 2 * kMaxHidden;  // H / 8C warps, C >= 2
constexpr size_t kMaxShared = 232448;        // a Hopper block's dynamic shared-memory ceiling

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
// The cells' sigmoid divides with div.approx (2 ulp), as the forwards' does.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

// A block's W_hh^T slice, its two da tiles and the K-slices' exchange of
// partial sums (a float4 a lane, warp and m16 tile), but at least the
// forward's kOwnSm, so that no two blocks share an SM.
template <class Cell>
__host__ __device__ constexpr size_t smem_bytes(int H, int M, int C) {
  const size_t need = sizeof(float) * ((size_t)Cell::kGates * H * (H / C) +
                                       2 * (size_t)M * (Cell::kGates * H + 4)) +
                      16 * (size_t)(M / 16) * (H / C / 8) * 32;
  return need > tf32_scan::kOwnSm ? need : tf32_scan::kOwnSm;
}

// The K-slices of the product: S = 2 where a block has an even number of
// warps (H / 8C), else 1.
inline int k_slices(int H, int C) { return (H / C / 8) % 2 ? 1 : 2; }

// bar.sync on a named barrier of `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Cell: LstmBwdCell<T> or GruBwdCell<T> (csrc/lstm_scan_bwd.cu,
// csrc/gru_scan_bwd.cu), T the inputs' dtype. A thread's position pair is
// one row and its two units u, u + 1; Cell::In holds a pair's inputs at one
// step, Cell::Out its outputs, and `state` the LSTM's dc_rec. S: the
// product's K-slices (k_slices).
template <class Cell, int M, int C, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
bwd_tf32_kernel(typename Cell::Chains chains, int B, int T_len, int H) {
  constexpr int G = Cell::kGates;
  constexpr int MT = M / 16;  // m16 tiles of the block
  using In = typename Cell::In;
  using Out = typename Cell::Out;
  const int HU = H / C;      // units of this block
  const int GH = G * H;      // K of the product
  const int LD = GH + 4;     // da tile row, f32, padded by 16 bytes
  const int KH = H / 8;      // k-steps of one gate's block of K
  const int warps = HU / 8;  // one n8 tile of the block's units each
  const int P = warps / S;   // groups of S warps, each group over S n-tiles

  const bool second = blockIdx.y != 0;
  const Cell cell(chains, second, T_len, H);
  const typename Cell::Weight* __restrict__ whh = cell.whh;

  extern __shared__ float4 smem_bwd[];
  float* wsm = reinterpret_cast<float*>(smem_bwd);  // [G KH][warps][32 lanes][2]
  float* tile = wsm + (size_t)GH * HU;              // [2][M][LD]
  float4* red = reinterpret_cast<float4*>(tile + 2 * M * LD);  // [warps][MT][32 lanes]

  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ubase = (int)rank * HU;
  // Warp (slice, p) multiplies slice `slice` of K for n-tiles S p .. S p + S - 1
  // and runs the cell of n-tile S p + slice: its threads' units u and u + 1.
  const int slice = warp / P, p = warp - slice * P;
  const int u = ubase + 8 * (S * p + slice) + 2 * tig;
  const long long b0 = (long long)(blockIdx.x / C) * M;

  // W_hh (H, G H) row-major -> this block's B fragments of W_hh^T: element e
  // of lane l's fragment (k-step ks, warp w) is W_hh^T row 8 ks + l % 4 + 4 e,
  // column ubase + 8 w + l / 4, that is W_hh[ubase + 8 w + l / 4][8 ks + l % 4 + 4 e].
  for (int i = tid; i < GH * HU; i += blockDim.x) {
    const int e = i & 1, l = (i >> 1) & 31;
    const int rest = i >> 6;
    const int w = rest % warps, ks = rest / warps;
    wsm[i] = widen(whh[(long long)(ubase + 8 * w + (l >> 2)) * GH + 8 * ks + (l & 3) + 4 * e]);
  }

  auto load_step = [&](In (&in)[MT][2], int t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long b = b0 + 16 * mt + gid + 8 * half;
        cell.load(in[mt][half], b, t, u, b < B);
      }
  };
  In nxt[MT][2];
  load_step(nxt, T_len - 1);

  unsigned peer_tile[C - 1];
#pragma unroll
  for (int p = 0; p < C - 1; ++p) peer_tile[p] = map_to_rank(smem_addr(tile), (rank + 1 + p) % C);
  const float2* wfrag = reinterpret_cast<const float2*>(wsm) + S * p * 32 + lane;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix row of this lane
  const int acol = 4 * (lane >> 4);                     // and its column

  float2 dh_rec[MT][2], state[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) dh_rec[mt][half] = state[mt][half] = make_float2(0.f, 0.f);

  // W staged in every block, and every block running, before any write to
  // another's shared memory.
  cluster_arrive();
  cluster_wait();

#pragma unroll 1
  for (int t = T_len - 1; t >= 0; --t) {
    In cur[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) cur[mt][half] = nxt[mt][half];
    if (t > 0) load_step(nxt, t - 1);

    const int cur_buf = (t & 1) * M * LD;  // this step's da tile
    const float* buf = tile + cur_buf;
    Out out[MT][2];
    float2 carry[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        cell.derive(cur[mt][half], dh_rec[mt][half], state[mt][half], out[mt][half],
                    carry[mt][half]);
        const int off = cur_buf + (16 * mt + gid + 8 * half) * LD + u;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const float2 v = Cell::tile_value(out[mt][half], q);
          *reinterpret_cast<float2*>(tile + off + q * H) = v;
#pragma unroll
          for (int p = 0; p < C - 1; ++p)
            st_cluster_f32x2(peer_tile[p] + 4u * (off + q * H), v.x, v.y);
        }
      }
    cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long b = b0 + 16 * mt + gid + 8 * half;
        if (b < B) cell.store(out[mt][half], b, t, u);
      }
    cluster_wait();
    if (t == 0) break;

    float acc[MT][S][G][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < S; ++n)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][n][q][j] = 0.f;
#pragma unroll 4
    for (int kk = slice * (KH / S); kk < (slice + 1) * (KH / S); ++kk) {  // this warp's slice
#pragma unroll
      for (int q = 0; q < G; ++q) {
        unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned a[4];
          ldmatrix_x4(a, buf + (16 * mt + arow) * LD + q * H + 8 * kk + acol);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ahi[mt][e], alo[mt][e]);
        }
#pragma unroll
        for (int n = 0; n < S; ++n) {
          const float2 w = wfrag[(size_t)((q * KH + kk) * warps + n) * 32];
          unsigned bhi[2], blo[2];
          if (Cell::kExactW) {
            bhi[0] = __float_as_uint(w.x);
            bhi[1] = __float_as_uint(w.y);
          } else {
            split(w.x, bhi[0], blo[0]);
            split(w.y, bhi[1], blo[1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(acc[mt][n][q], alo[mt], bhi);
            if (!Cell::kExactW) mma_tf32(acc[mt][n][q], ahi[mt], blo);
            mma_tf32(acc[mt][n][q], ahi[mt], bhi);
          }
        }
      }
    }
    // Each n-tile's sum over the gates; with two K-slices, each warp hands the
    // other warp of its group the partial sum of that warp's n-tile and adds
    // the one it gets back.
    float part[MT][S][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < S; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part[mt][n][j] = acc[mt][n][0][j];
#pragma unroll
          for (int q = 1; q < G; ++q) part[mt][n][j] += acc[mt][n][q][j];
        }
    float sum[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[mt][j] = part[mt][0][j];
    if (S == 2) {
      const int other = (1 - slice) * P + p;
      // Values selected, not a pointer into the register array: a runtime
      // index into it would put it on the stack.
      float give[MT][4], own[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          give[mt][j] = slice ? part[mt][0][j] : part[mt][S - 1][j];
          own[mt][j] = slice ? part[mt][S - 1][j] : part[mt][0][j];
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        red[(warp * MT + mt) * 32 + lane] =
            make_float4(give[mt][0], give[mt][1], give[mt][2], give[mt][3]);
      named_barrier(1 + p, 64);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float4 got = red[(other * MT + mt) * 32 + lane];
        sum[mt][0] = own[mt][0] + got.x;
        sum[mt][1] = own[mt][1] + got.y;
        sum[mt][2] = own[mt][2] + got.z;
        sum[mt][3] = own[mt][3] + got.w;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        dh_rec[mt][half] = make_float2(carry[mt][half].x + sum[mt][2 * half],
                                       carry[mt][half].y + sum[mt][2 * half + 1]);
  }
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

// Opt the instantiation in to the shared memory of this launch (at most once
// per size it grows to).
template <class Cell, int M, int C, int S>
cudaError_t opt_in(size_t smem) {
  static size_t opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_tf32_kernel<Cell, M, C, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  return cudaSuccess;
}

template <class Cell, int M, int C, int S>
int launch_mcs(const typename Cell::Chains& chains, int n_chains, int B, int T_len, int H,
               cudaStream_t stream) {
  cudaError_t err = opt_in<Cell, M, C, S>(smem_bytes<Cell>(H, M, C));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config =
      config_of<Cell, M, C>(&cluster, (B + M - 1) / M, n_chains, H, stream);
  err = cudaLaunchKernelEx(&config, bwd_tf32_kernel<Cell, M, C, S>, chains, B, T_len, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Cell, int M, int C>
int launch_mc(const typename Cell::Chains& chains, int n_chains, int B, int T_len, int H,
              cudaStream_t stream) {
  if (smem_bytes<Cell>(H, M, C) > kMaxShared) return (int)cudaErrorInvalidValue;
  if (k_slices(H, C) == 2)
    return launch_mcs<Cell, M, C, 2>(chains, n_chains, B, T_len, H, stream);
  return launch_mcs<Cell, M, C, 1>(chains, n_chains, B, T_len, H, stream);
}

template <class Cell, int C>
int launch_c(const typename Cell::Chains& chains, int n_chains, int B, int T_len, int H, int M,
             cudaStream_t stream) {
  if (M == 16) return launch_mc<Cell, 16, C>(chains, n_chains, B, T_len, H, stream);
  return (int)cudaErrorInvalidValue;
}

// The split-TF32 path: tiles of M = 16 rows (M = 32 with two K-slices and the
// unrolled k-loop spilled to the stack), clusters of C in {2, 4} blocks, H a
// multiple of 8C up to 128.
template <class Cell>
int launch(const typename Cell::Chains& chains, int n_chains, int B, int T_len, int H, int M,
           int C, cudaStream_t stream) {
  if (B < 1 || T_len < 1 || !tf32_scan::shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  if (C == 2) return launch_c<Cell, 2>(chains, n_chains, B, T_len, H, M, stream);
  return launch_c<Cell, 4>(chains, n_chains, B, T_len, H, M, stream);
}

// How many clusters of C blocks of the kernel at this H the card holds at
// once (cudaOccupancyMaxActiveClusters), each block on an SM of its own; asked
// at M = 16 with one K-slice, whose every (H, C) takes an SM of its own as
// the other instantiations do.
template <class Cell, int C>
int max_clusters_c(int H, int* clusters) {
  cudaLaunchAttribute cluster;
  cudaError_t err = opt_in<Cell, 16, C, 1>(smem_bytes<Cell>(H, 16, C));
  const cudaLaunchConfig_t config = config_of<Cell, 16, C>(&cluster, 1, 1, H, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, bwd_tf32_kernel<Cell, 16, C, 1>, &config);
  return (int)err;
}

template <class Cell>
int max_clusters(int H, int C, int* clusters) {
  if (!tf32_scan::shape_ok(H, C)) return (int)cudaErrorInvalidValue;
  return C == 2 ? max_clusters_c<Cell, 2>(H, clusters) : max_clusters_c<Cell, 4>(H, clusters);
}

}  // namespace tf32_bwd

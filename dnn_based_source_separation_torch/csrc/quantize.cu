// Whole-array symmetric int8 quantization (Hopper, sm_90a).
//
// Replaces the TPU kernel of dnn_based_source_separation_tpu/ops/pallas_kernels.py:
//   quantize_int8 (_quantize_kernel, :31-42): for a whole f32 array x,
//     scale = max(max|x| / 127, 1e-12)
//     q = int8(round_half_even(x / scale)), or in stochastic mode
//     q = int8(floor(x / scale + u)), u uniform on [0, 1)
//   and a (1, 1) f32 scale.
//
// Three traps for bit-exactness with JAX: the kernel divides x by the scale
// (IEEE round-to-nearest division, __fdiv_rn), never multiplies by its
// inverse; it rounds half to even (__float2int_rn), as jnp.round does, not
// half away from zero (roundf); and it forms the scale as max|x| times the
// f32 reciprocal of 127, because XLA rewrites the division by the constant
// 127 into that product (the divisor of x / scale is not a constant, so that
// one stays a division). In stochastic mode u comes from a
// Philox4x32-10 counter generator inside the kernel (the TPU's own random
// bits do not exist here): key = the 64-bit seed the wrapper passes,
// counter = the index of the element's group of four, one 32-bit draw per
// element, u = (bits >> 8) * 2^-24. floor(s + u) is evaluated as
// floor(s) + (u < s - floor(s)): the same value in exact arithmetic, but the
// f32 sum s + u could round up to floor(s) + 2 when u is within an ulp of 1,
// which is neither the floor nor the ceiling of s. A value x / scale a
// rounding above 127 could reach 128, so the stochastic result saturates to
// [-128, 127]. The plain version does the same.
//
// What bounds it. Two passes over x and one int8 write: 9 bytes per element
// against a handful of operations, far below the card's operations-per-byte
// line, so device-memory bandwidth (3.35 TB/s) bounds it.
//
// Design. A Hopper grid has no order between blocks, so the whole-array max
// is a pass of its own: each block reduces a grid-stride slice with 16-byte
// loads and a warp-shuffle tree, then one atomicMax per block on the bits of
// the non-negative float (for non-negative IEEE floats the unsigned bit
// patterns order as the values do), into a word the launcher zeroes first.
// The quantize pass follows on the same stream: each thread reads the max,
// derives the scale, and turns four floats into four int8 with one 16-byte
// load and one 4-byte store. Block 0 writes the scale.
//
// Bound with ctypes (ops/_build.py); the C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long n, unsigned* __restrict__ absmax_bits) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) m = fmaxf(m, fabsf(__ldg(x + i)));

  __shared__ float partial[kThreads / 32];
  m = warp_max(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? partial[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) atomicMax(absmax_bits, __float_as_uint(m));
  }
}

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit draws from a 128-bit
// counter and a 64-bit key.
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform(unsigned bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ signed char quantize_one(float x, float scale, bool stochastic,
                                                    unsigned bits) {
  const float s = __fdiv_rn(x, scale);
  if (!stochastic) return (signed char)__float2int_rn(s);
  const float fl = floorf(s);
  const float f = fl + (uniform(bits) < s - fl ? 1.f : 0.f);
  return (signed char)fminf(fmaxf(f, -128.f), 127.f);
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n, signed char* __restrict__ q,
                float* __restrict__ scale_out, const unsigned* __restrict__ absmax_bits,
                int stochastic, unsigned long long seed) {
  const float absmax = __uint_as_float(*absmax_bits);
  const float scale = fmaxf(__fmul_rn(absmax, 1.f / 127.f), 1e-12f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const uint2 key = make_uint2((unsigned)seed, (unsigned)(seed >> 32));
  const bool st = stochastic != 0;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* q4 = reinterpret_cast<char4*>(q);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (st) r = philox(make_uint4((unsigned)i, (unsigned)(i >> 32), 0u, 0u), key);
    q4[i] = make_char4(quantize_one(v.x, scale, st, r.x), quantize_one(v.y, scale, st, r.y),
                       quantize_one(v.z, scale, st, r.z), quantize_one(v.w, scale, st, r.w));
  }
  // The last n % 4 elements: one thread each, in the group of four after n4.
  const long long tail = n - 4 * n4;
  if (first < tail) {
    const long long i = 4 * n4 + first;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (st) r = philox(make_uint4((unsigned)n4, (unsigned)(n4 >> 32), 0u, 0u), key);
    const unsigned bits = first == 0 ? r.x : first == 1 ? r.y : r.z;
    q[i] = quantize_one(__ldg(x + i), scale, st, bits);
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

}  // namespace

// x: n contiguous f32, 16-byte aligned; q: n int8; scale: one f32;
// absmax_bits: one 32-bit scratch word (zeroed here). stochastic: 0 or 1.
// Returns a cudaError_t (0 on success). The Python wrapper validates every
// argument.
extern "C" int quantize_int8_launch(const float* x, long long n, signed char* q, float* scale,
                                    unsigned* absmax_bits, int stochastic,
                                    unsigned long long seed, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return sms < 0 ? -sms : (int)cudaErrorInvalidDevice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(absmax_bits, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  // Enough blocks to fill every SM several times over, no more than the
  // groups of four need.
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  absmax_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(x, n, absmax_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(x, n, q, scale, absmax_bits, stochastic,
                                                         seed);
  return (int)cudaGetLastError();
}

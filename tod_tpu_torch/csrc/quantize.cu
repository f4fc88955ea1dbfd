// K5: per-column symmetric int8 quantization with stochastic rounding.
//
// Replaces the Pallas kernel of the JAX package's ops/quantize.py,
// quantize_tensor_pallas (_quant_kernel, lines 30-40):
//
//   scale[c] = max(max_n |x[n, c]| / 127, 1e-12),
//   q[n, c]  = clamp(floor(x[n, c] / scale[c] + u[n, c]), -127, 127),
//
// where the TPU kernel drew u from the TPU's own generator.  Here u comes
// from Philox4x32-10 with key (seed, 0) and counter (i / 4, 0, 0, 0) for the
// element of flat index i = n * C + c, taking word i % 4:
// u = (word >> 8) * 2^-24, exact in float32 and in [0, 1).  The port's plain
// version (ops/quantize.py) computes the same words in int64 arithmetic, so
// the two agree bit for bit.  The clamp keeps x / scale, which can round a
// hair above 127 in magnitude, off -128, as the deterministic path does.
// Divisions are IEEE (no fast math).
//
// Bound: the function reads x once (4 bytes an element) and writes q (1
// byte) and the scales: bytes bound it.  Each element also costs a quarter
// of a Philox evaluation (10 rounds of 32-bit multiplies), which the
// float32 peak of the card does not count.
//
// Design: the column maxima are a reduction across the whole grid, and
// every element needs its column's.  A memset zeroes a (C) int buffer; the
// column-max kernel gives each block 32 columns and a chunk of rows,
// reduces in shared memory and takes an atomicMax on the int bits of |x|
// into that buffer: |x| is not negative, so its bits order as the floats
// do, and a NaN (sign cleared) orders above +inf, so NaN propagates as
// torch.amax does.  The quantize kernel follows.  (One cooperative kernel
// with grid barriers between the phases measured slower on an H100.)
// The quantize pass is flat: a thread takes four consecutive flat indices,
// one Philox counter and its four words, with one float4 load (scalar loads
// where the base is not 16-byte aligned, and for the numel % 4 tail) and
// one 4-byte store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kCols = 32;
constexpr int kRows = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4(uint32_t counter, uint32_t seed) {
  uint32_t c0 = counter, c1 = 0u, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// max(amax / 127, 1e-12), NaN kept (torch's clamp_min propagates it)
__device__ __forceinline__ float scale_of(float amax) {
  const float s = __fdiv_rn(amax, 127.0f);
  return isnan(s) ? s : fmaxf(s, 1e-12f);
}

__device__ __forceinline__ int8_t round_one(float x, float scale, uint32_t word) {
  const float u = (float)(word >> 8) * 5.9604644775390625e-08f;  // 2^-24
  const float v = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
}

// blockIdx.x: 32 columns; blockIdx.y: a chunk of `chunk` rows.
__global__ void quantize_colmax_kernel(const float* __restrict__ x, int n, int c, int chunk,
                                       int* __restrict__ amax_bits) {
  __shared__ float part[kRows][kCols + 1];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(n, r0 + chunk);
  float m = 0.0f;
  if (col < c) {
    for (int i = r0 + threadIdx.y; i < r1; i += kRows) m = max_nan(m, fabsf(__ldg(x + (size_t)i * c + col)));
  }
  part[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
    for (int j = 1; j < kRows; ++j) m = max_nan(m, part[j][threadIdx.x]);
    atomicMax(amax_bits + col, __float_as_int(m));
  }
}

// A thread takes the four flat indices 4g .. 4g + 3 (those below numel):
// one Philox counter and its four words.  The thread holding a column's
// row-0 element writes its scale.
template <bool kVec>
__global__ void quantize_kernel(const float* __restrict__ x, int numel, int c, uint32_t seed,
                                const int* __restrict__ amax_bits, int8_t* __restrict__ q,
                                float* __restrict__ scales) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int i0 = 4 * g;
  if (i0 >= numel) return;
  const uint4 word = philox4((uint32_t)g, seed);
  const uint32_t words[4] = {word.x, word.y, word.z, word.w};
  const bool whole = i0 + 3 < numel;
  float v[4];
  if (whole && kVec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(x) + g);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < numel ? __ldg(x + i0 + k) : 0.0f;
  }
  int col = i0 % c;
  char4 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < numel) {
      const float s = scale_of(__int_as_float(__ldg(amax_bits + col)));
      if (i0 + k < c) scales[col] = s;
      o[k] = round_one(v[k], s, words[k]);
    }
    if (++col == c) col = 0;
  }
  if (whole) {
    *reinterpret_cast<char4*>(q + i0) = out;
  } else {
    for (int k = 0; i0 + k < numel; ++k) q[i0 + k] = o[k];
  }
}

}  // namespace

// x (n, c) f32 -> q (n, c) int8 and scales (c) f32 on `stream`; amax_bits:
// c ints of scratch; sms: the device's SM count.
extern "C" int tod_quantize(const void* x, int n, int c, unsigned int seed, void* q, void* scales,
                            void* amax_bits, int sms, void* stream) {
  if (n < 1 || c < 1 || sms < 1 || (long long)n * c >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  int* bits = (int*)amax_bits;
  const int numel = n * c;
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(int) * (size_t)c, s);
  if (err != cudaSuccess) return (int)err;
  // about two blocks an SM, at least 8 rows a block
  const int col_groups = (c + kCols - 1) / kCols;
  int chunks = (2 * sms + col_groups - 1) / col_groups;
  chunks = std::max(1, std::min(chunks, (n + kRows - 1) / kRows));
  const int chunk = (n + chunks - 1) / chunks;
  chunks = (n + chunk - 1) / chunk;
  quantize_colmax_kernel<<<dim3(col_groups, chunks), dim3(kCols, kRows), 0, s>>>(xf, n, c, chunk,
                                                                                 bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int groups = (numel + 3) / 4;
  const dim3 grid((groups + kThreads - 1) / kThreads);
  if (((uintptr_t)x & 15u) == 0) {
    quantize_kernel<true><<<grid, kThreads, 0, s>>>(xf, numel, c, (uint32_t)seed, bits,
                                                     (int8_t*)q, (float*)scales);
  } else {
    quantize_kernel<false><<<grid, kThreads, 0, s>>>(xf, numel, c, (uint32_t)seed, bits,
                                                      (int8_t*)q, (float*)scales);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// Bound: the kernel reads x once (4 bytes an element) and writes q (1 byte)
// and the scales: bytes bound it.  Each element also costs one Philox
// evaluation, 10 rounds of 32-bit multiplies, which the float32 peak of the
// card does not count.
//
// Design: a block owns 32 columns, one per lane, and 16 rows of threads walk
// down them, so each warp reads 128 contiguous bytes a row.  The block
// reduces its columns' maxima in shared memory, then the same threads make
// a second pass that quantizes.  One element, one Philox evaluation: three
// of its four words go unused, which keeps the index arithmetic plain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;
constexpr int kRows = 16;

__device__ __forceinline__ uint32_t philox_word(uint32_t counter, uint32_t seed, int which) {
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
  return which == 0 ? c0 : which == 1 ? c1 : which == 2 ? c2 : c3;
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;  // torch.amax propagates NaN
}

__global__ void quantize_kernel(const float* __restrict__ x, int n, int c, uint32_t seed,
                                int8_t* __restrict__ q, float* __restrict__ scales) {
  __shared__ float part[kRows][kCols + 1];
  __shared__ float scale_s[kCols];
  const int col = blockIdx.x * kCols + threadIdx.x;
  float m = 0.0f;
  if (col < c) {
    for (int i = threadIdx.y; i < n; i += kRows) m = max_nan(m, fabsf(x[(size_t)i * c + col]));
  }
  part[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0) {
    for (int j = 1; j < kRows; ++j) m = max_nan(m, part[j][threadIdx.x]);
    const float s = __fdiv_rn(m, 127.0f);
    const float scale = isnan(s) ? s : fmaxf(s, 1e-12f);
    scale_s[threadIdx.x] = scale;
    if (col < c) scales[col] = scale;
  }
  __syncthreads();
  if (col >= c) return;
  const float scale = scale_s[threadIdx.x];
  for (int i = threadIdx.y; i < n; i += kRows) {
    const uint32_t idx = (uint32_t)i * (uint32_t)c + (uint32_t)col;
    const uint32_t word = philox_word(idx >> 2, seed, (int)(idx & 3u));
    const float u = (float)(word >> 8) * 5.9604644775390625e-08f;  // 2^-24
    const float v = floorf(__fadd_rn(__fdiv_rn(x[idx], scale), u));
    q[idx] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
  }
}

}  // namespace

extern "C" int tod_quantize(const void* x, int n, int c, unsigned int seed, void* q,
                            void* scales, void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((c + kCols - 1) / kCols);
  quantize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, c, (uint32_t)seed, (int8_t*)q, (float*)scales);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

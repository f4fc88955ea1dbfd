// K3/K4: the terrain "bump" dilation of a padded peak map.
//
// Replaces the Pallas kernels of the JAX package's kernels/bump.py,
// dilate_peaks_strips (_kernel_var_strips, lines 38-87) and dilate_peaks
// (_kernel_var, lines 146-157).  Both compute
//
//   out[o] = max over d in [-L, L-1]^2 of floor(g(peak[o - d], |d|)),
//   g(v, r) = v / (1 + max(v / err - 1, 1e-6) ^ (2r/L - 1)),
//
// zero where the source is not positive.  g is monotone in v for a fixed r,
// so the displacements of one ring (equal r^2) are max-reduced first and
// share one evaluation of g, exactly as the port's plain version does
// (kernels/bump.py, plain_dilate_peaks).
//
// The ring table (offsets grouped by r^2, each ring's float32 exponent and
// the way torch evaluates pow for that exponent) comes from the host, from
// the same Python function the plain version reads, so both sides use the
// same exponents.  torch on CUDA evaluates pow(tensor, python_scalar) by
// special cases for some exponents (0: fill with 1, 1: copy, 0.5: sqrt,
// -0.5: rsqrt, -1: reciprocal, 2, 3, -2: products) and by powf otherwise;
// pow_as_torch repeats each case, so that a floor never sees another last
// bit than the plain version's.  Divisions are IEEE (no fast math), and err
// arrives as a float, never as its reciprocal.
//
// Bound: at VGA (480x640, L = 10) the kernel reads 1.3 MB and writes 1.2 MB
// (0.76 us at 3.35 TB/s), and per pixel takes 400 maxima and evaluates g
// (a powf and two divisions) for each ring (61 at L = 10) whose maximum is
// positive, 11 M evaluations on a synthetic VGA frame's terrain: the
// arithmetic, not the bytes, bounds it.
//
// Design: one thread per output pixel, 16x16 threads per block.  The block
// stages its tile plus the halo it reads, (16 + 2L - 1)^2 floats of the
// padded peak map (4.9 KB at L = 10), in shared memory once; the 400 shifted
// reads of each thread then come from shared memory.  The TPU kernel's strip
// DMAs and lane rolls were its tiling and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 16;

// How torch evaluates pow(x, e) on CUDA for a Python scalar e (the mode is
// chosen on the host, kernels/bump.py pow_mode).
enum PowMode {
  kGeneral = 0,
  kFillOne = 1,
  kCopy = 2,
  kSqrt = 3,
  kRsqrt = 4,
  kReciprocal = 5,
  kSquare = 6,
  kCube = 7,
  kInvSquare = 8,
};

__device__ __forceinline__ float pow_as_torch(float b, float e, int mode) {
  switch (mode) {
    case kFillOne: return 1.0f;
    case kCopy: return b;
    case kSqrt: return __fsqrt_rn(b);
    case kRsqrt: return rsqrtf(b);
    case kReciprocal: return __fdiv_rn(1.0f, b);
    case kSquare: return __fmul_rn(b, b);
    case kCube: return __fmul_rn(__fmul_rn(b, b), b);
    case kInvSquare: return (float)(1.0 / (double)__fmul_rn(b, b));
    default: return powf(b, e);
  }
}

__global__ void bump_kernel(const float* __restrict__ peaks, int hp, int wp,
                            float* __restrict__ out, int h, int w, int pad,
                            int L, float err, const int* __restrict__ offsets,
                            const int* __restrict__ ring_start,
                            const float* __restrict__ exps,
                            const int* __restrict__ modes, int n_rings) {
  extern __shared__ float tile[];
  const int side = kTile + 2 * L - 1;
  const int oy0 = blockIdx.y * kTile;
  const int ox0 = blockIdx.x * kTile;
  // tile[t][s] holds peaks[oy0 + pad - (L - 1) + t][ox0 + pad - (L - 1) + s]
  const int gy0 = oy0 + pad - (L - 1);
  const int gx0 = ox0 + pad - (L - 1);
  for (int i = threadIdx.y * kTile + threadIdx.x; i < side * side; i += kTile * kTile) {
    const int ty = i / side;
    const int gy = gy0 + ty;
    const int gx = gx0 + (i - ty * side);
    tile[i] = (gy >= 0 && gy < hp && gx >= 0 && gx < wp) ? peaks[(size_t)gy * wp + gx] : 0.0f;
  }
  __syncthreads();
  const int oy = oy0 + threadIdx.y;
  const int ox = ox0 + threadIdx.x;
  if (oy >= h || ox >= w) return;
  // the source of displacement (dy, dx) is centre[-dy * side - dx]
  const float* centre = tile + (threadIdx.y + L - 1) * side + threadIdx.x + L - 1;
  float acc = 0.0f;
  for (int r = 0; r < n_rings; ++r) {
    float m = -INFINITY;
    for (int k = ring_start[r]; k < ring_start[r + 1]; ++k) {
      const float v = centre[-offsets[2 * k] * side - offsets[2 * k + 1]];
      m = (v > m || isnan(v)) ? v : m;  // torch.maximum propagates NaN
    }
    if (m > 0.0f) {
      const float c1 = fmaxf(__fsub_rn(__fdiv_rn(m, err), 1.0f), 1e-6f);
      const float g = __fdiv_rn(m, __fadd_rn(1.0f, pow_as_torch(c1, exps[r], modes[r])));
      acc = fmaxf(acc, floorf(g));
    }
  }
  out[(size_t)oy * w + ox] = acc;
}

}  // namespace

extern "C" int tod_bump_shared_bytes(int L) {
  const int side = kTile + 2 * L - 1;
  return side * side * (int)sizeof(float);
}

extern "C" int tod_bump(const void* peaks, int hp, int wp, void* out, int h, int w,
                        int pad, int L, float err, const void* offsets,
                        const void* ring_start, const void* exps, const void* modes,
                        int n_rings, void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  bump_kernel<<<grid, block, tod_bump_shared_bytes(L), (cudaStream_t)stream>>>(
      (const float*)peaks, hp, wp, (float*)out, h, w, pad, L, err,
      (const int*)offsets, (const int*)ring_start, (const float*)exps,
      (const int*)modes, n_rings);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// The ring table (displacements grouped by r^2, ascending; each ring's
// float32 exponent and the way torch evaluates pow for that exponent) comes
// from the same Python function the plain version reads (kernels/bump.py
// table_words) and lives in device memory, one buffer a (device, radius)
// that is written once and then only read, so launches of several radii on
// several streams never share mutable state.  torch on CUDA evaluates
// pow(tensor, python_scalar) by special cases for some exponents (0: fill
// with 1, 1: copy, 0.5: sqrt, -0.5: rsqrt, -1: reciprocal, 2, 3, -2:
// products) and by powf otherwise; pow_as_torch repeats each case, so that a
// floor never sees another last bit than the plain version's.  Divisions are
// IEEE (no fast math), and err arrives as a float, never as its reciprocal.
// A NaN anywhere in a ring makes its maximum NaN (max.NaN.f32, as
// torch.maximum), which contributes nothing; an evaluation that gives NaN
// (an infinite peak on a ring whose exponent is positive) makes the output
// NaN, as in the plain version.
//
// Bound: at VGA (480x640, L = 10) the kernel reads 1.3 MB and writes 1.2 MB
// (0.76 us at 3.35 TB/s).  The function needs less arithmetic than this
// kernel does: a pixel can stop once no ring still to come can raise its
// accumulator (g(m, r) <= m, and <= m / 2 on the rings whose exponent is
// >= 0), and chip_smoke.py (needed_ring_work) counts the maxima and
// evaluations of such a per-pixel stop on its input for the bound.
//
// Design (each choice measured by tools/block_sweep.py k3 on an H100):
// - A block is 32 columns wide (one warp across) and P x rows tall; a
//   thread takes P pixels of one column, each with its own accumulator.
//   The block stages its tile and halo, (P rows + 2L - 1) x (32 + 2L - 1)
//   floats of the padded peak map, once.  The kernel waits on latency more
//   than it issues, so many warps beat many pixels a thread: P = 2 and 4
//   thread rows at VGA (kernels/bump.py bump_tiling, which shrinks the tile
//   where the grid would leave an SM without a block).
// - The ring offsets reach the inner loop as uniform operands: word offsets
//   into the shared tile, premultiplied by its row stride, read with
//   warp-uniform loads from the table (every L), or as immediates for the
//   app's radius L = 10, whose table is built at compile time and is the
//   faster of the two (TOD_K3_TABLE=0 sends L = 10 through the table too).
// - Every ring runs, and is evaluated where its maximum is positive:
//   skipping the rings that cannot raise the accumulator, and stopping a
//   warp once none can, measured slower on the terrain.
// - A memo table of floor(g(v, r)) for the integral v below n_values,
//   filled by bump_memo_kernel with the same arithmetic before a radius's
//   first launch: the terrain's peaks are image row indices, so its
//   evaluations become loads (TOD_K3_MEMO=0 computes every one).  A ring's
//   value is taken into acc one ring late, so that its load is in flight
//   while the next ring's maxima are read.
// - max.NaN.f32 for torch.maximum's NaN propagation: one instruction.
// The TPU kernel's strip DMAs and lane rolls were its tiling and are not
// carried over.

#include <cuda_runtime.h>
#include <math.h>

#include <utility>

#ifndef TOD_K3_TABLE
#define TOD_K3_TABLE 1
#endif
#ifndef TOD_K3_MEMO
#define TOD_K3_MEMO 1
#endif

namespace {

constexpr int kTileW = 32;
constexpr int kTableL = 10;  // the radius with a compile-time table

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

// The ring table of one radius in device memory (kernels/bump.py
// table_words): off[k] = -(dy * stride + dx) of the k-th displacement by
// ring, for a shared tile of row stride 32 + 2L - 1; ring r holds
// start[r] .. start[r + 1] - 1; mode and exp per ring.
struct Table {
  const int* off;
  const int* start;
  const int* mode;
  const float* exp;
};

Table table_at(const void* words, int n_disp, int n_rings) {
  const int* w = (const int*)words;
  return Table{w, w + n_disp, w + n_disp + n_rings + 1,
               (const float*)(w + n_disp + 2 * n_rings + 1)};
}

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

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float bump(float m, int r, const Table& tab, float err) {
  const float c1 = fmaxf(__fsub_rn(__fdiv_rn(m, err), 1.0f), 1e-6f);
  return floorf(__fdiv_rn(m, __fadd_rn(1.0f, pow_as_torch(c1, __ldg(tab.exp + r),
                                                          __ldg(tab.mode + r)))));
}

// floor(g(m, r)) of a ring maximum m > 0: from the memo table for an
// integral m below n_values (the terrain's peaks are image row indices),
// computed otherwise.  The table holds what bump() gives for (v, r).
__device__ __forceinline__ float ring_bump(float m, int r, const Table& tab, float err,
                                           const float* __restrict__ memo, int n_values) {
#if TOD_K3_MEMO
  if (m < (float)n_values && m == floorf(m)) return __ldg(memo + r * n_values + (int)m);
#endif
  return bump(m, r, tab, err);
}

// The ring table of a compile-time L: displacements of [-L, L-1]^2 by
// ascending r^2 (in scan order within a ring, as ring_table lists them),
// each as its word offset in a shared tile of row stride 32 + 2L - 1.
template <int L>
struct RingTable {
  int n_rings = 0;
  int start[4 * L * L + 1] = {};
  int off[4 * L * L] = {};
};

template <int L>
constexpr RingTable<L> make_ring_table() {
  RingTable<L> t{};
  constexpr int side = 2 * L;
  constexpr int stride = kTileW + 2 * L - 1;
  int count[2 * L * L + 1] = {};
  int slot[2 * L * L + 1] = {};
  for (int i = 0; i < side * side; ++i) {
    const int dy = i / side - L, dx = i % side - L;
    ++count[dy * dy + dx * dx];
  }
  int k = 0;
  for (int r2 = 0; r2 <= 2 * L * L; ++r2) {
    if (count[r2]) {
      t.start[t.n_rings++] = k;
      slot[r2] = k;
      k += count[r2];
    }
  }
  t.start[t.n_rings] = k;
  for (int i = 0; i < side * side; ++i) {
    const int dy = i / side - L, dx = i % side - L;
    t.off[slot[dy * dy + dx * dx]++] = -(dy * stride + dx);
  }
  return t;
}

template <int L>
struct Rings {
  static constexpr RingTable<L> value = make_ring_table<L>();
};

template <int L>
__host__ __device__ constexpr int ring_count() { return Rings<L>::value.n_rings; }
template <int L>
__host__ __device__ constexpr int ring_begin(int r) { return Rings<L>::value.start[r]; }
template <int L>
__host__ __device__ constexpr int ring_offset(int k) { return Rings<L>::value.off[k]; }

template <int S, int P, int OFF>
__device__ __forceinline__ void load_max(const float* centre, float (&m)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) m[p] = max_nan(m[p], centre[OFF + p * S]);
}

template <int L, int P, int K0, int... I>
__device__ __forceinline__ void ring_loads(const float* centre, float (&m)[P],
                                           std::integer_sequence<int, I...>) {
  (load_max<kTileW + 2 * L - 1, P, ring_offset<L>(K0 + I)>(centre, m), ...);
}

// Ring r's maxima with immediate offsets: a binary search over the rings
// on the (warp-uniform) ring index, each leaf one ring's unrolled loads.
template <int L, int P, int LO, int HI>
__device__ __forceinline__ void ring_max(int r, const float* centre, float (&m)[P]) {
  if constexpr (HI - LO == 1) {
    constexpr int b = ring_begin<L>(LO), e = ring_begin<L>(LO + 1);
    ring_loads<L, P, b>(centre, m, std::make_integer_sequence<int, e - b>{});
  } else {
    constexpr int mid = (LO + HI) / 2;
    if (r < mid) {
      ring_max<L, P, LO, mid>(r, centre, m);
    } else {
      ring_max<L, P, mid, HI>(r, centre, m);
    }
  }
}

// LT > 0: L = LT with the compile-time table; LT = 0: L = l_arg with the
// offsets of `tab`.  A block is (32, rows) threads; a thread takes P pixels,
// one column, consecutive rows.
template <int LT, int P>
__global__ void bump_kernel(const float* __restrict__ peaks, int hp, int wp,
                            float* __restrict__ out, int h, int w, int pad, int l_arg,
                            float err, int n_rings, Table tab,
                            const float* __restrict__ memo, int n_values) {
  extern __shared__ float tile[];
  const int L = LT > 0 ? LT : l_arg;
  const int S = kTileW + 2 * L - 1;
  const int tile_h = blockDim.y * P;
  const int tile_rows = tile_h + 2 * L - 1;
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * kTileW;
  // tile[t * S + s] holds peaks[oy0 + pad - (L - 1) + t][ox0 + pad - (L - 1) + s]
  const int gy0 = oy0 + pad - (L - 1);
  const int gx0 = ox0 + pad - (L - 1);
#pragma unroll 4
  for (int t = threadIdx.y; t < tile_rows; t += blockDim.y) {
    const int gy = gy0 + t;
    const bool row_in = gy >= 0 && gy < hp;
    for (int s = threadIdx.x; s < S; s += kTileW) {
      const int gx = gx0 + s;
      tile[t * S + s] = (row_in && gx >= 0 && gx < wp) ? __ldg(peaks + (size_t)gy * wp + gx) : 0.0f;
    }
  }
  __syncthreads();
  // the source of displacement (dy, dx) for pixel p is centre[p * S - dy * S - dx]
  const int r0 = threadIdx.y * P;
  const float* centre = tile + (r0 + L - 1) * S + threadIdx.x + L - 1;
  // A ring's value is taken into acc one ring later, so that its memo load
  // is in flight while the next ring's maxima are read.
  float acc[P], pending[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc[p] = 0.0f;
    pending[p] = -INFINITY;
  }
  for (int r = 0; r < n_rings; ++r) {
    float m[P];
#pragma unroll
    for (int p = 0; p < P; ++p) m[p] = -INFINITY;
    if constexpr (LT > 0) {
      ring_max<LT, P, 0, ring_count<LT>()>(r, centre, m);
    } else {
      const int end = __ldg(tab.start + r + 1);
      for (int k = __ldg(tab.start + r); k < end; ++k) {
        const float* src = centre + __ldg(tab.off + k);
#pragma unroll
        for (int p = 0; p < P; ++p) m[p] = max_nan(m[p], src[p * S]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // NaN or not positive: contributes nothing
      const float value = m[p] > 0.0f ? ring_bump(m[p], r, tab, err, memo, n_values) : -INFINITY;
      acc[p] = max_nan(acc[p], pending[p]);
      pending[p] = value;
    }
  }
  const int ox = ox0 + threadIdx.x;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int oy = oy0 + r0 + p;
    if (oy < h && ox < w) out[(size_t)oy * w + ox] = max_nan(acc[p], pending[p]);
  }
}

// memo[r * n_values + v] = floor(g(v, r)) for 0 < v < n_values (0 at v = 0)
__global__ void bump_memo_kernel(Table tab, float err, int n_rings, int n_values,
                                 float* __restrict__ memo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rings * n_values) return;
  const int r = i / n_values;
  const int v = i - r * n_values;
  memo[i] = v > 0 ? bump((float)v, r, tab, err) : 0.0f;
}

struct Args {
  const float* peaks;
  int hp, wp;
  float* out;
  int h, w, pad, L;
  float err;
  int n_rings;
  Table tab;
  const float* memo;
  int n_values;
};

// A block's staged tile and halo (kernels/bump.py smem_bytes).
int shared_bytes(int L, int tile_h) {
  return (tile_h + 2 * L - 1) * (kTileW + 2 * L - 1) * (int)sizeof(float);
}

template <int LT, int P>
cudaError_t launch(dim3 grid, dim3 block, int smem, cudaStream_t s, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(bump_kernel<LT, P>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  bump_kernel<LT, P><<<grid, block, smem, s>>>(a.peaks, a.hp, a.wp, a.out, a.h, a.w, a.pad, a.L,
                                               a.err, a.n_rings, a.tab, a.memo, a.n_values);
  return cudaGetLastError();
}

template <int LT>
cudaError_t launch_p(int pixels, dim3 grid, dim3 block, int smem, cudaStream_t s, const Args& a) {
  switch (pixels) {
    case 1: return launch<LT, 1>(grid, block, smem, s, a);
    case 2: return launch<LT, 2>(grid, block, smem, s, a);
    case 4: return launch<LT, 4>(grid, block, smem, s, a);
    default: return cudaErrorInvalidValue;
  }
}

bool table_ok(int n_disp, int n_rings, int n_values) {
  return n_disp >= 1 && n_rings >= 1 && n_rings <= n_disp && n_values >= 1 &&
         (long long)n_rings * n_values < (1LL << 31);
}

}  // namespace

// Fill memo (n_rings, n_values) f32 with floor(g(v, r)) on `stream`.  table:
// the radius's ring table in device memory (kernels/bump.py table_words),
// n_disp displacements in n_rings rings.
extern "C" int tod_bump_memo(const void* table, int n_disp, int n_rings, float bump_err,
                             void* memo, int n_values, void* stream) {
  if (!table_ok(n_disp, n_rings, n_values)) return (int)cudaErrorInvalidValue;
  const int n = n_rings * n_values;
  bump_memo_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      table_at(table, n_disp, n_rings), bump_err, n_rings, n_values, (float*)memo);
  return (int)cudaGetLastError();
}

// peaks (hp, wp) f32 -> out (h, w) f32 on `stream`; table as for
// tod_bump_memo, and memo filled by it.  pixels (1, 2, 4) rows of a thread,
// rows threads down a block.
extern "C" int tod_bump(const void* peaks, int hp, int wp, void* out, int h, int w, int pad,
                        int L, float bump_err, const void* table, int n_disp, int n_rings,
                        int pixels, int rows, const void* memo, int n_values, void* stream) {
  if (L < 1 || n_disp != 4 * L * L || !table_ok(n_disp, n_rings, n_values) || rows < 1 ||
      rows * kTileW > 1024)
    return (int)cudaErrorInvalidValue;
  const int tile_h = pixels * rows;
  const dim3 block(kTileW, rows);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + tile_h - 1) / tile_h);
  const int smem = shared_bytes(L, tile_h);
  const Args a{(const float*)peaks, hp, wp, (float*)out, h, w, pad, L, bump_err, n_rings,
               table_at(table, n_disp, n_rings), (const float*)memo, n_values};
  cudaStream_t s = (cudaStream_t)stream;
  if (TOD_K3_TABLE && L == kTableL) {
    if (n_rings != ring_count<kTableL>()) return (int)cudaErrorInvalidValue;
    return (int)launch_p<kTableL>(pixels, grid, block, smem, s, a);
  }
  return (int)launch_p<0>(pixels, grid, block, smem, s, a);
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The training form of a MobileNetV2 ConvBN site after its convolution:
// BatchNorm on the batch's statistics in f32, ReLU6 where the site has it,
// and the result rounded to the convolution's dtype; forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves this graph to XLA, which
// fuses it.  Run as PyTorch operations it was ~70 aten calls a site and the
// generic elementwise and reduction kernels took most of a training step's
// device time (PERF.md).  kernels/bn_train.py holds the plain version.
//
// Forward, per channel over M = N * H * W elements of the (N, C, H, W) input,
// from its mean and mean square (E[x], E[x^2] in f32, which the wrapper
// takes from torch's own reductions, as the plain graph does):
//   var = max(E[x^2] - E[x]^2, 0), r = rsqrt(var + eps), mul = r * scale,
//   y = (x - mean) * mul + bias, ReLU6 (NaN kept), rounded to x's dtype;
//   running mean and var <- momentum * running + (1 - momentum) * batch;
// each step rounded as the plain graph's torch operations round it, so y is
// the plain graph's bit for bit.  (A step's loss moved by 1e-3 of itself
// when only the statistics' last bits changed, float64 sums in place of
// torch's f32 ones, on an H100: the statistics are not this file's to sum.)
// Backward from dy, with g = dy where 0 < y < 6 (y recomputed from the saved
// x, mean and r by the forward's own arithmetic, pre_act), else 0, and
// xh = (x - mean) * r:
//   dbias = sum g, dscale = sum g * xh,
//   dx = mul * (g - sum g / M - xh * sum(g * xh) / M).
// This is autograd's gradient of the plain graph, in three lines: y depends
// on x directly (mul), through mean (-mul / M summed over the channel) and
// through var, whose gradient sum(g * (x - mean)) * scale * (-r^3 / 2) times
// d var / d x = 2 (x - mean) / M gives -mul * xh * sum(g * xh) / M.  Where
// E[x^2] - E[x]^2 < 0 was clipped, clamp_min passes no gradient and that
// last term is dropped (keep = 0 below).  Only the order of the backward's
// f32 sums differs from the plain graph.
//
// Bound: bytes.  The forward's apply reads x and writes y, the backward
// reads x and dy twice and writes dx: 14 bytes an element in bf16, a few
// operations each (torch's statistics read x in f32 besides).  The 51 sites
// of a batch-16 480x640 step hold 648 M elements.
//
// Design: three launches a site on a channels-last (NHWC) tensor, the
// layout the training graph carries from its NHWC input (models/
// mobilenetv2.py ConvBN holds every site to it).  Blocks are cut from the
// shape and the SM count (kernels/bn_train.py bn_tiling): a block takes a
// group of at most 32 vectors of every row (up to 256 channels) and a run
// of rows.  Forward, one pass (bn_apply_kernel): each thread derives its
// channels' r and mul from the mean and mean square, the first slice's
// blocks write the saved statistics (mean, r, keep) and the running ones.
// Backward, two passes: bn_grad_stats_kernel sums g and g * xh in f32 a
// thread; shared-memory columns give the block's sums a channel, written
// to a (slices, C) scratch, and the last block of a channel group to
// finish, found by a ticket counter that the C entry zeroes first, sums
// each channel's partials in slice order and writes dscale, dbias and two
// coefficients; bn_grad_apply_kernel (with blocks of its own size: it sums
// nothing) writes dx.  No float atomics and no order left to the
// scheduler: a result is the same bits in every run.  Loads and stores are
// as wide as the row's byte length and the pointers allow, 16 bytes at
// every site of the VGA step; the element arithmetic of y is written with
// _rn intrinsics, so the forward and the backward's recomputation contract
// nothing and agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // kernels/bn_train.py THREADS
constexpr int kMaxVec = 8;     // elements a 16-byte bf16 vector holds

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = uint32_t; };
template <> struct RawOf<2> { using type = uint16_t; };

// BF16: the storage type is bfloat16 (kept as its bits), else float.
template <bool BF16> struct Elem;
template <> struct Elem<true> {
  using type = uint16_t;
  static __device__ __forceinline__ float load(type v) {
    return __uint_as_float((uint32_t)v << 16);
  }
  static __device__ __forceinline__ type store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Elem<false> {
  using type = float;
  static __device__ __forceinline__ float load(type v) { return v; }
  static __device__ __forceinline__ type store(float v) { return v; }
};

// BYTES of storage, loaded and stored at once, as kN elements.
template <bool BF16, int BYTES>
struct Pack {
  using E = typename Elem<BF16>::type;
  static constexpr int kN = BYTES / (int)sizeof(E);
  union {
    typename RawOf<BYTES>::type raw;
    E v[kN];
  };
};

template <bool BF16, int BYTES>
__device__ __forceinline__ Pack<BF16, BYTES> load_pack(const void* base, size_t elem) {
  Pack<BF16, BYTES> p;
  p.raw = *reinterpret_cast<const typename RawOf<BYTES>::type*>(
      static_cast<const typename Elem<BF16>::type*>(base) + elem);
  return p;
}

template <bool BF16, int BYTES>
__device__ __forceinline__ void store_pack(void* base, size_t elem, const Pack<BF16, BYTES>& p) {
  *reinterpret_cast<typename RawOf<BYTES>::type*>(
      static_cast<typename Elem<BF16>::type*>(base) + elem) = p.raw;
}

// y before the activation: ((x - mean) * mul) + bias, each step rounded.
__device__ __forceinline__ float pre_act(float x, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

// relu6 as the plain graph computes it: y inside (0, 6), else clamped; NaN stays.
__device__ __forceinline__ float relu6(float y) {
  return y > 0.f ? (y < 6.f ? y : 6.f) : (y <= 0.f ? 0.f : y);
}

// The gradient g' of one element: dy where relu6 passes it (0 < y < 6;
// not at 0, 6 or NaN) or where the site has no relu6, else 0.
template <bool ACT>
__device__ __forceinline__ float masked(float dy, float x, float mean, float mul, float bias) {
  if (!ACT) return dy;
  const float y = pre_act(x, mean, mul, bias);
  return y > 0.f && y < 6.f ? dy : 0.f;
}

// The backward's element sums, (g', g' * xh), each add rounded.
__device__ __forceinline__ void add2(float2& acc, float a, float b) {
  acc.x = __fadd_rn(acc.x, a);
  acc.y = __fadd_rn(acc.y, b);
}

struct Geom {
  int C;       // channels
  int rows;    // N * H * W, the elements a channel
  int hv;      // vectors a row
  int group;   // vectors of a row a block takes
  int per;     // rows a block takes
  int slices;  // blocks a channel group
  float m;     // rows, as the divisor of the means
};

// What the last block of the backward's statistics writes once a channel:
// dbias, dscale and coef = (sum g / M, keep ? sum g * xh / M : 0).
struct Fin {
  const float* saved;
  float* dscale;
  float* dbias;
  float* coef;
};

__device__ __forceinline__ void fin_backward(const Fin& f, const Geom& g, int c, float2 s) {
  f.dbias[c] = s.x;
  f.dscale[c] = s.y;
  f.coef[c] = __fdiv_rn(s.x, g.m);
  f.coef[g.C + c] = f.saved[2 * g.C + c] != 0.f ? __fdiv_rn(s.y, g.m) : 0.f;
}

// The forward's per-channel values from the batch's mean and mean square,
// rounded as the plain graph rounds them: var = (sq - mean * mean) clamped
// at 0 (NaN kept), r = rsqrt(var + eps) (torch.rsqrt's rsqrtf), mul = r *
// scale.  The first slice's blocks write saved = (mean, r, keep) and the
// running statistics.
struct Stats {
  const float* mean;
  const float* sq;
  float* saved;
  float* rmean;
  float* rvar;
  float eps, momentum, rest;
};

__device__ __forceinline__ float2 channel_stats(const Stats& st, const Geom& g, int c,
                                                float scale, bool writer) {
  const float mean = st.mean[c];
  const float raw = __fsub_rn(st.sq[c], __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  const float r = rsqrtf(__fadd_rn(var, st.eps));
  if (writer) {
    st.saved[c] = mean;
    st.saved[g.C + c] = r;
    st.saved[2 * g.C + c] = raw >= 0.f ? 1.f : 0.f;
    st.rmean[c] = __fadd_rn(__fmul_rn(st.momentum, st.rmean[c]), __fmul_rn(st.rest, mean));
    st.rvar[c] = __fadd_rn(__fmul_rn(st.momentum, st.rvar[c]), __fmul_rn(st.rest, var));
  }
  return make_float2(mean, __fmul_rn(r, scale));
}

// After each block has written its partials of channels [c0, c0 + nc) to
// part (slices, C): the last of the `slices` blocks to take the ticket sums
// each channel's partials in slice order (the same bits whichever block is
// last) and finishes the channel.  smem: kThreads float2.
__device__ void finish(const float2* part, unsigned* ticket, int c0, int nc, const Geom& g,
                       const Fin& f, float2* smem) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)(g.slices - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lanes = kThreads / nc;
  const int ch = threadIdx.x % nc, lane = threadIdx.x / nc;
  float2 acc = make_float2(0.f, 0.f);
  if (lane < lanes) {
#pragma unroll 8
    for (int s = lane; s < g.slices; s += lanes) {
      const float2 p = __ldcg(part + (size_t)s * g.C + c0 + ch);
      add2(acc, p.x, p.y);
    }
  }
  smem[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < nc) {
    float2 t = smem[threadIdx.x];
    for (int l = 1; l < lanes; ++l) {
      const float2 p = smem[l * nc + threadIdx.x];
      add2(t, p.x, p.y);
    }
    fin_backward(f, g, c0 + threadIdx.x, t);
  }
}

// The thread's vector of a row (-1 where it has none) and its first
// row; it takes rows row0, row0 + kThreads / group, ... below end.
struct RowSpan {
  int vec, row0, step, end;
};

__device__ __forceinline__ RowSpan row_span(const Geom& g) {
  const int step = kThreads / g.group;
  const int r = threadIdx.x / g.group, j = threadIdx.x % g.group;
  const int vec = blockIdx.y * g.group + j;
  const long long stop = (long long)(blockIdx.x + 1) * g.per;
  RowSpan s;
  s.vec = r < step && vec < g.hv ? vec : -1;
  s.row0 = blockIdx.x * g.per + r;
  s.step = step;
  s.end = (int)(stop < g.rows ? stop : g.rows);
  return s;
}

// The block's sums of each of its channels: the threads of one vector sum
// their rows' column in shared memory in row order; then the partials and
// the finish.  red: kThreads * kMaxVec float2.
template <int VEC>
__device__ __forceinline__ void reduce_group(const float2 (&acc)[VEC], float2* part,
                                             unsigned* tickets, const Geom& g, const Fin& f,
                                             float2* red) {
  const int step = kThreads / g.group;
  const int r = threadIdx.x / g.group;
  if (r < step) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[threadIdx.x * VEC + k] = acc[k];
  }
  __syncthreads();
  const int c0 = blockIdx.y * g.group * VEC;
  const int nc = min(g.group * VEC, g.C - c0);
  if (threadIdx.x < nc) {
    float2 t = red[threadIdx.x];
    for (int i = 1; i < step; ++i) {
      const float2 p = red[i * g.group * VEC + threadIdx.x];
      add2(t, p.x, p.y);
    }
    part[(size_t)blockIdx.x * g.C + c0 + threadIdx.x] = t;
  }
  finish(part, tickets + blockIdx.y, c0, nc, g, f, red);
}

template <bool BF16, int BYTES, bool ACT>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const void* __restrict__ x, void* __restrict__ y,
                const float* __restrict__ scale, const float* __restrict__ bias, Stats st,
                Geom g) {
  using E = Elem<BF16>;
  using P = Pack<BF16, BYTES>;
  const RowSpan s = row_span(g);
  if (s.vec < 0) return;
  const bool writer = blockIdx.x == 0 && threadIdx.x < g.group;
  float mean[P::kN], mul[P::kN], b[P::kN];
#pragma unroll
  for (int k = 0; k < P::kN; ++k) {
    const int c = s.vec * P::kN + k;
    const float2 mm = channel_stats(st, g, c, scale[c], writer);
    mean[k] = mm.x;
    mul[k] = mm.y;
    b[k] = bias[c];
  }
#pragma unroll 4
  for (int row = s.row0; row < s.end; row += s.step) {
    const size_t off = (size_t)row * g.C + s.vec * P::kN;
    const P p = load_pack<BF16, BYTES>(x, off);
    P q;
#pragma unroll
    for (int k = 0; k < P::kN; ++k) {
      const float v = pre_act(E::load(p.v[k]), mean[k], mul[k], b[k]);
      q.v[k] = E::store(ACT ? relu6(v) : v);
    }
    store_pack<BF16, BYTES>(y, off, q);
  }
}

template <bool BF16, int BYTES, bool ACT>
__global__ void __launch_bounds__(kThreads)
bn_grad_stats_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float2* __restrict__ part, unsigned* tickets, Geom g, Fin f) {
  using E = Elem<BF16>;
  using P = Pack<BF16, BYTES>;
  __shared__ float2 red[kThreads * kMaxVec];
  const RowSpan s = row_span(g);
  float2 acc[P::kN];
#pragma unroll
  for (int k = 0; k < P::kN; ++k) acc[k] = make_float2(0.f, 0.f);
  if (s.vec >= 0) {
    float mean[P::kN], r[P::kN], mul[P::kN], b[P::kN];
#pragma unroll
    for (int k = 0; k < P::kN; ++k) {
      const int c = s.vec * P::kN + k;
      mean[k] = f.saved[c];
      r[k] = f.saved[g.C + c];
      mul[k] = __fmul_rn(r[k], scale[c]);
      b[k] = bias[c];
    }
#pragma unroll 4
    for (int row = s.row0; row < s.end; row += s.step) {
      const size_t off = (size_t)row * g.C + s.vec * P::kN;
      const P px = load_pack<BF16, BYTES>(x, off);
      const P pg = load_pack<BF16, BYTES>(dy, off);
#pragma unroll
      for (int k = 0; k < P::kN; ++k) {
        const float v = E::load(px.v[k]);
        const float gp = masked<ACT>(E::load(pg.v[k]), v, mean[k], mul[k], b[k]);
        add2(acc[k], gp, __fmul_rn(gp, __fmul_rn(__fsub_rn(v, mean[k]), r[k])));
      }
    }
  }
  reduce_group(acc, part, tickets, g, f, red);
}

template <bool BF16, int BYTES, bool ACT>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                     void* __restrict__ dx, const float* __restrict__ saved,
                     const float* __restrict__ coef, const float* __restrict__ scale,
                     const float* __restrict__ bias, Geom g) {
  using E = Elem<BF16>;
  using P = Pack<BF16, BYTES>;
  const RowSpan s = row_span(g);
  if (s.vec < 0) return;
  float mean[P::kN], r[P::kN], mul[P::kN], b[P::kN], t1[P::kN], t2[P::kN];
#pragma unroll
  for (int k = 0; k < P::kN; ++k) {
    const int c = s.vec * P::kN + k;
    mean[k] = saved[c];
    r[k] = saved[g.C + c];
    mul[k] = __fmul_rn(r[k], scale[c]);
    b[k] = bias[c];
    t1[k] = coef[c];
    t2[k] = coef[g.C + c];
  }
#pragma unroll 4
  for (int row = s.row0; row < s.end; row += s.step) {
    const size_t off = (size_t)row * g.C + s.vec * P::kN;
    const P px = load_pack<BF16, BYTES>(x, off);
    const P pg = load_pack<BF16, BYTES>(dy, off);
    P q;
#pragma unroll
    for (int k = 0; k < P::kN; ++k) {
      const float v = E::load(px.v[k]);
      const float gp = masked<ACT>(E::load(pg.v[k]), v, mean[k], mul[k], b[k]);
      q.v[k] = E::store(mul[k] * (gp - t1[k] - __fmul_rn(__fsub_rn(v, mean[k]), r[k]) * t2[k]));
    }
    store_pack<BF16, BYTES>(dx, off, q);
  }
}

// Expands LAUNCH(B, V) for the runtime (bf16, bytes), each pair taken in a
// case of its own; returns cudaErrorInvalidValue for a pair not taken.
#define TOD_BN_DISPATCH(bf16, bytes, LAUNCH)        \
  do {                                              \
    if (bf16) {                                     \
      switch (bytes) {                              \
        case 16: LAUNCH(true, 16); break;           \
        case 8: LAUNCH(true, 8); break;             \
        case 4: LAUNCH(true, 4); break;             \
        case 2: LAUNCH(true, 2); break;             \
        default: return (int)cudaErrorInvalidValue; \
      }                                             \
    } else {                                        \
      switch (bytes) {                              \
        case 16: LAUNCH(false, 16); break;          \
        case 8: LAUNCH(false, 8); break;            \
        case 4: LAUNCH(false, 4); break;            \
        default: return (int)cudaErrorInvalidValue; \
      }                                             \
    }                                               \
  } while (0)

// The geometry of one call, or false where the arguments do not describe
// a tiling of the tensor (kernels/bn_train.py bn_tiling makes them).
bool geom_of(int bf16, int C, int rows, int bytes, int group, int per, int slices, Geom* g) {
  const int elem = bf16 ? 2 : 4;
  if (C < 1 || rows < 1 || per < 1 || slices < 1 || group < 1 || group > 32) return false;
  if (bytes < elem || bytes > 16 || ((long long)C * elem) % bytes) return false;
  const int hv = C / (bytes / elem);
  if ((long long)rows * C >= (1LL << 31) || (long long)rows + kThreads >= (1LL << 31)) return false;
  if ((hv + group - 1) / group > 65535) return false;
  if ((long long)per * slices < rows || (long long)per * (slices - 1) >= rows) return false;
  *g = Geom{C, rows, hv, group, per, slices, (float)rows};
  return true;
}

dim3 grid_of(const Geom& g) { return dim3(g.slices, (g.hv + g.group - 1) / g.group); }

}  // namespace

// x of bfloat16 (bf16 = 1) or float32, channels last: `rows` N * H * W
// rows of C, read `bytes` at a time; group and the apply pass's (per,
// slices), from kernels/bn_train.py bn_tiling.  mean and sq: (C) float32,
// the batch's E[x] and E[x^2].  saved: (3, C) float32, written; rmean and
// rvar updated in place.
extern "C" int tod_bn_forward(const void* x, void* y, const void* mean, const void* sq,
                              const void* scale, const void* bias, void* rmean, void* rvar,
                              void* saved, int bf16, int act, int C, int rows, int bytes,
                              int group, int apply_per, int apply_slices, float eps,
                              float momentum, float rest, void* stream) {
  Geom ga;
  if (!geom_of(bf16, C, rows, bytes, group, apply_per, apply_slices, &ga)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const Stats s{(const float*)mean, (const float*)sq, (float*)saved, (float*)rmean,
                (float*)rvar, eps, momentum, rest};
#define LAUNCH(B, V)                                                      \
  (act ? bn_apply_kernel<B, V, true> : bn_apply_kernel<B, V, false>)      \
      <<<grid_of(ga), kThreads, 0, st>>>(x, y, (const float*)scale, (const float*)bias, s, ga)
  TOD_BN_DISPATCH(bf16, bytes, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// dy and dx like x; saved from tod_bn_forward; coef: (2, C) float32 scratch;
// dscale and dbias (C) float32, written.
extern "C" int tod_bn_backward(const void* x, const void* dy, void* dx, void* part, void* tickets,
                               const void* saved, void* coef, const void* scale,
                               const void* bias, void* dscale, void* dbias, int bf16, int act,
                               int C, int rows, int bytes, int group, int per, int slices,
                               int apply_per, int apply_slices, void* stream) {
  Geom g, ga;
  if (!geom_of(bf16, C, rows, bytes, group, per, slices, &g) ||
      !geom_of(bf16, C, rows, bytes, group, apply_per, apply_slices, &ga)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid = grid_of(g);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * grid.y, st);
  if (err != cudaSuccess) return (int)err;
  const Fin f{(const float*)saved, (float*)dscale, (float*)dbias, (float*)coef};
#define LAUNCH(B, V)                                                                  \
  (act ? bn_grad_stats_kernel<B, V, true> : bn_grad_stats_kernel<B, V, false>)        \
      <<<grid, kThreads, 0, st>>>(x, dy, (const float*)scale, (const float*)bias,    \
                                  (float2*)part, (unsigned*)tickets, g, f)
  TOD_BN_DISPATCH(bf16, bytes, LAUNCH);
#undef LAUNCH
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define LAUNCH(B, V)                                                                  \
  (act ? bn_grad_apply_kernel<B, V, true> : bn_grad_apply_kernel<B, V, false>)        \
      <<<grid_of(ga), kThreads, 0, st>>>(x, dy, dx, (const float*)saved,             \
                                         (const float*)coef, (const float*)scale,    \
                                         (const float*)bias, ga)
  TOD_BN_DISPATCH(bf16, bytes, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

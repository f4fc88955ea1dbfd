// The static int8 convolution of a conv site: the activations quantized as
// they are loaded, an s8 x s8 -> s32 product, and the rescale, in one launch.
//
// Replaces the int8 convolution of the JAX package's models/qconv.py
// (Conv8, lines 149-179): XLA's s8 x s8 -> s32 conv_general_dilated on the
// TPU, not a Pallas kernel, with the elementwise quantize before it and the
// rescale after it.  torch has no CUDA int8 convolution, and a float
// convolution of the integer values would not be exact on the card (cuDNN
// runs f32 convolutions in TF32 by default, and an f32 sum rounds once it
// passes 2^24), so the port computes it here.
//
// What one launch computes, for output pixel (b, oy, ox) and channel n:
//   xq  = clip(rint(x * (1 / sx[b])), -127, 127)   (x / sx[b] when `divide`,
//                                                    the calibration branch)
//   acc = sum over (ci, ky, kx) of xq * wq[n, ci, ky, kx]      (int32, exact)
//   s   = sx[b] * w_scale[n]                                   (f32, first)
//   a plain site:   y = cast(fma(float(acc), s, bias[n]))
//   a ConvBN site:  y = cast(float(cast(float(acc) * s)) + bias[n])
// with SAME zero padding (pad_t, pad_l given; the far side is the bounds).
// The plain site's fused multiply-add is the JAX graph's: compiled XLA
// contracts acc * s + bias into one.  A ConvBN site's conv has no bias; its
// folded BatchNorm adds the bias in f32 after the conv's cast.  Every
// operation is pinned with an _rn intrinsic, so nvcc contracts nothing else,
// and rint rounds half to even as jnp.round and torch.round do.
//
// Dense sites (groups == 1) are an implicit GEMM: M = B * Ho * Wo output
// pixels, N = Cout, K = Cin * k * k, on the tensor cores with
// mma.sync.m16n8k32.s32.s8.s8.s32.  A block of 4 warps takes a 64 x 64
// output tile and walks K in steps of 32: each thread quantizes 16 values of
// one output pixel's im2col row into shared memory (neighbouring threads on
// neighbouring pixels, so the loads coalesce along a row), the weights are
// copied as bytes, and each warp runs 2 x 4 mma tiles of its 32 x 32
// quarter.  K is padded with zeros inside the kernel (the stem's K = 27).
// Depthwise sites (groups == Cin == Cout) are a direct int32 loop, one
// thread an output value.
//
// Bound: the larger of the bytes (x read once, y written once, the s8
// weights) over 3.35 TB/s and 2 * M * N * K operations over the int8 peak
// (1979 TOP/s).  Most of the model's convolutions are memory-bound at batch
// 1.  This first kernel re-reads x once per 64-channel tile of N and keeps
// no pipeline between the loads and the products; a wgmma kernel with
// TMA-fed tiles is the redesign.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // output pixels a block
constexpr int kBN = 64;       // output channels a block
constexpr int kBK = 32;       // K a step (one mma's depth)
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kDwThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v rounded to the storage type T and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// clip(rint(x * inv), -127, 127) or clip(rint(x / sx), -127, 127)
__device__ __forceinline__ int quantize(float x, float sx, float inv, bool divide) {
  const float v = divide ? __fdiv_rn(x, sx) : __fmul_rn(x, inv);
  return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

template <typename T>
__device__ __forceinline__ void epilogue(T* y, long long at, int acc, float sx, float ws,
                                         const float* bias, int n, bool bn) {
  const float s = __fmul_rn(sx, ws);
  const float a = __int2float_rn(acc);
  store_f(y + at, bn ? __fadd_rn(round_to(__fmul_rn(a, s), y), bias[n])
                    : __fmaf_rn(a, s, bias[n]));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Shape {
  int b, cin, h, w, cout, ho, wo, stride, pad_t, pad_l;
};

// KS: the kernel's side (1 or 3)
template <typename T, int KS>
__global__ void __launch_bounds__(kThreads)
qconv_dense_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ w_scale, const float* __restrict__ sx,
                   int sx_stride, const float* __restrict__ bias, T* __restrict__ y,
                   Shape s, int divide, int bn) {
  __shared__ __align__(16) int8_t as[kBM][kBK];
  __shared__ __align__(16) int8_t bs[kBN][kBK];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's quarter
  const int hw_out = s.ho * s.wo;
  const long long m_total = (long long)s.b * hw_out;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_total = s.cin * KS * KS;

  // this thread's pixel of the A tile and its 16 values of K a step
  const int am = tid & (kBM - 1);
  const int ak = (tid >> 6) * 16;
  const long long pm = m0 + am;
  const bool m_ok = pm < m_total;
  int pb = 0, oy = 0, ox = 0;
  if (m_ok) {
    pb = (int)(pm / hw_out);
    const int r = (int)(pm - (long long)pb * hw_out);
    oy = r / s.wo;
    ox = r - oy * s.wo;
  }
  const float sxb = sx[m_ok ? pb * sx_stride : 0];
  const float inv = __frcp_rn(sxb);
  const int iy0 = oy * s.stride - s.pad_t, ix0 = ox * s.stride - s.pad_l;
  const T* xb = x + (long long)pb * s.cin * s.h * s.w;

  // this thread's 16 bytes of the B tile
  const int bn_row = tid >> 1, bk = (tid & 1) * 16;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    // A: quantize 16 values of the im2col row into 4 words
    unsigned words[4] = {0u, 0u, 0u, 0u};
    if (m_ok) {
      int k = k0 + ak;
      int ci = k / (KS * KS);
      int rem = k - ci * KS * KS;
      int ky = rem / KS, kx = rem - ky * KS;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        int q = 0;
        if (k + i < k_total) {
          const int iy = iy0 + ky, ix = ix0 + kx;
          if (iy >= 0 && iy < s.h && ix >= 0 && ix < s.w) {
            q = quantize(load_f(xb + ((long long)ci * s.h + iy) * s.w + ix), sxb, inv, divide);
          }
        }
        words[i >> 2] |= ((unsigned)(q & 0xff)) << (8 * (i & 3));
        if (++kx == KS) {
          kx = 0;
          if (++ky == KS) {
            ky = 0;
            ++ci;
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(&as[am][ak]) = make_uint4(words[0], words[1], words[2], words[3]);

    // B: 16 weight bytes of one output channel
    {
      const int n = n0 + bn_row;
      unsigned wwords[4] = {0u, 0u, 0u, 0u};
      if (n < s.cout) {
        const int8_t* wrow = wq + (long long)n * k_total;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int k = k0 + bk + i;
          const int v = k < k_total ? (int)wrow[k] : 0;
          wwords[i >> 2] |= ((unsigned)(v & 0xff)) << (8 * (i & 3));
        }
      }
      *reinterpret_cast<uint4*>(&bs[bn_row][bk]) =
          make_uint4(wwords[0], wwords[1], wwords[2], wwords[3]);
    }
    __syncthreads();

    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + g;
      af[i][0] = *reinterpret_cast<const unsigned*>(&as[r][t4 * 4]);
      af[i][1] = *reinterpret_cast<const unsigned*>(&as[r + 8][t4 * 4]);
      af[i][2] = *reinterpret_cast<const unsigned*>(&as[r][16 + t4 * 4]);
      af[i][3] = *reinterpret_cast<const unsigned*>(&as[r + 8][16 + t4 * 4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      bf[j][0] = *reinterpret_cast<const unsigned*>(&bs[c][t4 * 4]);
      bf[j][1] = *reinterpret_cast<const unsigned*>(&bs[c][16 + t4 * 4]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, c2, c3 at row g + 8; columns 2 * t4 + {0, 1}
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + i * 16 + g + half * 8;
      if (m >= m_total) continue;
      const int b = (int)(m / hw_out);
      const int pix = (int)(m - (long long)b * hw_out);
      const float sxm = sx[b * sx_stride];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t4 * 2 + e;
          if (n >= s.cout) continue;
          epilogue(y, ((long long)b * s.cout + n) * hw_out + pix, acc[i][j][half * 2 + e], sxm,
                   w_scale[n], bias, n, bn != 0);
        }
      }
    }
  }
}

// one thread an output value of a depthwise site (groups == Cin == Cout)
template <typename T, int KS>
__global__ void __launch_bounds__(kDwThreads)
qconv_depthwise_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                       const float* __restrict__ w_scale, const float* __restrict__ sx,
                       int sx_stride, const float* __restrict__ bias, T* __restrict__ y,
                       Shape s, int divide, int bn) {
  const long long total = (long long)s.b * s.cout * s.ho * s.wo;
  for (long long at = (long long)blockIdx.x * blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(at % s.wo);
    long long r = at / s.wo;
    const int oy = (int)(r % s.ho);
    r /= s.ho;
    const int c = (int)(r % s.cout);
    const int b = (int)(r / s.cout);
    const float sxb = sx[b * sx_stride];
    const float inv = __frcp_rn(sxb);
    const T* xc = x + ((long long)b * s.cin + c) * s.h * s.w;
    const int8_t* wc = wq + c * KS * KS;
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const int iy = oy * s.stride - s.pad_t + ky;
      if (iy < 0 || iy >= s.h) continue;
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const int ix = ox * s.stride - s.pad_l + kx;
        if (ix < 0 || ix >= s.w) continue;
        acc += quantize(load_f(xc + (long long)iy * s.w + ix), sxb, inv, divide) *
               (int)wc[ky * KS + kx];
      }
    }
    epilogue(y, at, acc, sxb, w_scale[c], bias, c, bn != 0);
  }
}

template <typename T, int KS>
cudaError_t launch(const void* x, const void* wq, const void* w_scale, const void* sx,
                   int sx_stride, const void* bias, void* y, const Shape& s, int groups,
                   int divide, int bn, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* ws = static_cast<const float*>(w_scale);
  const float* sxp = static_cast<const float*>(sx);
  const float* bp = static_cast<const float*>(bias);
  if (groups == 1) {
    const long long m = (long long)s.b * s.ho * s.wo;
    const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((s.cout + kBN - 1) / kBN));
    qconv_dense_kernel<T, KS><<<grid, kThreads, 0, stream>>>(xt, w, ws, sxp, sx_stride, bp, yt,
                                                             s, divide, bn);
  } else {
    const long long total = (long long)s.b * s.cout * s.ho * s.wo;
    long long blocks = (total + kDwThreads - 1) / kDwThreads;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    qconv_depthwise_kernel<T, KS><<<(unsigned)blocks, kDwThreads, 0, stream>>>(
        xt, w, ws, sxp, sx_stride, bp, yt, s, divide, bn);
  }
  return cudaGetLastError();
}

}  // namespace

// x (B, Cin, H, W) and y (B, Cout, Ho, Wo) of one type (dtype 0: f32, 1: bf16),
// wq (Cout, Cin / groups, k, k) s8, w_scale (Cout,) f32, sx (B,) f32 read at
// b * sx_stride (0: one scale for the batch), bias (Cout,) f32.
extern "C" int tod_qconv(const void* x, const void* wq, const void* w_scale, const void* sx,
                         int sx_stride, const void* bias, void* y, int dtype, int b, int cin,
                         int h, int w, int cout, int k, int stride, int pad_t, int pad_l, int ho,
                         int wo, int groups, int divide, int bn, void* stream) {
  if (b < 1 || cin < 1 || cout < 1 || ho < 1 || wo < 1 || stride < 1 || (k != 1 && k != 3) ||
      (groups != 1 && (groups != cin || cout != cin)) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape s{b, cin, h, w, cout, ho, wo, stride, pad_t, pad_l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(k == 1 ? launch<float, 1>(x, wq, w_scale, sx, sx_stride, bias, y, s, groups,
                                           divide, bn, st)
                        : launch<float, 3>(x, wq, w_scale, sx, sx_stride, bias, y, s, groups,
                                           divide, bn, st));
  }
  return (int)(k == 1 ? launch<__nv_bfloat16, 1>(x, wq, w_scale, sx, sx_stride, bias, y, s,
                                                 groups, divide, bn, st)
                      : launch<__nv_bfloat16, 3>(x, wq, w_scale, sx, sx_stride, bias, y, s,
                                                 groups, divide, bn, st));
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

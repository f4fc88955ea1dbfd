// K1: prototype-coefficient mask assembly with the box crop.
//
// Replaces the Pallas kernel kernels/mask_assembly.py of the JAX package,
// assemble_crop_masks (_kernel, lines 28-57):
//
//   out[b, n, y, x] = sigmoid(sum_k coeff[b, n, k] * proto[b, y, x, k])
//                     if the pixel centre ((y + .5) / Hm, (x + .5) / Wm) lies
//                     in box n (y1 x1 y2 x2, inclusive), else 0.
//
// Bound: at the main path's shapes (B=1, N=32, K=32, 64x80 prototypes) the
// kernel reads 0.66 MB of prototypes and writes 0.66 MB of masks: about
// 0.4 us at 3.35 TB/s, against 10.5 MFLOP of f32 work (0.16 us at 67 TFLOP/s
// on the CUDA cores).  At that size it is bound by latency: one DRAM round
// trip to stage, then a short burst of arithmetic and stores.  The tensor
// cores stay out: TF32 rounds both operands to 10 mantissa bits (~1e-3 on the
// logits), far outside the 2e-6 the kernel is held to.
//
// Design (tiling from kernels/mask_assembly.py mask_tiling): a block takes a
// tile of `pixels` consecutive pixels of one image (a multiple of 32) and
// every detection, so the prototypes leave device memory once.  Their slab
// is contiguous in memory and arrives in shared memory as one bulk copy
// (bulk_copy.cuh) in a single round trip, with no index arithmetic per
// element; a slab whose K is not a multiple of 4, or whose address is not
// 16-byte aligned, is staged by plain loads into the same zero-padded layout
// instead.  The coefficients and boxes are staged beside it.  Warp w takes
// the 32-pixel slice w % slices for the detections g, g + groups, ... with
// g = w / slices: each thread holds its pixel's K prototype values in
// registers (read starting at its lane's own float4 so that the lanes of a
// quarter-warp hit distinct banks, then rotated back), forms 4 detections'
// dot products as independent chains, each over k in order, against the
// coefficients read as float4 broadcasts (one shared load per 4 FMAs), and
// each warp stores 128 contiguous bytes of one detection's row.  The pixel
// centres use IEEE division (no fast math), so the crop decisions are
// identical to the plain torch version's.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"

namespace {

constexpr int kMaxK4 = 8;  // K <= 32: a thread's prototypes in 8 float4 registers
constexpr int kDets = 4;   // detections a thread forms at once

template <int K4>
__global__ void __launch_bounds__(512)
mask_assembly_kernel(const float* __restrict__ protos, const float* __restrict__ coeffs,
                     const float* __restrict__ boxes, float* __restrict__ out, int n, int hm,
                     int wm, int k, int pixels, int groups) {
  constexpr int kp = 4 * K4;  // a row in shared memory, zero-padded to whole float4s
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_proto = reinterpret_cast<float*>(smem + 16);  // pixels x kp
  float* s_coeff = s_proto + pixels * kp;                 // n x kp
  float* s_box = s_coeff + n * kp;                        // n x 4

  const int hw = hm * wm;
  const int tiles = (hw + pixels - 1) / pixels;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * pixels;
  const int np = min(pixels, hw - p0);
  const int tid = threadIdx.x;
  const float* src = protos + ((size_t)b * hw + p0) * k;
  // with k == kp the slab's size, np * k * 4 bytes, is a multiple of 16
  const bool bulk = k == kp && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (bulk && tid == 0) {
    tod::bulk_init(bar);
    const uint32_t bytes = (uint32_t)(np * k * sizeof(float));
    tod::bulk_expect(bar, bytes);
    tod::bulk_load(s_proto, src, bytes, bar);
  }
  if (!bulk) {
    for (int i = tid; i < np * kp; i += blockDim.x) {
      const int px = i / kp;
      const int c = i - px * kp;
      s_proto[i] = c < k ? src[px * k + c] : 0.0f;
    }
  }
  const float* c_src = coeffs + (size_t)b * n * k;
  for (int i = tid; i < n * kp; i += blockDim.x) {
    const int j = i / kp;
    const int c = i - j * kp;
    s_coeff[i] = c < k ? c_src[j * k + c] : 0.0f;
  }
  const float* b_src = boxes + (size_t)b * n * 4;
  for (int i = tid; i < n * 4; i += blockDim.x) s_box[i] = b_src[i];
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slices = pixels >> 5;
  const int px = (warp % slices) * 32 + lane;
  const int g = warp / slices;
  if (px >= np) return;
  if (bulk) tod::bulk_wait(bar, 0);

  // q[s] = the pixel's float4 (s + r) % K4, then rotated by r so that
  // q[c] holds float4 c: the rotation is three rounds of selects
  const int r = lane % K4;
  const float4* row = reinterpret_cast<const float4*>(s_proto + px * kp);
  float4 q[K4];
#pragma unroll
  for (int s = 0; s < K4; ++s) q[s] = row[(s + r) % K4];
#pragma unroll
  for (int bit = 1; bit < K4; bit <<= 1) {
    const bool on = (r & bit) != 0;
    float4 t[K4];
#pragma unroll
    for (int c = 0; c < K4; ++c) t[c] = on ? q[(c - bit + K4) % K4] : q[c];
#pragma unroll
    for (int c = 0; c < K4; ++c) q[c] = t[c];
  }

  const int p = p0 + px;
  const int y = p / wm;
  const int x = p - y * wm;
  const float ys = ((float)y + 0.5f) / (float)hm;
  const float xs = ((float)x + 0.5f) / (float)wm;
  float* dst = out + (size_t)b * n * hw + p;
  for (int j0 = g; j0 < n; j0 += kDets * groups) {
    const float* cj[kDets];
    float acc[kDets];
#pragma unroll
    for (int u = 0; u < kDets; ++u) {
      cj[u] = s_coeff + min(j0 + u * groups, n - 1) * kp;
      acc[u] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < K4; ++s) {
#pragma unroll
      for (int u = 0; u < kDets; ++u) {
        const float4 c = reinterpret_cast<const float4*>(cj[u])[s];
        acc[u] = fmaf(c.x, q[s].x, acc[u]);
        acc[u] = fmaf(c.y, q[s].y, acc[u]);
        acc[u] = fmaf(c.z, q[s].z, acc[u]);
        acc[u] = fmaf(c.w, q[s].w, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDets; ++u) {
      const int j = j0 + u * groups;
      if (j >= n) break;
      const float4 box = reinterpret_cast<const float4*>(s_box)[j];
      const bool inside = ys >= box.x && ys <= box.z && xs >= box.y && xs <= box.w;
      dst[(size_t)j * hw] = inside ? 1.0f / (1.0f + expf(-acc[u])) : 0.0f;
    }
  }
}

template <int K4>
int launch(const float* protos, const float* coeffs, const float* boxes, float* out, int blocks,
           int n, int hm, int wm, int k, int pixels, int groups, cudaStream_t stream) {
  const size_t smem = 16 + sizeof(float) * ((size_t)(pixels + n) * 4 * K4 + 4 * (size_t)n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_assembly_kernel<K4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mask_assembly_kernel<K4><<<blocks, pixels * groups, smem, stream>>>(
      protos, coeffs, boxes, out, n, hm, wm, k, pixels, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// pixels (a multiple of 32) and groups from kernels/mask_assembly.py mask_tiling.
extern "C" int tod_mask_assembly(const void* protos, const void* coeffs, const void* boxes,
                                 void* out, int batch, int n, int hm, int wm, int k, int pixels,
                                 int groups, void* stream) {
  if (k < 1 || k > 4 * kMaxK4 || pixels < 32 || pixels % 32 || groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = batch * ((hm * wm + pixels - 1) / pixels);
  const auto* p = (const float*)protos;
  const auto* c = (const float*)coeffs;
  const auto* bx = (const float*)boxes;
  auto* o = (float*)out;
  auto* s = (cudaStream_t)stream;
  switch ((k + 3) / 4) {
    case 1: return launch<1>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    case 2: return launch<2>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    case 3: return launch<3>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    case 4: return launch<4>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    case 5: return launch<5>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    case 6: return launch<6>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    case 7: return launch<7>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
    default: return launch<8>(p, c, bx, o, blocks, n, hm, wm, k, pixels, groups, s);
  }
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2: 8-neighbour connection weights of a height map.
//
// Replaces the Pallas kernel kernels/connections.py of the JAX package,
// connection_weights (_kernel, lines 27-33):
//
//   conn[y, x, i] = sqrt(dx_i^2 + dy_i^2 + (h[y, x] - h[y + dy_i, x + dx_i])^2)
//                   or -1 where the neighbour is off the grid or NaN,
//
// with the offsets in NEIGHBOR_OFFSETS order [N, NE, E, SE, S, SW, W, NW].
// As in the TPU kernel, the world positions (x, h, y) are not its work: the
// wrapper forms them outside, and the planner does not ask for them.
//
// Bound: at 480x640 the kernel reads 1.2 MB of heights and writes 9.8 MB of
// weights, about 3.3 us at 3.35 TB/s; its arithmetic is a few operations a
// byte, so it is bytes-bound.
//
// Design (tiling from kernels/connections.py connection_tiling): a block
// takes a band of `rows` whole rows, so its output is one contiguous slab of
// the (H, W, 8) layout the planner reads; with more bands than SMs (2 rows
// a band at 480x640) one band's load overlaps another's stores.  It stages
// the band's heights with a one-node halo in shared memory: each row
// arrives by one bulk copy (bulk_copy.cuh) when a row is a whole number of
// float4s, else by coalesced loads (at 480x640 on an H100 the kernel takes
// 4.4 us with the bulk copies, 5.7 us with coalesced loads for every row:
// tools/block_sweep.py k2); nodes off the grid are NaN, the TPU
// kernel's own padding, so the inner loop has no bounds tests and a NaN
// neighbour gives -1 as a missing one does.  A staged row is padded to
// `stride` floats with stride = 8 (mod 16), so that the N and S reads of a
// warp fall in disjoint banks.
// Then lane i of the block writes float4 i, i + threads, ... of the slab:
// the first float4 of a node holds its N, NE, E, SE weights and the second
// its S, SW, W, NW, the same offsets negated, so every store instruction
// fills whole lines.  The squared distance is one fused multiply-add,
// dd + diff^2 rounded once, as compiled JAX forms it, and sqrtf is IEEE, so
// the result equals the plain torch version (which rounds the float64 sum
// once) bit for bit; a NaN centre with a number as its neighbour gives NaN
// there too.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"

namespace {

// Built with -DTOD_K2_BULK=0, every row is staged by coalesced loads
// (tools/block_sweep.py k2 times the two routes against each other).
#ifndef TOD_K2_BULK
#define TOD_K2_BULK 1
#endif

constexpr int kThreads = 512;  // threads a block
constexpr int kCol = 4;        // column of node x = 0 in a staged row (16-byte aligned)

__global__ void __launch_bounds__(kThreads)
connections_kernel(const float* __restrict__ height, float* __restrict__ conn, int h, int w,
                   int rows, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s = reinterpret_cast<float*>(smem + 16);  // node (y0 - 1 + r, x) at r * stride + kCol + x

  const int tid = threadIdx.x;
  const int y0 = blockIdx.x * rows;
  const int nr = min(rows, h - y0);
  const int r_lo = y0 == 0 ? 1 : 0;  // staged rows on the grid: [r_lo, r_hi)
  const int r_hi = y0 + nr == h ? nr + 1 : nr + 2;
  const float nan = __int_as_float(0x7fc00000);
  const bool bulk = TOD_K2_BULK && w % 4 == 0 && (reinterpret_cast<uintptr_t>(height) & 15) == 0;
  if (bulk && tid == 0) {
    tod::bulk_init(bar);
    const uint32_t row_bytes = (uint32_t)(w * sizeof(float));
    tod::bulk_expect(bar, (uint32_t)(r_hi - r_lo) * row_bytes);
    for (int r = r_lo; r < r_hi; ++r) {
      tod::bulk_load(s + r * stride + kCol, height + (size_t)(y0 - 1 + r) * w, row_bytes, bar);
    }
  }
  // the halo: both side columns of every staged row, and rows off the grid
  for (int r = tid; r < nr + 2; r += kThreads) {
    s[r * stride + kCol - 1] = nan;
    s[r * stride + kCol + w] = nan;
  }
  for (int x = tid; x < w; x += kThreads) {
    if (r_lo == 1) s[kCol + x] = nan;
    if (r_hi == nr + 1) s[(nr + 1) * stride + kCol + x] = nan;
  }
  if (!bulk) {
    for (int r = r_lo; r < r_hi; ++r) {
      const float* src = height + (size_t)(y0 - 1 + r) * w;
      for (int x = tid; x < w; x += kThreads) s[r * stride + kCol + x] = src[x];
    }
  }
  __syncthreads();
  if (bulk) tod::bulk_wait(bar, 0);

  // float4 f of the slab: node f / 2 of the band, half f % 2
  const int row4 = 2 * w;
  const int total = nr * row4;
  float4* dst = reinterpret_cast<float4*>(conn + (size_t)y0 * w * 8);
  int ty = 0;
  int x2 = tid;
  while (x2 >= row4) {
    x2 -= row4;
    ++ty;
  }
  for (int f = tid; f < total; f += kThreads) {
    const float* cp = s + (ty + 1) * stride + kCol + (x2 >> 1);
    const float c = *cp;
    const int sg = (x2 & 1) ? -1 : 1;
    // N, NE, E, SE; negated: S, SW, W, NW
    const int off[4] = {-stride * sg, (1 - stride) * sg, sg, (stride + 1) * sg};
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float nh = cp[off[i]];
      const float diff = __fsub_rn(c, nh);
      v[i] = isnan(nh) ? -1.0f : sqrtf(__fmaf_rn(diff, diff, (i & 1) ? 2.0f : 1.0f));
    }
    dst[f] = make_float4(v[0], v[1], v[2], v[3]);
    x2 += kThreads;
    while (x2 >= row4) {
      x2 -= row4;
      ++ty;
    }
  }
}

}  // namespace

// rows and stride from kernels/connections.py connection_tiling.
extern "C" int tod_connections(const void* height, void* conn, int h, int w, int rows,
                               int stride, void* stream) {
  if (rows < 1 || stride < w + kCol + 1 || stride % 4) return (int)cudaErrorInvalidValue;
  const int blocks = (h + rows - 1) / rows;
  const size_t smem = 16 + sizeof(float) * (size_t)(rows + 2) * stride;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        connections_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  connections_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)height, (float*)conn, h, w, rows, stride);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

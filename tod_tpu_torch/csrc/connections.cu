// K2: world positions and 8-neighbour connection weights of a height map.
//
// Replaces the Pallas kernel kernels/connections.py of the JAX package,
// connection_weights (_kernel, lines 27-33):
//
//   conn[y, x, i] = sqrt(dx_i^2 + dy_i^2 + (h[y, x] - h[y + dy_i, x + dx_i])^2)
//                   or -1 where the neighbour is off the grid or NaN,
//   pos[y, x]     = (x, h[y, x], y),
//
// with the offsets in NEIGHBOR_OFFSETS order [N, NE, E, SE, S, SW, W, NW].
//
// Bound: at 480x640 the kernel reads 1.2 MB and writes 9.8 MB of weights and
// 3.7 MB of positions, about 4.4 us at 3.35 TB/s; its arithmetic is a few
// operations per byte, so it is bytes-bound.
//
// Design: one thread per pixel.  A thread reads its 3x3 neighbourhood (the
// rows overlap between neighbouring threads and come from L1/L2) and writes
// its 8 weights as two float4 stores straight into the (H, W, 8) layout the
// planner consumes, so no transpose pass follows, plus its three pos floats.
// The TPU kernel's NaN padding becomes a bounds test.  The squared distance
// is one fused multiply-add, dd + diff^2 rounded once, as compiled JAX forms
// it, and sqrtf is IEEE, so the result equals the plain torch version (which
// rounds the float64 sum once) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
__constant__ int kDy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
__constant__ int kDx[8] = {0, 1, 1, 1, 0, -1, -1, -1};

__global__ void connections_kernel(const float* __restrict__ height,
                                   float* __restrict__ conn,
                                   float* __restrict__ pos, int h, int w) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h * w) return;
  const int y = p / w;
  const int x = p - y * w;
  const float c = height[p];
  float d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ny = y + kDy[i];
    const int nx = x + kDx[i];
    float v = -1.0f;
    if (ny >= 0 && ny < h && nx >= 0 && nx < w) {
      const float nh = height[ny * w + nx];
      if (!isnan(nh)) {
        const float diff = __fsub_rn(c, nh);
        const float dd = (float)(kDy[i] * kDy[i] + kDx[i] * kDx[i]);
        v = sqrtf(__fmaf_rn(diff, diff, dd));
      }
    }
    d[i] = v;
  }
  float4* out = reinterpret_cast<float4*>(conn + (size_t)p * 8);
  out[0] = make_float4(d[0], d[1], d[2], d[3]);
  out[1] = make_float4(d[4], d[5], d[6], d[7]);
  float* q = pos + (size_t)p * 3;
  q[0] = (float)x;
  q[1] = c;
  q[2] = (float)y;
}

}  // namespace

extern "C" int tod_connections(const void* height, void* conn, void* pos,
                               int h, int w, void* stream) {
  const int blocks = (h * w + kThreads - 1) / kThreads;
  connections_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)height, (float*)conn, (float*)pos, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

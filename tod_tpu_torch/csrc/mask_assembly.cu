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
// 0.4 us at 3.35 TB/s, against 10.5 MFLOP of f32 work (0.16 us at 67 TFLOP/s).
// It is bytes-bound on paper and launch-bound in practice.
//
// Design: a block takes 128 pixels of one image and a group of 8 detections
// (grid x over pixel tiles, grid y over images x detection groups).  It
// copies the tile's 128 x K prototype floats, contiguous in memory, into
// shared memory with coalesced loads, 8 in flight per thread (with few warps
// per SM, loads issued one at a time left the kernel latency-bound), one row
// per pixel padded to K + 1 floats so that the threads' row reads fall in
// distinct banks.  Each thread
// then owns one pixel: it forms the 8 detections' K-term dot products in f32
// as 8 interleaved chains against the coefficients (a shared-memory
// broadcast), applies 1 / (1 + expf(-x)) inside each box, and writes its 8
// mask values; neighbouring threads write neighbouring pixels.  The prototypes are read
// from device memory once and from L2 once per further detection group.
// The pixel centres use IEEE division (no fast math), so the crop decisions
// are identical to the plain torch version's.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 128;  // pixels per block, one per thread
constexpr int kDets = 8;      // detections per block
constexpr int kBatch = 8;     // staging loads in flight per thread

__global__ void mask_assembly_kernel(const float* __restrict__ protos,
                                     const float* __restrict__ coeffs,
                                     const float* __restrict__ boxes,
                                     float* __restrict__ out,
                                     int n, int hm, int wm, int k) {
  extern __shared__ float smem[];
  float* s_proto = smem;                         // kPixels x (k + 1)
  float* s_coeff = s_proto + kPixels * (k + 1);  // kDets x k
  float* s_box = s_coeff + kDets * k;            // kDets x 4

  const int groups = (n + kDets - 1) / kDets;
  const int b = blockIdx.y / groups;
  const int d0 = (blockIdx.y % groups) * kDets;
  const int nd = min(kDets, n - d0);
  const int hw = hm * wm;
  const int p0 = blockIdx.x * kPixels;
  const int np = min(kPixels, hw - p0);

  // stage the tile: each thread issues kBatch independent coalesced loads
  // before it stores any, so that their latencies overlap
  const float* src = protos + ((size_t)b * hw + p0) * k;
  const int tile = np * k;
  for (int base = threadIdx.x; base < tile; base += kPixels * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kPixels;
      v[u] = i < tile ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kPixels;
      if (i < tile) s_proto[(i / k) * (k + 1) + i % k] = v[u];
    }
  }
  const float* c_src = coeffs + ((size_t)b * n + d0) * k;
  for (int i = threadIdx.x; i < kDets * k; i += blockDim.x) {
    s_coeff[i] = i < nd * k ? c_src[i] : 0.0f;  // a short last group reads zeros
  }
  const float* b_src = boxes + ((size_t)b * n + d0) * 4;
  for (int i = threadIdx.x; i < nd * 4; i += blockDim.x) s_box[i] = b_src[i];
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= np) return;
  const int p = p0 + t;
  const int y = p / wm;
  const int x = p - y * wm;
  const float ys = ((float)y + 0.5f) / (float)hm;
  const float xs = ((float)x + 0.5f) / (float)wm;
  const float* row = s_proto + t * (k + 1);
  // the 8 detections' dot products as independent chains (each still sums
  // over k in order), so the shared-memory loads overlap
  float acc[kDets];
#pragma unroll
  for (int j = 0; j < kDets; ++j) acc[j] = 0.0f;
  for (int i = 0; i < k; ++i) {
    const float r = row[i];
#pragma unroll
    for (int j = 0; j < kDets; ++j) acc[j] = fmaf(s_coeff[j * k + i], r, acc[j]);
  }
  float* dst = out + ((size_t)b * n + d0) * hw + p;
#pragma unroll
  for (int j = 0; j < kDets; ++j) {
    if (j >= nd) break;
    const float* box = s_box + 4 * j;
    const bool inside = ys >= box[0] && ys <= box[2] && xs >= box[1] && xs <= box[3];
    dst[(size_t)j * hw] = inside ? 1.0f / (1.0f + expf(-acc[j])) : 0.0f;
  }
}

}  // namespace

extern "C" int tod_mask_assembly_smem_bytes(int k) {
  return (int)((kPixels * (k + 1) + kDets * k + kDets * 4) * sizeof(float));
}

extern "C" int tod_mask_assembly(const void* protos, const void* coeffs,
                                 const void* boxes, void* out, int batch, int n,
                                 int hm, int wm, int k, void* stream) {
  const int groups = (n + kDets - 1) / kDets;
  const dim3 grid((hm * wm + kPixels - 1) / kPixels, batch * groups);
  mask_assembly_kernel<<<grid, kPixels, tod_mask_assembly_smem_bytes(k),
                         (cudaStream_t)stream>>>(
      (const float*)protos, (const float*)coeffs, (const float*)boxes,
      (float*)out, n, hm, wm, k);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

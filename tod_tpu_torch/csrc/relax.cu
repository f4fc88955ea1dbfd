// Bellman-Ford relaxation of the grid planner to a fixpoint, then the
// next-hop argmin, in one cooperative launch.
//
// Replaces the relaxation of the JAX package's planner/tpu_relax.py
// (bellman_ford_grid, lines 50-79).  That is an XLA while loop, not a Pallas
// kernel: the TPU runs the whole loop on the device, so a planning dispatch
// returns at once.  This kernel does the same on the card: the host enqueues
// one launch and reads nothing back.
//
// Each sweep is a Jacobi sweep over all nodes, from one distance buffer into
// the other:
//
//   c_i = (dist[n + off_i] + edge_i) + |height[n] - height[n + off_i]|
//         where edge_i >= 0, INF otherwise
//   new = min(dist[n], min_i c_i)
//
// off-grid neighbours read dist = INF and height = 0, as the plain version's
// padding does.  The loop stops after the first sweep that changes nothing,
// or after max_iters sweeps; `sweeps` counts that last sweep.  The epilogue
// writes next_dir = the first argmin of the final candidates in
// NEIGHBOR_OFFSETS order, -1 at seeds and unreached nodes.  There are no
// multiplies, so nothing contracts into an FMA, and the additions keep the
// plain version's order: the results are its bits.  The inputs are those of
// the planner: connection weights from K2, which has no edge at a NaN height,
// so no candidate is NaN.
//
// Bound: each sweep reads every node's 8 edges, 9 heights and 9 distances and
// writes one distance; 24 additions, compares and selects a node.  At 480x640
// the inputs (12 MB) stay in L2 and each SM's share of the edges and heights
// stays in its L1 across sweeps (the same threads visit the same nodes every
// sweep), so a sweep's bytes and operations take well under a microsecond.
// What bounds it is the grid-wide barrier and its memory fence between
// sweeps (~700 at 480x640), which the bytes-and-operations bound does not
// see: a sweep costs ~5.7 us on an H100 at the best block shapes and more
// with more blocks to synchronise (tools/block_sweep.py, PERF.md); issuing
// several nodes' loads a thread at once did not shorten it.
//
// Design: one cooperative launch with every block resident (the grid is
// sized by the occupancy calculator), a grid-stride loop over the nodes, and
// cg::this_grid().sync() after each sweep.  A block ORs its threads' change
// bits and sets flags[sweep]; after the barrier every thread reads the same
// flag, so all blocks stop together.  Distances written in one sweep and read
// in the next bypass L1 (__ldcg); edges and heights never change and use the
// read-only path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Block shape: one block of 512 threads on each SM was the fastest shape that
// tools/block_sweep.py timed on an H100 (PERF.md): fewer blocks make the grid
// barrier cheaper.  The sweep overrides both with -D.
#ifndef TOD_THREADS
#define TOD_THREADS 512
#endif
#ifndef TOD_BLOCKS_PER_SM
#define TOD_BLOCKS_PER_SM 1
#endif
constexpr int kThreads = TOD_THREADS;
constexpr int kBlocksPerSm = TOD_BLOCKS_PER_SM;
constexpr float kInf = 3.4e38f;  // "unreached", as the plain version's INF
__constant__ int kDy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
__constant__ int kDx[8] = {0, 1, 1, 1, 0, -1, -1, -1};

// The smallest candidate entering node n from `dist`, and its first index.
__device__ __forceinline__ float best_candidate(const float* __restrict__ height,
                                                const float* __restrict__ conns,
                                                const float* dist, int h, int w, int n,
                                                int* best_i) {
  const int y = n / w, x = n - y * w;
  const float hc = __ldg(height + n);
  const float4 e0 = __ldg(reinterpret_cast<const float4*>(conns) + 2 * n);
  const float4 e1 = __ldg(reinterpret_cast<const float4*>(conns) + 2 * n + 1);
  const float edge[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
  float best = INFINITY;
  int bi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ny = y + kDy[i], nx = x + kDx[i];
    const bool on = ny >= 0 && ny < h && nx >= 0 && nx < w;
    const int m = ny * w + nx;
    const float dn = on ? __ldcg(dist + m) : kInf;
    const float hn = on ? __ldg(height + m) : 0.0f;
    const float c = edge[i] >= 0.0f ? (dn + edge[i]) + fabsf(hc - hn) : kInf;
    if (c < best) {
      best = c;
      bi = i;
    }
  }
  *best_i = bi;
  return best;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
relax_kernel(const float* __restrict__ height, const float* __restrict__ conns,
             const unsigned char* __restrict__ seed, float* dist, float* scratch,
             long long* __restrict__ next_dir, int* flags, int* sweeps_out, int h, int w,
             int max_iters) {
  cg::grid_group grid = cg::this_grid();
  const int n_nodes = h * w;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int n = first; n < n_nodes; n += stride) dist[n] = seed[n] ? 0.0f : kInf;
  grid.sync();

  float* src = dist;
  float* dst = scratch;
  int sweeps = 0;
  while (sweeps < max_iters) {
    int changed = 0;
    for (int n = first; n < n_nodes; n += stride) {
      int bi;
      const float c = best_candidate(height, conns, src, h, w, n, &bi);
      const float d = __ldcg(src + n);
      const float nv = fminf(d, c);
      changed |= nv < d;
      dst[n] = nv;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) flags[sweeps] = 1;
    grid.sync();
    float* t = src;
    src = dst;
    dst = t;
    if (!*(volatile int*)(flags + sweeps++)) break;
  }

  for (int n = first; n < n_nodes; n += stride) {
    int bi;
    best_candidate(height, conns, src, h, w, n, &bi);
    const float d = __ldcg(src + n);
    next_dir[n] = (seed[n] || !(d < kInf)) ? -1 : bi;
    if (src != dist) dist[n] = d;
  }
  if (first == 0) *sweeps_out = sweeps;
}

}  // namespace

// height (h, w) f32, conns (h, w, 8) f32 (16-byte aligned), seed (h, w) bool
// -> dist (h, w) f32, next_dir (h, w) int64, sweeps int32; scratch is a
// second (h, w) f32 buffer, flags max_iters + 1 int32 (cleared here).
extern "C" int tod_relax(const void* height, const void* conns, const void* seed, void* dist,
                         void* scratch, void* next_dir, void* flags, void* sweeps, int h, int w,
                         int max_iters, void* stream) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long n_nodes = (long long)h * w;
  long long blocks = (n_nodes + kThreads - 1) / kThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(flags, 0, sizeof(int) * ((size_t)max_iters + 1), s);
  if (err != cudaSuccess) return (int)err;
  const float* a0 = (const float*)height;
  const float* a1 = (const float*)conns;
  const unsigned char* a2 = (const unsigned char*)seed;
  float* a3 = (float*)dist;
  float* a4 = (float*)scratch;
  long long* a5 = (long long*)next_dir;
  int* a6 = (int*)flags;
  int* a7 = (int*)sweeps;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &h, &w, &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)relax_kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

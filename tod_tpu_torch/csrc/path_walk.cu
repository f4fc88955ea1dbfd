// Path walk: follow the relaxation's next-hop map from the start node and
// write the plan buffer, on the card.
//
// Replaces the path walk of the JAX package's planner/tpu_relax.py
// (plan_on_device, the walk at lines 131-212).  That walk is XLA code,
// not a Pallas kernel; it runs on the device so that the host reads back only
// the plan (8 KB) instead of the distance and next-hop maps.
//
//   plan[0]     = (n_valid, truncated)
//   plan[1 + i] = (dist[node_i] - dist[node_i+1], turn) for hop i,
//                 zeros past n_valid; all zeros when the start is unreached.
//
// Unsigned turns: the angle between the segments (node_i-1 <- node_i) and
// (node_i -> node_i+1), the first one 0.  Signed turns: the atan2 turn from
// the heading (initially up the map, then the previous hop's segment: every
// hop of the relaxation's map moves) to hop i's segment.
//
// Bound: a walk of n hops reads n + 1 entries of each map (12 bytes a hop)
// and writes the (max_steps + 1) x 2 plan: about 14 KB at n = 530, a few
// nanoseconds of bandwidth.  A walk done hop by hop is bound by latency, one
// dependent memory round trip a hop (~0.6 us, 0.32 ms at 530 hops).
//
// Design: pointer doubling, in one cooperative launch.  Level 0 is the
// successor map over the whole grid (a self-loop at seeds and unreached
// nodes); level k is the 2^k-th successor, built from level k - 1 in one
// grid-wide pass, with a grid barrier between passes: levels =
// bit_length(max_steps) passes of independent loads in place of up to
// max_steps dependent ones.  Then every plan row has its own thread: it
// finds node i - 1 from the start by the binary digits of i - 1 (at most
// `levels` dependent lookups), steps to nodes i and i + 1, and writes its
// row.  Terminal nodes loop on themselves, so node i is live exactly when
// i < the path's length, and a row past n_valid finds a terminal node and
// writes zeros.  One more thread writes the header by binary lifting: the
// last live node within max_steps.  The turn math is the serial walk's: IEEE
// sqrtf and division (no fast math), acosf and atan2f, which may differ from
// the plain version's float32 numpy in the last bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Block shape: one block of 1024 threads on each SM was the fastest shape that
// tools/block_sweep.py timed on an H100 (PERF.md): fewer blocks make the grid
// barrier cheaper.  The sweep overrides both with -D.
#ifndef TOD_THREADS
#define TOD_THREADS 1024
#endif
#ifndef TOD_BLOCKS_PER_SM
#define TOD_BLOCKS_PER_SM 1
#endif
constexpr int kThreads = TOD_THREADS;
constexpr int kBlocksPerSm = TOD_BLOCKS_PER_SM;
constexpr float kInf = 3.4e38f;  // the relaxation's "unreached" distance
__constant__ int kDy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
__constant__ int kDx[8] = {0, 1, 1, 1, 0, -1, -1, -1};

__device__ __forceinline__ bool live(const long long* __restrict__ next_dir, int n) {
  return __ldg(next_dir + n) >= 0;
}

// The node `steps` hops after `node`, through the doubling levels.
__device__ __forceinline__ int advance(const int* succ, int n_nodes, int node, int steps) {
  for (int k = 0; steps; ++k, steps >>= 1)
    if (steps & 1) node = __ldcg(succ + (size_t)k * n_nodes + node);
  return node;
}

__global__ void __launch_bounds__(kThreads)
path_walk_kernel(const float* __restrict__ dist, const long long* __restrict__ next_dir,
                 int* succ, float* __restrict__ plan, int n_nodes, int w, int start,
                 int max_steps, int levels, int signed_turns) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int n = first; n < n_nodes; n += stride) {
    const long long d = __ldg(next_dir + n);
    succ[n] = d >= 0 ? n + kDy[d] * w + kDx[d] : n;
  }
  for (int k = 1; k < levels; ++k) {
    grid.sync();
    const int* prev = succ + (size_t)(k - 1) * n_nodes;
    int* cur = succ + (size_t)k * n_nodes;
    for (int n = first; n < n_nodes; n += stride) cur[n] = __ldcg(prev + __ldcg(prev + n));
  }
  grid.sync();

  const bool reached = __ldg(dist + start) < kInf;
  for (int i = first; i <= max_steps; i += stride) {
    if (i == max_steps) {  // the header: the last live node within max_steps hops
      float n_valid = 0.0f, truncated = 0.0f;
      if (reached && live(next_dir, start)) {
        int node = start, pos = 0;
        for (int k = levels - 1; k >= 0; --k) {
          if (pos + (1 << k) > max_steps) continue;
          const int ahead = __ldcg(succ + (size_t)k * n_nodes + node);
          if (live(next_dir, ahead)) {
            node = ahead;
            pos += 1 << k;
          }
        }
        n_valid = (float)(pos == max_steps ? max_steps : pos + 1);
        truncated = pos == max_steps ? 1.0f : 0.0f;
      }
      plan[0] = n_valid;
      plan[1] = truncated;
      continue;
    }
    float* row = plan + 2 * (1 + i);
    const int prev = i > 0 ? advance(succ, n_nodes, start, i - 1) : start;
    const int cur = i > 0 ? __ldcg(succ + prev) : start;
    if (!reached || !live(next_dir, cur)) {
      row[0] = 0.0f;
      row[1] = 0.0f;
      continue;
    }
    const int nxt = __ldcg(succ + cur);
    row[0] = __ldg(dist + cur) - __ldg(dist + nxt);
    if (signed_turns) {
      float hx = 0.0f, hz = -1.0f;
      if (i > 0) {
        hx = (float)(cur % w - prev % w);
        hz = (float)(cur / w - prev / w);
      }
      const float sx = (float)(nxt % w - cur % w);
      const float sz = (float)(nxt / w - cur / w);
      const bool moved = sx != 0.0f || sz != 0.0f;
      row[1] = moved ? atan2f(hx * sz - hz * sx, hx * sx + hz * sz) : 0.0f;
    } else if (i == 0) {
      row[1] = 0.0f;
    } else {
      const float ax = (float)(prev % w - cur % w), ay = (float)(prev / w - cur / w);
      const float bx = (float)(nxt % w - cur % w), by = (float)(nxt / w - cur / w);
      const float na = sqrtf(ax * ax + ay * ay);
      const float nb = sqrtf(bx * bx + by * by);
      const float c = fminf(fmaxf((ax * bx + ay * by) / fmaxf(na * nb, 1e-12f), -1.0f), 1.0f);
      row[1] = (na > 0.0f && nb > 0.0f) ? acosf(c) : 0.0f;
    }
  }
}

}  // namespace

// dist (h*w) f32, next_dir (h*w) int64 -> plan (max_steps + 1, 2) f32;
// succ is scratch of levels * h * w int32, levels = max(1, bit_length(max_steps)).
extern "C" int tod_path_walk(const void* dist, const void* next_dir, void* succ, void* plan,
                             int n_nodes, int w, int start, int max_steps, int levels,
                             int signed_turns, void* stream) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, path_walk_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long items = n_nodes > max_steps + 1 ? n_nodes : max_steps + 1;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  const float* a0 = (const float*)dist;
  const long long* a1 = (const long long*)next_dir;
  int* a2 = (int*)succ;
  float* a3 = (float*)plan;
  void* args[] = {&a0, &a1, &a2, &a3, &n_nodes, &w, &start, &max_steps, &levels, &signed_turns};
  err = cudaLaunchCooperativeKernel((const void*)path_walk_kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

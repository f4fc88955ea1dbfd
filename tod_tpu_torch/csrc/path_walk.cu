// Path walk: follow the relaxation's next-hop map from the start node and
// write the plan buffer, on the card.
//
// Replaces the path walk of the JAX package's planner/tpu_relax.py
// (plan_on_device, the walk at lines 131-212).  That walk is XLA code,
// not a Pallas kernel; it runs on the device so that the host reads back only
// the plan (8 KB) instead of the distance and next-hop maps.
//
//   plan[0]     = (n_valid, truncated)
//   plan[1 + i] = (dist[cur] - dist[next], turn) for hop i,
//                 zeros past n_valid; all zeros when the start is unreached.
//
// Unsigned turns: the angle between the segments (cur <- next) and
// (next -> next2), the first one 0.  Signed turns: the atan2 turn from the
// carried heading (initially up the map) to each hop's segment.
//
// Bound: the work depends on the path.  A walk of n hops reads n + 1 entries
// of each map (12 bytes a hop) and writes the (max_steps + 1) x 2 plan: about
// 14 KB at n = 530, a few nanoseconds of bandwidth.  It is bound by latency:
// each hop's loads depend on the one before.
//
// Design: one block.  Its threads zero the plan together; then thread 0 walks.
// Each hop issues the next node's distance and next-hop loads together, and
// carries them into the following hop, so a hop costs one round trip to
// memory.  The turn math uses IEEE sqrtf and division (no fast math), as the
// plain version's float32 numpy does; acosf and atan2f may differ from it in
// the last bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3.4e38f;  // the relaxation's "unreached" distance
__constant__ int kDy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
__constant__ int kDx[8] = {0, 1, 1, 1, 0, -1, -1, -1};

__global__ void path_walk_kernel(const float* __restrict__ dist,
                                 const long long* __restrict__ next_dir,
                                 float* __restrict__ plan, int w, int start,
                                 int max_steps, int signed_turns) {
  for (int i = threadIdx.x; i < 2 * (max_steps + 1); i += blockDim.x) plan[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float d_cur = dist[start];
  if (!(d_cur < kInf)) return;

  int cur = start;
  long long dir = next_dir[cur];
  float rotation = 0.0f, hx = 0.0f, hz = -1.0f;
  int n = 0;
  for (; n < max_steps && dir >= 0; ++n) {
    const int nxt = cur + kDy[dir] * w + kDx[dir];
    const float d_nxt = dist[nxt];
    const long long dir_nxt = next_dir[nxt];
    float* row = plan + 2 * (1 + n);
    row[0] = d_cur - d_nxt;
    if (signed_turns) {
      const float sx = (float)(nxt % w - cur % w);
      const float sz = (float)(nxt / w - cur / w);
      const bool moved = sx != 0.0f || sz != 0.0f;
      row[1] = moved ? atan2f(hx * sz - hz * sx, hx * sx + hz * sz) : 0.0f;
      if (moved) {
        hx = sx;
        hz = sz;
      }
    } else {
      row[1] = rotation;
      const int nn = dir_nxt >= 0 ? nxt + kDy[dir_nxt] * w + kDx[dir_nxt] : nxt;
      const float ax = (float)(cur % w - nxt % w), ay = (float)(cur / w - nxt / w);
      const float bx = (float)(nn % w - nxt % w), by = (float)(nn / w - nxt / w);
      const float na = sqrtf(ax * ax + ay * ay);
      const float nb = sqrtf(bx * bx + by * by);
      const float c = fminf(fmaxf((ax * bx + ay * by) / fmaxf(na * nb, 1e-12f), -1.0f), 1.0f);
      rotation = (na > 0.0f && nb > 0.0f) ? acosf(c) : 0.0f;
    }
    cur = nxt;
    d_cur = d_nxt;
    dir = dir_nxt;
  }
  plan[0] = (float)n;
  plan[1] = dir >= 0 ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int tod_path_walk(const void* dist, const void* next_dir, void* plan,
                             int w, int start, int max_steps, int signed_turns,
                             void* stream) {
  path_walk_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dist, (const long long*)next_dir, (float*)plan, w, start,
      max_steps, signed_turns);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

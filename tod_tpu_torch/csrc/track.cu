// The tracker's step over N track banks in one launch: predict, gated greedy
// association, Kalman update, lifecycle, births, then each bank's seed slots
// for the planner.
//
// Replaces the XLA loop of the JAX package's track/tracker.py (track_update,
// lines 79-193, an 8-round fori_loop of global-minimum picks inside the
// jitted serving graph, then tracks_to_balls, lines 196-214; the multistream
// graph vmaps both over its N banks).  Written as eager torch, one step is
// some 150 small launches; here it is one.
//
// Design: one block a bank, one thread a measurement column (a block of M
// rounded up to whole warps, each thread looping over columns past the
// block's width).  The K x M cost matrix lives in shared memory.  Each of
// the K association rounds is a block-wide minimum of the 64-bit key
// (float bits of the cost << 32 | k * M + m): a cost is +0 or more and never
// NaN, so its bits order as the floats do, and on equal costs the smaller
// flat index wins, the first minimum that jnp.argmin returns.  A round that
// finds no cost below 3.4e38 (the JAX sentinel, not an infinity) ends the
// loop: every later round would find none either.  The winner's row and
// column are set to the sentinel.  The births rank the free measurements
// with one ballot a warp.  Nothing is read back: the bank is updated in
// place (the JAX graph donates it) and the seeds written beside it.
//
// Rounding: compiled XLA (CPU) contracts two expressions into fused
// multiply-adds, d2 = fma(dy, dy, dx * dx) and p_vel - k2 * p_pv =
// fma(-k2, p_pv, p_vel), and rounds every other operation on its own.  Each
// operation below is pinned with an _rn intrinsic, so nvcc contracts nothing
// else; the plain version (track/tracker.py) forms the two fused sums in
// float64 and rounds once.
//
// Bound: N * (K * 10 + M * 4) floats read and as many written; at K = 8,
// M = 100 about 1.9 KB a bank, under a microsecond of memory time even at
// N = 16.  The launch and the K rounds of block barriers are the cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 10;  // floats in a state row
enum Field { X, Y, VX, VY, P_POS, P_PV, P_VEL, HITS, MISSES, ACTIVE };
constexpr int kMaxTracks = 32;
constexpr int kMaxThreads = 1024;
constexpr float kInf = 3.4e38f;

struct Params {
  float c_pos, c_pv, c_vel;  // the process noise terms: q / 4, q / 2, q
  float gate2, meas_var, vel0_var, min_pixels, max_misses, min_hits;
};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
track_kernel(float* __restrict__ banks, const float* __restrict__ balls,
             float* __restrict__ seeds, int k, int m, int max_balls, Params p) {
  extern __shared__ float cost[];  // k * m costs, then m validity flags
  unsigned char* valid = reinterpret_cast<unsigned char*>(cost + (size_t)k * m);
  __shared__ float t[kMaxTracks][kW];
  __shared__ int assign[kMaxTracks];
  __shared__ int free_meas[kMaxTracks];
  __shared__ unsigned char slot_free[kMaxTracks];
  __shared__ unsigned long long warp_best[kMaxThreads / 32];
  __shared__ int warp_count[kMaxThreads / 32];
  __shared__ unsigned long long best;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  float* bank = banks + (size_t)blockIdx.x * k * kW;
  const float* ball = balls + (size_t)blockIdx.x * m * 4;

  // load and predict (x += v; P <- F P F^T + Q)
  for (int i = tid; i < k * kW; i += blockDim.x) t[i / kW][i % kW] = bank[i];
  __syncthreads();
  if (tid < k) {
    float* r = t[tid];
    const float pos = r[P_POS], pv = r[P_PV], vel = r[P_VEL];
    r[X] = __fadd_rn(r[X], r[VX]);
    r[Y] = __fadd_rn(r[Y], r[VY]);
    r[P_POS] = __fadd_rn(__fadd_rn(__fadd_rn(pos, __fmul_rn(2.0f, pv)), vel), p.c_pos);
    r[P_PV] = __fadd_rn(__fadd_rn(pv, vel), p.c_pv);
    r[P_VEL] = __fadd_rn(vel, p.c_vel);
    assign[tid] = -1;
  }
  for (int j = tid; j < m; j += blockDim.x) valid[j] = ball[j * 4 + 2] > p.min_pixels;
  __syncthreads();

  // the gated cost matrix
  for (int j = tid; j < m; j += blockDim.x) {
    const float bx = ball[j * 4], by = ball[j * 4 + 1];
    for (int i = 0; i < k; ++i) {
      const float dx = __fsub_rn(t[i][X], bx);
      const float dy = __fsub_rn(t[i][Y], by);
      const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
      const bool ok = t[i][ACTIVE] > 0.0f && valid[j] && d2 <= p.gate2;
      cost[i * m + j] = ok ? d2 : kInf;
    }
  }
  __syncthreads();

  // greedy association: k rounds of the global minimum
  for (int round = 0; round < k; ++round) {
    unsigned long long key = ~0ull;
    for (int j = tid; j < m; j += blockDim.x) {
      for (int i = 0; i < k; ++i) {
        const unsigned long long c =
            ((unsigned long long)__float_as_uint(cost[i * m + j]) << 32) | (unsigned)(i * m + j);
        key = c < key ? c : key;
      }
    }
    key = warp_min(key);
    if (lane == 0) warp_best[warp] = key;
    __syncthreads();
    if (warp == 0) {
      key = lane < n_warps ? warp_best[lane] : ~0ull;
      key = warp_min(key);
      if (lane == 0) best = key;
    }
    __syncthreads();
    const unsigned long long won = best;
    if (!(__uint_as_float((unsigned)(won >> 32)) < kInf)) break;  // uniform: no pair left
    const int flat = (int)(won & 0xffffffffu);
    const int ti = flat / m, mi = flat % m;
    if (tid == 0) assign[ti] = mi;
    for (int j = tid; j < m; j += blockDim.x) {
      if (j == mi) {
        for (int i = 0; i < k; ++i) cost[i * m + j] = kInf;
      } else {
        cost[ti * m + j] = kInf;
      }
    }
    __syncthreads();
  }

  // Kalman update (shared isotropic 2x2 P; H = [1 0]) and lifecycle
  if (tid < k) {
    float* r = t[tid];
    const int a = assign[tid];
    const bool matched = a >= 0;
    const float zx = ball[max(a, 0) * 4], zy = ball[max(a, 0) * 4 + 1];
    const float pos = r[P_POS], pv = r[P_PV], vel = r[P_VEL];
    const float s = __fadd_rn(pos, p.meas_var);
    const float k1 = __fdiv_rn(pos, s);
    const float k2 = __fdiv_rn(pv, s);
    const float rx = __fsub_rn(zx, r[X]);
    const float ry = __fsub_rn(zy, r[Y]);
    r[X] = __fadd_rn(r[X], matched ? __fmul_rn(k1, rx) : 0.0f);
    r[Y] = __fadd_rn(r[Y], matched ? __fmul_rn(k1, ry) : 0.0f);
    r[VX] = __fadd_rn(r[VX], matched ? __fmul_rn(k2, rx) : 0.0f);
    r[VY] = __fadd_rn(r[VY], matched ? __fmul_rn(k2, ry) : 0.0f);
    if (matched) {
      const float keep = __fsub_rn(1.0f, k1);
      r[P_POS] = __fmul_rn(keep, pos);
      r[P_PV] = __fmul_rn(keep, pv);
      r[P_VEL] = __fmaf_rn(-k2, pv, vel);
    }
    const bool active = r[ACTIVE] > 0.0f;
    const float hits = matched ? __fadd_rn(r[HITS], 1.0f) : r[HITS];
    const float misses = matched ? 0.0f : (active ? __fadd_rn(r[MISSES], 1.0f) : 0.0f);
    const bool alive = active && misses <= p.max_misses;
    r[HITS] = alive ? hits : 0.0f;
    r[MISSES] = alive ? misses : 0.0f;
    r[ACTIVE] = alive ? 1.0f : 0.0f;
    slot_free[tid] = !alive;
  }
  __syncthreads();

  // births: rank the valid measurements no track took, one ballot a warp
  int n_free = 0;
  for (int start = 0; start < m; start += blockDim.x) {
    const int j = start + tid;
    bool is_free = j < m && valid[j];
    for (int i = 0; is_free && i < k; ++i) is_free = assign[i] != j;
    const unsigned ballot = __ballot_sync(0xffffffffu, is_free);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int rank = n_free + __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w < warp) rank += warp_count[w];
      total += warp_count[w];
    }
    if (is_free && rank < k) free_meas[rank] = j;
    __syncthreads();
    n_free += total;
  }
  if (tid < k && slot_free[tid]) {
    int rank = 0;
    for (int i = 0; i < tid; ++i) rank += slot_free[i];
    if (rank < n_free) {
      float* r = t[tid];
      const int j = free_meas[rank];
      r[X] = ball[j * 4];
      r[Y] = ball[j * 4 + 1];
      r[VX] = 0.0f;
      r[VY] = 0.0f;
      r[P_POS] = p.meas_var;
      r[P_PV] = 0.0f;
      r[P_VEL] = p.vel0_var;
      r[HITS] = 1.0f;
      r[MISSES] = 0.0f;
      r[ACTIVE] = 1.0f;
    }
  }
  __syncthreads();

  // the bank, in place, and the seed slots: confirmed tracks count 100 + hits
  for (int i = tid; i < k * kW; i += blockDim.x) bank[i] = t[i / kW][i % kW];
  float* seed = seeds + (size_t)blockIdx.x * max_balls * 4;
  for (int i = tid; i < max_balls * 4; i += blockDim.x) {
    const int slot = i / 4, c = i % 4;
    float v = 0.0f;
    if (slot < k) {
      const float* r = t[slot];
      if (c < 2) {
        v = r[c];
      } else if (c == 2 && r[ACTIVE] > 0.0f && r[HITS] >= p.min_hits) {
        v = __fadd_rn(100.0f, r[HITS]);
      }
    }
    seed[i] = v;
  }
}

}  // namespace

// banks (n, k, 10) f32, updated in place; balls (n, m, 4) f32; seeds
// (n, max_balls, 4) f32 written.  The scalars are float32 values the wrapper
// rounds from the TrackerConfig: the process noise q / 4, q / 2 and q, the
// gate squared, the measurement and newborn velocity variances, the
// min_pixels validity bound, max_misses and min_hits.
extern "C" int tod_track(void* banks, const void* balls, void* seeds, int n, int k, int m,
                         int max_balls, float c_pos, float c_pv, float c_vel, float gate2,
                         float meas_var, float vel0_var, float min_pixels, float max_misses,
                         float min_hits, void* stream) {
  if (n < 1 || k < 1 || k > kMaxTracks || m < 1 || max_balls < k) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = m >= kMaxThreads ? kMaxThreads : ((m + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)k * m + (size_t)m;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Params p{c_pos, c_pv, c_vel, gate2, meas_var, vel0_var, min_pixels, max_misses, min_hits};
  track_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      (float*)banks, (const float*)balls, (float*)seeds, k, m, max_balls, p);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

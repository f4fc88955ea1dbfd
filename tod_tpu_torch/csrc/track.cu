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
// Design: one warp a bank, up to kBanksPerBlock banks a block, and no
// block barrier anywhere: only shuffles, ballots and warp reductions
// (redux.sync).  Lanes 0..K-1 hold the track rows in registers; the
// predicted x, y and active flag reach the other lanes by __shfl_sync.  Lane
// l owns the measurement columns l + 32c, and keeps, for each of them, the
// smallest (cost bits, flat index k * M + m) key over the rows left: a cost
// is +0 or more and never NaN, so its bits order as the floats do, and on
// equal costs the smaller flat index wins, the first minimum that
// jnp.argmin returns.  A round of the K association rounds is the lane's
// minimum over its columns, then two 32-bit warp minima: the cost bits, and
// the flat index among the lanes at that cost.  A round whose minimum is
// not below 3.4e38 (the JAX sentinel, not an infinity) ends the loop: every
// later round would find none either.  The winner's column is retired, and
// only the columns whose key lay in the winner's row take a new key from
// the rows left; the others' keys are still their minima.  The main path's
// shape (K <= 8 tracks, M <= 128 balls) keeps each lane's costs in
// registers, the K x M matrix in no memory at all (an unrolled build for
// 1, 2 or 4 columns a lane).  Any other shape keeps the matrix and the
// measurements' flags in the warp's slice of shared memory, one key a lane,
// the sentinel written into the retired row and column, and a full rescan
// of the lane's columns when its key lay in either.  Either way a lane
// alone reads and writes its columns, so nothing needs a fence.  The births
// rank the free measurements with one ballot a chunk of 32 columns and the
// free slots with one ballot over the lanes below K.  Nothing is read back:
// the bank is updated in place (the JAX graph donates it) and the seeds
// written beside it.
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
// N = 16.  What costs is latency: the launch and a chain of K dependent
// rounds, each a reduction over the bank's costs.  A block a bank (the
// design this replaces) paid three block barriers a round; a warp pays two
// redux.sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 10;  // floats in a state row
enum Field { X, Y, VX, VY, P_POS, P_PV, P_VEL, HITS, MISSES, ACTIVE };
constexpr int kMaxTracks = 32;     // a track a lane
constexpr int kBanksPerBlock = 4;  // a warp a bank
constexpr int kRegRows = 8;        // the most tracks whose costs a lane keeps in registers
constexpr int kSmemLimit = 232448;  // the most dynamic shared memory a Hopper block can opt into
constexpr float kInf = 3.4e38f;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // a lane with no column: above every key

struct Params {
  float c_pos, c_pv, c_vel;  // the process noise terms: q / 4, q / 2, q
  float gate2, meas_var, vel0_var, min_pixels, max_misses, min_hits;
};

// A flat index i * M + j packed as i << 16 | j: the same order (j < M <=
// 65535), and the row and column come back without a division.
__device__ __forceinline__ unsigned pack(int i, int j) { return (unsigned)i << 16 | (unsigned)j; }

// The smallest (cost bits, flat index) key of the lane's columns, any M.
// The scan runs in ascending flat index, so the first of equal costs stays.
__device__ __forceinline__ void scan_columns(const float* cost, int k, int m, int lane,
                                             unsigned& bits, unsigned& key) {
  bits = kNone;
  key = kNone;
  for (int i = 0; i < k; ++i) {
    for (int j = lane; j < m; j += 32) {
      const unsigned c = __float_as_uint(cost[i * m + j]);
      if (c < bits) {
        bits = c;
        key = pack(i, j);
      }
    }
  }
}

// One tracker step of bank blockIdx.x * (blockDim.x / 32) + warp.  C > 0:
// K <= kRegRows and M <= 32 C; the lane keeps its columns' costs, their
// keys and whether each is a free measurement in registers.  C == 0: any
// K and M; the costs and flags in the warp's slice of shared memory.
template <int C>
__global__ void __launch_bounds__(32 * kBanksPerBlock)
track_warp_kernel(float* __restrict__ banks, const float* __restrict__ balls,
                  float* __restrict__ seeds, int n, int k, int m, int max_balls, int slice,
                  Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;  // the whole warp
  float* cost = smem + (size_t)warp * slice;  // k * m costs, then m flags (C == 0)
  unsigned char* valid = reinterpret_cast<unsigned char*>(cost + (size_t)k * m);
  float* bank = banks + (size_t)b * k * kW;
  const float4* ball = reinterpret_cast<const float4*>(balls + (size_t)b * m * 4);

  // load and predict (x += v; P <- F P F^T + Q): lane i < k holds row i
  const bool row = lane < k;
  float r[kW];  // a row is 40 bytes: five 8-byte loads
#pragma unroll
  for (int f = 0; f < kW; f += 2) {
    const float2 v = row ? *reinterpret_cast<const float2*>(bank + lane * kW + f)
                         : make_float2(0.0f, 0.0f);
    r[f] = v.x;
    r[f + 1] = v.y;
  }
  constexpr int kCols = C > 0 ? C : 1;
  float4 z[kCols];  // C > 0: the lane's measurements, loaded beside the bank
  if constexpr (C > 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      z[c] = j < m ? ball[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  if (row) {
    const float pos = r[P_POS], pv = r[P_PV], vel = r[P_VEL];
    r[X] = __fadd_rn(r[X], r[VX]);
    r[Y] = __fadd_rn(r[Y], r[VY]);
    r[P_POS] = __fadd_rn(__fadd_rn(__fadd_rn(pos, __fmul_rn(2.0f, pv)), vel), p.c_pos);
    r[P_PV] = __fadd_rn(__fadd_rn(pv, vel), p.c_pv);
    r[P_VEL] = __fadd_rn(vel, p.c_vel);
  }

  // the gated cost of a track (predicted tx, ty, active flag) and a measurement
  auto gated = [&](float tx, float ty, float act, float4 zj, bool valid_j) {
    const float dx = __fsub_rn(tx, zj.x);
    const float dy = __fsub_rn(ty, zj.y);
    const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
    return act > 0.0f && valid_j && d2 <= p.gate2 ? d2 : kInf;
  };

  int assign = -1;          // lane i < k: track i's measurement
  unsigned free_cols = 0;   // C > 0: bit c, column lane + 32c is a measurement no track took
  if constexpr (C > 0) {
    float cost_reg[C][kRegRows];  // (column lane + 32c, row i); rows past k cost kInf
    unsigned col_bits[C];         // each column's smallest cost bits over the rows left ...
    int col_row[C];               // ... and its first row at that cost
#pragma unroll
    for (int c = 0; c < C; ++c) {
      col_bits[c] = kNone;
      col_row[c] = 0;
      free_cols |= (lane + 32 * c < m && z[c].z > p.min_pixels ? 1u : 0u) << c;
    }
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {  // track i's row, from lane i (zeros past k)
      const float tx = __shfl_sync(kAll, r[X], i);
      const float ty = __shfl_sync(kAll, r[Y], i);
      const float act = __shfl_sync(kAll, r[ACTIVE], i);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        cost_reg[c][i] = gated(tx, ty, act, z[c], (free_cols >> c) & 1u);
        const unsigned v = lane + 32 * c < m ? __float_as_uint(cost_reg[c][i]) : kNone;
        col_row[c] = v < col_bits[c] ? i : col_row[c];
        col_bits[c] = v < col_bits[c] ? v : col_bits[c];
      }
    }
    unsigned rows_left = (1u << k) - 1u;  // k <= kRegRows
    for (int round = 0; round < k; ++round) {
      unsigned bits = kNone, key = kNone;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const unsigned kc = pack(col_row[c], lane + 32 * c);
        const bool lower = col_bits[c] < bits || (col_bits[c] == bits && kc < key);
        bits = lower ? col_bits[c] : bits;
        key = lower ? kc : key;
      }
      const unsigned won_bits = __reduce_min_sync(kAll, bits);
      if (!(__uint_as_float(won_bits) < kInf)) break;  // uniform: no pair left
      const unsigned won = __reduce_min_sync(kAll, bits == won_bits ? key : kNone);
      const int ti = (int)(won >> 16), mi = (int)(won & 0xffffu);
      if (lane == ti) assign = mi;
      rows_left &= ~(1u << ti);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        // a column whose key went with row ti: its key over the rows left
        unsigned best = kNone;
        int best_row = 0;
#pragma unroll
        for (int i = 0; i < kRegRows; ++i) {
          const unsigned v = __float_as_uint(cost_reg[c][i]);
          const bool lower = ((rows_left >> i) & 1u) && v < best;
          best_row = lower ? i : best_row;
          best = lower ? v : best;
        }
        const bool taken = lane + 32 * c == mi;
        const bool stale = col_bits[c] != kNone && col_row[c] == ti;
        col_bits[c] = taken ? kNone : (stale ? best : col_bits[c]);
        col_row[c] = stale ? best_row : col_row[c];
        free_cols &= taken ? ~(1u << c) : kAll;
      }
    }
  } else {
    for (int base = 0; base < m; base += 32) {
      const int j = base + lane;
      const bool in = j < m;
      const float4 zj = in ? ball[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const bool ok_j = in && zj.z > p.min_pixels;
      if (in) valid[j] = ok_j;
      for (int i = 0; i < k; ++i) {
        const float v = gated(__shfl_sync(kAll, r[X], i), __shfl_sync(kAll, r[Y], i),
                              __shfl_sync(kAll, r[ACTIVE], i), zj, ok_j);
        if (in) cost[i * m + j] = v;
      }
    }
    unsigned bits, key;
    scan_columns(cost, k, m, lane, bits, key);
    for (int round = 0; round < k; ++round) {
      const unsigned won_bits = __reduce_min_sync(kAll, bits);
      if (!(__uint_as_float(won_bits) < kInf)) break;  // uniform: no pair left
      const unsigned won = __reduce_min_sync(kAll, bits == won_bits ? key : kNone);
      const int ti = (int)(won >> 16), mi = (int)(won & 0xffffu);
      if (lane == ti) assign = mi;
      for (int j = lane; j < m; j += 32) cost[ti * m + j] = kInf;
      if ((mi & 31) == lane) {
        for (int i = 0; i < k; ++i) cost[i * m + mi] = kInf;
        valid[mi] = 0;  // taken: no birth from it
      }
      if (key != kNone && ((int)(key >> 16) == ti || (int)(key & 0xffffu) == mi)) {
        scan_columns(cost, k, m, lane, bits, key);
      }
    }
  }

  // Kalman update (shared isotropic 2x2 P; H = [1 0]) and lifecycle
  bool slot_free = false;
  if (row) {
    const bool matched = assign >= 0;
    const float4 za = ball[max(assign, 0)];
    const float pos = r[P_POS], pv = r[P_PV], vel = r[P_VEL];
    const float s = __fadd_rn(pos, p.meas_var);
    const float k1 = __fdiv_rn(pos, s);
    const float k2 = __fdiv_rn(pv, s);
    const float rx = __fsub_rn(za.x, r[X]);
    const float ry = __fsub_rn(za.y, r[Y]);
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
    slot_free = !alive;
  }

  // births: the i-th free slot takes the i-th valid measurement no track
  // took, one ballot a chunk of 32 columns; the chunks stop once they hold
  // as many as there are free slots
  const unsigned free_slots = __ballot_sync(kAll, slot_free);
  const int n_slots = __popc(free_slots);
  const int rank = __popc(free_slots & ((1u << lane) - 1u));
  int meas = -1;
  const int chunks = C > 0 ? C : (m + 31) / 32;
  for (int c = 0, before = 0; c < chunks && before < n_slots; ++c) {
    const int j = 32 * c + lane;
    bool is_free;
    if constexpr (C > 0) {
      is_free = (free_cols >> c) & 1u;
    } else {
      is_free = j < m && valid[j];
    }
    const unsigned free_meas = __ballot_sync(kAll, is_free);
    const int count = __popc(free_meas);
    if (slot_free && rank >= before && rank < before + count) {
      unsigned left = free_meas;
      for (int t = rank - before; t > 0; --t) left &= left - 1u;  // drop the lower ones
      meas = 32 * c + __ffs(left) - 1;
    }
    before += count;
  }
  if (meas >= 0) {
    const float4 zb = ball[meas];
    r[X] = zb.x;
    r[Y] = zb.y;
    r[VX] = 0.0f;
    r[VY] = 0.0f;
    r[P_POS] = p.meas_var;
    r[P_PV] = 0.0f;
    r[P_VEL] = p.vel0_var;
    r[HITS] = 1.0f;
    r[MISSES] = 0.0f;
    r[ACTIVE] = 1.0f;
  }

  // the bank, in place, and the seed slots: confirmed tracks count 100 + hits
  if (row) {
#pragma unroll
    for (int f = 0; f < kW; f += 2) {
      *reinterpret_cast<float2*>(bank + lane * kW + f) = make_float2(r[f], r[f + 1]);
    }
  }
  float4* seed = reinterpret_cast<float4*>(seeds + (size_t)b * max_balls * 4);
  for (int slot = lane; slot < max_balls; slot += 32) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (slot < k) {  // k <= 32: the lane's own row
      v.x = r[X];
      v.y = r[Y];
      if (r[ACTIVE] > 0.0f && r[HITS] >= p.min_hits) v.z = __fadd_rn(100.0f, r[HITS]);
    }
    seed[slot] = v;
  }
}

template <int C>
int launch(float* banks, const float* balls, float* seeds, int n, int k, int m, int max_balls,
           const Params& p, cudaStream_t stream) {
  // a bank's slice: its costs and flags, rounded up to 16 bytes (C == 0)
  const size_t slice = C > 0 ? 0 : (sizeof(float) * (size_t)k * m + (size_t)m + 15) / 16 * 16;
  if (slice > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  int per_block = n < kBanksPerBlock ? n : kBanksPerBlock;
  while (per_block > 1 && slice * per_block > (size_t)kSmemLimit) --per_block;
  const size_t smem = slice * per_block;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_warp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  track_warp_kernel<C><<<(n + per_block - 1) / per_block, 32 * per_block, smem, stream>>>(
      banks, balls, seeds, n, k, m, max_balls, (int)(slice / sizeof(float)), p);
  return (int)cudaGetLastError();
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
  if (n < 1 || k < 1 || k > kMaxTracks || m < 1 || m > 65535 || max_balls < k) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{c_pos, c_pv, c_vel, gate2, meas_var, vel0_var, min_pixels, max_misses, min_hits};
  float* bk = static_cast<float*>(banks);
  const float* bl = static_cast<const float*>(balls);
  float* sd = static_cast<float*>(seeds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (m + 31) / 32;  // columns a lane
  if (k <= kRegRows && chunks == 1) return launch<1>(bk, bl, sd, n, k, m, max_balls, p, s);
  if (k <= kRegRows && chunks == 2) return launch<2>(bk, bl, sd, n, k, m, max_balls, p, s);
  if (k <= kRegRows && chunks <= 4) return launch<4>(bk, bl, sd, n, k, m, max_balls, p, s);
  return launch<0>(bk, bl, sd, n, k, m, max_balls, p, s);
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

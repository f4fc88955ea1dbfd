// Bellman-Ford relaxation of the grid planner to a fixpoint, then the
// next-hop argmin, in one cooperative launch.
//
// Replaces the relaxation of the JAX package's planner/tpu_relax.py
// (bellman_ford_grid, lines 50-79).  That is an XLA while loop, not a Pallas
// kernel: the TPU runs the whole loop on the device, so a planning dispatch
// returns at once.  This kernel does the same on the card: the host enqueues
// one launch and reads nothing back.
//
// Each sweep of the plain loop is a Jacobi sweep over all nodes:
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
// Bound: 24 adds, compares and selects a node a sweep, none an FMA, at one
// a lane a clock: ~0.18 ms at 480x640 and ~800 sweeps.  A grid barrier
// after every sweep, with every distance, edge and height read through L2
// each sweep, costs ~5.7 us a sweep on an H100, mostly the L2 traffic.
// Here a barrier (~1.2 us) comes every k sweeps, and a sweep is a pass over
// a block's region in shared memory (~1.4 us at the committed tiling),
// bound by the SM's instruction issue and shared-memory bandwidth:
// tools/block_sweep.py and PERF.md have the numbers.
//
// Design: temporal blocking.  The map is cut into tiles of tile_h x tile_w
// nodes; a block holds a tile plus a ring k nodes wide around it (the
// "region") in shared memory: each node's 8 edges (a missing edge stored as
// +inf, which gives the same minimum), its height and two distance buffers,
// 44 bytes, and a word a thread and ring for the sweep plan.  A batch loads the ring's distances from global memory, runs
// kk = min(k, max_iters - sweeps) Jacobi sweeps in shared memory and writes
// the tile's distances back, then the grid takes one barrier.  After local
// sweep j only the nodes at least j rings inside the region are still exact,
// so sweep j updates those alone (the "cone"); the tile itself is k rings
// inside and comes out of kk sweeps exactly as kk global sweeps leave it.
// Candidates c_i = fl(fl(d + e) + dh) round monotonically in d, so no
// inexact outer value ever undercuts an exact one.  Local sweep j sets
// flags[sweeps + j] when a node of the tile (never of the ring) changed;
// after the barrier every thread reads the same kk flags, and the first zero
// at j stops the loop with sweeps + j + 1, the plain loop's count (sweeps
// after one that changes nothing change nothing).  Global distances are
// double-buffered across batches (a batch reads one buffer, writes the
// other), so one barrier a batch suffices; the first batch reads the seed
// map itself.  When every tile has a block of its own ("resident"), a block
// loads its edges and heights once a launch and keeps its tile's distances
// in shared memory between batches, so a batch moves only the ring: its
// node indices are worked out once, and its loads for the next batch go out
// right after the barrier, beside the flag read (one round trip a warp,
// lane j reading flag j).  When the map has more tiles than co-resident
// blocks, each block loops over its tiles in every batch and reloads each
// from global memory (L2).  In a sweep each thread walks a column of the
// cone (plan_rings splits each ring's cone among the threads once a tile)
// and keeps a 3x3 window of distances and heights in registers, so a node
// costs 3 distance and 3 height loads, its two edge vectors and one store
// in shared memory.  The wrapper (kernels/relax.py relax_tiling) chooses
// tile and k from the map's shape and the SM count.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Threads per block: 512 was the fastest of 256, 512 and 1024 on an H100
// (tools/block_sweep.py, PERF.md), which overrides it with -D.
#ifndef TOD_THREADS
#define TOD_THREADS 512
#endif
constexpr int kThreads = TOD_THREADS;
constexpr float kInf = 3.4e38f;  // "unreached", as the plain version's INF
constexpr int kNodeBytes = 44;   // 8 edges, the height, two distances
// + 4 bytes a thread and ring for the sweep plan (plan_rings)
constexpr int kMaxK = 32;        // a batch's change flags are read as one warp's ballot
// The most region nodes that fit shared memory (232448 / kNodeBytes),
// rounded up: a thread fills its share of any region in one pass.
constexpr int kMaxRegion = 5376;
constexpr int kLoads = (kMaxRegion + kThreads - 1) / kThreads;
constexpr int kConstLoads = 4;   // nodes' edges and heights a thread has in flight
__constant__ int kDy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
__constant__ int kDx[8] = {0, 1, 1, 1, 0, -1, -1, -1};

struct Geo {
  int h, w;          // the map
  int th, tw, k;     // tile and ring width
  int tiles_x, n_tiles;
  int rh, rw;        // region: the tile and its ring
};

struct Tile {
  int y0, x0;  // the region's top-left node on the map (may lie off it)
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int t) {
  const int ty = t / g.tiles_x, tx = t - ty * g.tiles_x;
  return {ty * g.th - g.k, tx * g.tw - g.k};
}

struct Smem {
  float4* e0;  // edges 0-3 of each region node
  float4* e1;  // edges 4-7
  float* hgt;  // heights, 0 off the map
  float* d0;   // distances, INF off the map: two buffers
  float* d1;
  __device__ float* d(int i) const { return i ? d1 : d0; }
};

__device__ __forceinline__ float missing_to_inf(float e) { return e >= 0.0f ? e : INFINITY; }

// The (row, column) of the nodes q = threadIdx.x + i * blockDim.x of a grid
// `width` wide, stepped without a division.
struct Stride {
  int r, c, dr, dc, width;
  __device__ explicit Stride(int width)
      : r(threadIdx.x / width), c(threadIdx.x % width), dr(blockDim.x / width),
        dc(blockDim.x % width), width(width) {}
  __device__ void next() {
    c += dc;
    r += dr;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

// Region node (r, c) of tile t: its map index, -1 off the map.
__device__ __forceinline__ int map_index(const Geo& g, Tile t, int r, int c) {
  const int gy = t.y0 + r, gx = t.x0 + c;
  return gy >= 0 && gy < g.h && gx >= 0 && gx < g.w ? gy * g.w + gx : -1;
}

__device__ __forceinline__ bool in_tile(const Geo& g, int r, int c) {
  return r >= g.k && r < g.k + g.th && c >= g.k && c < g.k + g.tw;
}

// A tile's edges and heights into shared memory, kConstLoads nodes a thread
// in flight at once (once a launch for a resident tile).
__device__ void load_constants(const Geo& g, Tile t, const float* __restrict__ height,
                               const float* __restrict__ conns, Smem s) {
  const float4* c4 = reinterpret_cast<const float4*>(conns);
  const int area = g.rh * g.rw;
  Stride at(g.rw);
  for (int base = threadIdx.x; base < area; base += kConstLoads * blockDim.x) {
    float4 a[kConstLoads], b[kConstLoads];
    float hv[kConstLoads];
#pragma unroll
    for (int u = 0; u < kConstLoads; ++u, at.next()) {
      const int q = base + u * blockDim.x;
      const int n = q < area ? map_index(g, t, at.r, at.c) : -1;
      a[u] = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
      b[u] = a[u];
      hv[u] = 0.0f;
      if (n >= 0) {
        a[u] = __ldg(c4 + 2 * n);
        b[u] = __ldg(c4 + 2 * n + 1);
        hv[u] = __ldg(height + n);
      }
    }
#pragma unroll
    for (int u = 0; u < kConstLoads; ++u) {
      const int q = base + u * blockDim.x;
      if (q >= area) break;
      s.e0[q] = make_float4(missing_to_inf(a[u].x), missing_to_inf(a[u].y),
                            missing_to_inf(a[u].z), missing_to_inf(a[u].w));
      s.e1[q] = make_float4(missing_to_inf(b[u].x), missing_to_inf(b[u].y),
                            missing_to_inf(b[u].z), missing_to_inf(b[u].w));
      s.hgt[q] = hv[u];
    }
  }
}

// A thread's share of a region's distances on their way from global memory
// to shared memory: node q = threadIdx.x + u * blockDim.x has map index
// n[u] (-1 off the map, -2 nothing to load) and value v[u].  One round trip
// fills a whole region: kLoads loads a thread in flight.
struct Fill {
  int n[kLoads];
  float v[kLoads];
};

// The map indices of a region's nodes, the tile's own nodes too only when
// `all`.
__device__ void fill_index(const Geo& g, Tile t, bool all, Fill& f) {
  const int area = g.rh * g.rw;
  Stride at(g.rw);
#pragma unroll
  for (int u = 0; u < kLoads; ++u, at.next()) {
    const int q = threadIdx.x + u * blockDim.x;
    f.n[u] = -2;
    if (q < area && (all || !in_tile(g, at.r, at.c))) f.n[u] = map_index(g, t, at.r, at.c);
  }
}

// Their distances: from `src` (global, through L2), or from the seed map
// when src is null.
__device__ __forceinline__ void fill_load(const float* src, const unsigned char* __restrict__ seed,
                                          Fill& f) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    f.v[u] = kInf;
    if (f.n[u] >= 0) f.v[u] = src ? __ldcg(src + f.n[u]) : (seed[f.n[u]] ? 0.0f : kInf);
  }
}

// Into buffer `cur`; off-map nodes read INF in both buffers and are never
// updated.
__device__ __forceinline__ void fill_store(const Fill& f, Smem s, int cur) {
  float* d = s.d(cur);
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int q = threadIdx.x + u * blockDim.x;
    if (f.n[u] >= 0) {
      d[q] = f.v[u];
    } else if (f.n[u] == -1) {
      s.d0[q] = kInf;
      s.d1[q] = kInf;
    }
  }
}

// Each thread's share of the cone of every ring 1..k: a column of the
// region and a run of its rows, packed c | r_lo << 10 | r_hi << 21 into
// plan[(ring - 1) * blockDim.x + threadIdx.x] (no rows: r_lo == r_hi).  The
// block's threads split the ring's cone (its nodes on the map) into column
// segments of equal length.  Each thread reads back only its own entries.
// (A thread walking two neighbouring columns loads less, but its lanes then
// touch every second word and each shared-memory load takes two passes:
// slower on an H100, PERF.md.)
__device__ void plan_rings(const Geo& g, Tile t, unsigned* plan) {
  for (int ring = 1; ring <= g.k; ++ring) {
    const int c_lo = max(ring, -t.x0), c_hi = min(g.rw - ring, g.w - t.x0);
    const int r_lo0 = max(ring, -t.y0), r_hi0 = min(g.rh - ring, g.h - t.y0);
    const int cw = c_hi - c_lo, ch = r_hi0 - r_lo0;
    unsigned p = 0;
    if (cw > 0 && ch > 0) {
      const int nseg = max(1, min(ch, (int)blockDim.x / cw));
      const int seg_len = (ch + nseg - 1) / nseg;
      const int seg = threadIdx.x / cw;
      const int r_lo = r_lo0 + seg * seg_len, r_hi = min(r_lo + seg_len, r_hi0);
      if (seg < nseg && r_lo < r_hi)
        p = (unsigned)(c_lo + threadIdx.x - seg * cw) | (unsigned)r_lo << 10 |
            (unsigned)r_hi << 21;
    }
    plan[(ring - 1) * blockDim.x + threadIdx.x] = p;
  }
}

// The new distance of one node from its 3x3 window: rows above (a), at (b)
// and below (z) it, columns left (0), centre (1) and right (2).  The minimum
// is taken as a tree: without NaNs it is the same in any order.
__device__ __forceinline__ float relax_node(float4 ea, float4 eb, float da0, float da1, float da2,
                                            float db0, float db1, float db2, float dz0, float dz1,
                                            float dz2, float ha0, float ha1, float ha2, float hb0,
                                            float hb1, float hb2, float hz0, float hz1,
                                            float hz2) {
  const float c0 = (da1 + ea.x) + fabsf(hb1 - ha1);  // (-1, 0)
  const float c1 = (da2 + ea.y) + fabsf(hb1 - ha2);  // (-1, 1)
  const float c2 = (db2 + ea.z) + fabsf(hb1 - hb2);  // (0, 1)
  const float c3 = (dz2 + ea.w) + fabsf(hb1 - hz2);  // (1, 1)
  const float c4 = (dz1 + eb.x) + fabsf(hb1 - hz1);  // (1, 0)
  const float c5 = (dz0 + eb.y) + fabsf(hb1 - hz0);  // (1, -1)
  const float c6 = (db0 + eb.z) + fabsf(hb1 - hb0);  // (0, -1)
  const float c7 = (da0 + eb.w) + fabsf(hb1 - ha0);  // (-1, -1)
  return fminf(db1, fminf(fminf(fminf(c0, c1), fminf(c2, c3)), fminf(fminf(c4, c5), fminf(c6, c7))));
}

// One row of a column walk: load row r + 1 into window row Z, relax node
// (r, c) from rows A (above), B (at) and Z, store it, step down a row.  The
// three window rows rotate through the names, so nothing is copied.
#define TOD_LOAD_ROW(X, at)                                                  \
  d##X##0 = src[(at) - 1], d##X##1 = src[at], d##X##2 = src[(at) + 1];      \
  h##X##0 = hgt[(at) - 1], h##X##1 = hgt[at], h##X##2 = hgt[(at) + 1]
#define TOD_STEP(A, B, Z)                                                    \
  {                                                                          \
    TOD_LOAD_ROW(Z, q + rw);                                                 \
    const float best = relax_node(e0[q], e1[q], d##A##0, d##A##1, d##A##2,   \
                                  d##B##0, d##B##1, d##B##2, d##Z##0,        \
                                  d##Z##1, d##Z##2, h##A##0, h##A##1,        \
                                  h##A##2, h##B##0, h##B##1, h##B##2,        \
                                  h##Z##0, h##Z##1, h##Z##2);                \
    if ((unsigned)(r - own_r0) < own_n && best < d##B##1) changed = 1;      \
    dst[q] = best;                                                           \
    q += rw;                                                                 \
    if (++r == r_hi) break;                                                  \
  }

// One Jacobi sweep from `src` into `dst` over this thread's share `p` of the
// cone (plan_rings): a column walk that keeps a 3x3 window of distances and
// heights in registers, so a node costs 3 distance and 3 height loads, its
// two edge vectors and a store.  Returns whether one of its tile's nodes
// changed.
__device__ int sweep(const Geo& g, unsigned p, const float* __restrict__ src,
                     float* __restrict__ dst, const float* __restrict__ hgt,
                     const float4* __restrict__ e0, const float4* __restrict__ e1) {
  const int c = p & 1023, r_lo = (p >> 10) & 2047, r_hi = p >> 21;
  if (r_lo >= r_hi) return 0;
  const int rw = g.rw;
  const bool own_col = c >= g.k && c < g.k + g.tw;
  const int own_r0 = g.k;
  const unsigned own_n = own_col ? g.th : 0;
  int changed = 0, r = r_lo;
  int q = (r_lo - 1) * rw + c;
  float da0, da1, da2, db0, db1, db2, dz0, dz1, dz2;
  float ha0, ha1, ha2, hb0, hb1, hb2, hz0, hz1, hz2;
  TOD_LOAD_ROW(a, q);
  q += rw;
  TOD_LOAD_ROW(b, q);
  while (true) {
    TOD_STEP(a, b, z)
    TOD_STEP(b, z, a)
    TOD_STEP(z, a, b)
  }
  return changed;
}

#undef TOD_STEP
#undef TOD_LOAD_ROW

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

__global__ void __launch_bounds__(kThreads, 1)
relax_kernel(const float* __restrict__ height, const float* __restrict__ conns,
             const unsigned char* __restrict__ seed, float* dist, float* scratch,
             long long* __restrict__ next_dir, int* flags, int* sweeps_out, Geo g,
             int max_iters) {
  extern __shared__ float4 smem[];
  const int area = g.rh * g.rw;
  float* f = reinterpret_cast<float*>(smem + 2 * area);
  const Smem s{smem, smem + area, f, f + area, f + 2 * area};
  unsigned* plan = reinterpret_cast<unsigned*>(f + 3 * area);
  cg::grid_group grid = cg::this_grid();
  const bool resident = g.n_tiles <= (int)gridDim.x;
  if (resident && (int)blockIdx.x < g.n_tiles) {
    load_constants(g, tile_of(g, blockIdx.x), height, conns, s);
    plan_rings(g, tile_of(g, blockIdx.x), plan);
  }

  // A resident block fills its whole region from the seed map for the first
  // batch, then only the ring, whose loads for the next batch it issues
  // right after each barrier, beside the flag read.
  Fill fill;
  if (resident && (int)blockIdx.x < g.n_tiles) {
    fill_index(g, tile_of(g, blockIdx.x), true, fill);
    fill_load(nullptr, seed, fill);
  }
  int sweeps = 0, batch = 0, cur = 0;
  while (sweeps < max_iters) {
    const int kk = min(g.k, max_iters - sweeps);
    const float* src = batch ? (batch & 1 ? scratch : dist) : nullptr;
    float* out = batch & 1 ? dist : scratch;
    for (int ti = blockIdx.x; ti < g.n_tiles; ti += gridDim.x) {
      const Tile t = tile_of(g, ti);
      if (!resident) {
        load_constants(g, t, height, conns, s);
        plan_rings(g, t, plan);
        cur = 0;
        fill_index(g, t, true, fill);
        fill_load(src, seed, fill);
      }
      fill_store(fill, s, cur);
      if (resident && batch == 0) fill_index(g, t, false, fill);
      __syncthreads();
      for (int j = 1; j <= kk; ++j) {
        const int changed = sweep(g, plan[(g.k - kk + j - 1) * blockDim.x + threadIdx.x],
                                  s.d(cur), s.d(cur ^ 1), s.hgt, s.e0, s.e1);
        if (__syncthreads_or(changed) && threadIdx.x == 0) flags[sweeps + j - 1] = 1;
        cur ^= 1;
      }
      Stride at(g.tw);
      for (; at.r < g.th; at.next()) {
        const int gy = t.y0 + g.k + at.r, gx = t.x0 + g.k + at.c;
        if (gy < g.h && gx < g.w) out[gy * g.w + gx] = s.d(cur)[(at.r + g.k) * g.rw + at.c + g.k];
      }
      __syncthreads();
    }
    grid.sync();
    if (resident && (int)blockIdx.x < g.n_tiles) fill_load(out, seed, fill);
    // every warp reads the batch's kk flags in one round trip, lane j flag j
    const int lane = threadIdx.x & 31;
    const int f = lane < kk ? ((const volatile int*)flags)[sweeps + lane] : 1;
    const int j = __ffs(~__ballot_sync(0xffffffffu, f != 0)) - 1;  // first unchanged, or -1
    ++batch;
    if (j >= 0) {
      sweeps += j + 1;
      break;
    }
    sweeps += kk;
  }

  // The final distances into `dist`, then the next hops from each 1-ring.
  const float* fin = batch ? (batch & 1 ? scratch : dist) : nullptr;
  for (int ti = blockIdx.x; ti < g.n_tiles; ti += gridDim.x) {
    const Tile t = tile_of(g, ti);
    for (Stride at(g.tw); at.r < g.th; at.next()) {
      const int gy = t.y0 + g.k + at.r, gx = t.x0 + g.k + at.c;
      if (gy >= g.h || gx >= g.w) continue;
      const int n = gy * g.w + gx;
      dist[n] = fin ? __ldcg(fin + n) : (seed[n] ? 0.0f : kInf);
    }
  }
  grid.sync();
  for (int ti = blockIdx.x; ti < g.n_tiles; ti += gridDim.x) {
    const Tile t = tile_of(g, ti);
    for (Stride at(g.tw); at.r < g.th; at.next()) {
      const int gy = t.y0 + g.k + at.r, gx = t.x0 + g.k + at.c;
      if (gy >= g.h || gx >= g.w) continue;
      const int n = gy * g.w + gx;
      int bi;
      best_candidate(height, conns, dist, g.h, g.w, n, &bi);
      const float d = __ldcg(dist + n);
      next_dir[n] = (seed[n] || !(d < kInf)) ? -1 : bi;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *sweeps_out = sweeps;
}

}  // namespace

// height (h, w) f32, conns (h, w, 8) f32 (16-byte aligned), seed (h, w) bool
// -> dist (h, w) f32, next_dir (h, w) int64, sweeps int32; scratch is a
// second (h, w) f32 buffer, flags max_iters + 1 int32 (cleared here).  The
// tiling (tile_h x tile_w tiles, a ring k wide, `blocks` blocks) comes from
// the wrapper's relax_tiling; a grid that cannot be co-resident, or a region
// too large for shared memory, is an error.
extern "C" int tod_relax(const void* height, const void* conns, const void* seed, void* dist,
                         void* scratch, void* next_dir, void* flags, void* sweeps, int h, int w,
                         int max_iters, int tile_h, int tile_w, int k, int blocks, void* stream) {
  if (h < 1 || w < 1 || max_iters < 0 || tile_h < 1 || tile_w < 1 || k < 1 || k > kMaxK ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.h = h;
  g.w = w;
  g.th = tile_h;
  g.tw = tile_w;
  g.k = k;
  g.tiles_x = (w + tile_w - 1) / tile_w;
  const long long n_tiles = (long long)((h + tile_h - 1) / tile_h) * g.tiles_x;
  g.rh = tile_h + 2 * k;
  g.rw = tile_w + 2 * k;
  const long long smem = (long long)kNodeBytes * g.rh * g.rw + 4LL * k * kThreads;
  // the sweep plan packs a column in 10 bits and rows in 11, and gives a
  // thread one column of a ring's cone
  if (n_tiles > (1 << 30) || smem > (1 << 30) || g.rw > 1023 || g.rh > 2047 ||
      g.rw - 2 > kThreads || g.rh * g.rw > kLoads * kThreads)
    return (int)cudaErrorInvalidValue;
  g.n_tiles = (int)n_tiles;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_kernel, kThreads,
                                                        (size_t)smem);
  if (err == cudaSuccess && (long long)blocks > (long long)per_sm * sms)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return (int)err;
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
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &g, &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)relax_kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

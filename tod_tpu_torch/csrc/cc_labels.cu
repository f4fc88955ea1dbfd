// Connected-component labels of a mask: each masked pixel gets the smallest
// linear index of its 4-connected component, every other pixel INT_MAX.
//
// Replaces the label propagation of the JAX package's ops/cc_labels.py
// (connected_components, lines 35-71): an XLA while_loop that takes the min
// over each pixel's 4-neighbourhood until nothing changes.  That loop runs a
// data-dependent number of sweeps (up to H*W / 2 for a serpentine mask), and
// a plain torch version of it reads a flag back to the host on every sweep.
// The compaction of these labels to dense ranks stays plain torch on the
// device (ops/cc_labels.py), as the JAX package does it outside its loop.
//
// Bound: the mask read once (1 byte a pixel) and the int32 labels written
// once; at 480x640 1.5 MB, about 0.5 us of memory time.  What holds a
// union-find back on this card is not that traffic but latency: unions done
// in device memory contend on one root a blob (every pixel of a ball hangs
// itself toward the same address), and each find is a chain of dependent
// L2 round trips.  The design this replaces put one thread on each of the
// 307,200 pixels in each of three launches (init, merge, flatten) and did
// every union in device memory; its merge took three quarters of the time.
//
// Design: a block-based union-find whose unions are mostly done in shared
// memory, three launches on one stream, nothing read back.
//   1. local:   one block a kTile x kTile tile.  It reads the tile's mask
//               (a 4-byte load a lane where the rows allow it) into one bit
//               mask a row.  An empty tile writes INT_MAX over its pixels,
//               marks itself empty and leaves.  Otherwise the first pixel
//               of each run of a row stands for the run (the row's bits
//               give every pixel its run's first column: no atomics), the
//               runs of two rows are united once a stretch where they touch
//               (one lane a stretch, a warp's four rows at once), with the
//               lock-free atomicMin union on shared-memory parents (local
//               indices), each run start chases its root, and each pixel is
//               written as the global index of its run's root, each
//               unmasked one as INT_MAX.
//   2. border:  one block of two warps a non-empty tile unites, in device
//               memory, the edges that cross its top row and its left
//               column, once a stretch where both sides are masked (the
//               other edges of a stretch join sets that pass 1 already
//               joined on each side): at most 2 x kTile unions a tile, none
//               where a neighbouring tile is empty.  Its finds chase both
//               ends at once, so their round trips overlap.
//   3. flatten: the masked pixels of the non-empty tiles take their root.
// A cooperative launch of the three passes with two grid barriers between
// them was slower on the H100 than the three launches (PERF.md;
// tools/kernel_ab.py --cc times both).
//
// Why the result is exact.  The union is the lock-free atomicMin union: it
// hangs the larger of two roots under the smaller, and retries from the old
// value when the larger was no longer a root.  A parent only ever decreases
// and never rises above its node, so each tree's root is its smallest index,
// whatever order the atomics ran in.  Within a tile, local row-major order
// is global row-major order, so a local root is its part's smallest global
// index, and after pass 1 every pixel points at such a root: pass 2 starts
// from a forest that keeps the rule, and its unions keep it.  So the result
// is deterministic and equal, bit for bit, to the propagation's fixpoint
// (every pixel holds its component's minimum linear index).  find reads
// parents with volatile loads (another thread may be writing them) and
// halves paths with atomicMin, which keeps the "only decreases" rule, so
// chains stay short on long components.  Pass 3 runs no union: a root
// stays put, and a parent read on the way is an ancestor whether or not
// another thread has written its pixel's root yet, so it chases with plain
// loads.  kernels/cc_labels.py holds the tile size (TILE) and puts each
// tile's empty flag after the labels, in one allocation.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                    // kernels/cc_labels.py TILE: a row is one warp's bits
constexpr int kWarps = 8;                    // a local or flatten block: 8 warps ...
constexpr int kRowsPerWarp = kTile / kWarps;  // ... of 4 tile rows each
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int find_root(int* parent, int x) {
  volatile int* vp = parent;
  while (true) {
    const int px = vp[x];
    if (px == x) return x;
    const int gx = vp[px];
    if (gx != px) atomicMin(&parent[x], gx);  // path halving; a parent only decreases
    x = px;
  }
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hang the larger root b under a; if b stopped being a root meanwhile,
    // atomicMin still only lowers its parent, and the loop unites a with
    // b's old parent
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

// unite for device memory, where a load is an L2 round trip: both ends are
// chased at once (their loads in flight together), halving as find_root.
__device__ __forceinline__ void unite_global(int* parent, int a, int b) {
  volatile int* vp = parent;
  while (true) {
    int pa = vp[a], pb = vp[b];
    while (pa != a || pb != b) {
      const int ga = vp[pa], gb = vp[pb];
      if (ga != pa) atomicMin(&parent[a], ga);
      if (gb != pb) atomicMin(&parent[b], gb);
      a = pa;
      pa = ga;
      b = pb;
      pb = gb;
    }
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

// The first pixels of the runs of a row's bits, and the first column of
// the run that holds column x (bit x set).
__device__ __forceinline__ unsigned run_starts(unsigned r) { return r & ~(r << 1); }
__device__ __forceinline__ int run_start(unsigned r, int x) {
  const unsigned gaps = ~r & ((1u << x) - 1u);  // unset columns left of x
  return gaps ? 32 - __clz(gaps) : 0;
}

// The j-th of a thread's four pixels, as tile row and column.  Wide: the
// lane's 4 consecutive pixels of row warp * 4 + lane / 8 (one 16-byte label
// store, one 4-byte mask load); else the lane's column of the warp's rows.
__device__ __forceinline__ void pixel_of(bool wide, int lane, int warp, int j, int& ry, int& cx) {
  ry = wide ? warp * kRowsPerWarp + (lane >> 3) : warp * kRowsPerWarp + j;
  cx = wide ? (lane & 7) * 4 + j : lane;
}

// Store a thread's four labels (none past the image).
__device__ __forceinline__ void store4(int* labels, bool wide, int lane, int warp, int x0, int y0,
                                       int h, int w, const int v[kRowsPerWarp]) {
  if (wide) {
    int ry, cx;
    pixel_of(true, lane, warp, 0, ry, cx);
    const int y = y0 + ry, x = x0 + cx;
    if (y < h && x < w) {
      *reinterpret_cast<int4*>(labels + (size_t)y * w + x) = make_int4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int y = y0 + warp * kRowsPerWarp + j, x = x0 + lane;
    if (y < h && x < w) labels[(size_t)y * w + x] = v[j];
  }
}

// Pass 1 for the block's tile -> whether the tile has a masked pixel.
// Block (32, kWarps); rows and parent are the block's shared arrays.
__device__ __forceinline__ bool local_pass(const unsigned char* __restrict__ mask,
                                           int* __restrict__ labels, int h, int w, bool wide,
                                           int x0, int y0, unsigned* rows, int* parent) {
  const int lane = threadIdx.x, warp = threadIdx.y;

  // the tile's mask, a bit mask a row
  bool mine = false;
  if (wide) {
    int ry, cx;
    pixel_of(true, lane, warp, 0, ry, cx);
    const int y = y0 + ry, x = x0 + cx;
    unsigned word = 0;  // w % 4 == 0: the 4 bytes are all inside the row or all past it
    if (y < h && x < w) word = *reinterpret_cast<const unsigned*>(mask + (size_t)y * w + x);
    unsigned bits = ((word & 0x000000ffu) ? 1u : 0u) | ((word & 0x0000ff00u) ? 2u : 0u) |
                    ((word & 0x00ff0000u) ? 4u : 0u) | ((word & 0xff000000u) ? 8u : 0u);
    bits <<= cx;
    bits |= __shfl_xor_sync(kAll, bits, 1);  // the row's 8 lanes gather their nibbles
    bits |= __shfl_xor_sync(kAll, bits, 2);
    bits |= __shfl_xor_sync(kAll, bits, 4);
    if ((lane & 7) == 0) rows[ry] = bits;
    mine = bits != 0;
  } else {
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int ry = warp * kRowsPerWarp + j, y = y0 + ry, x = x0 + lane;
      const bool on = y < h && x < w && mask[(size_t)y * w + x] != 0;
      const unsigned bits = __ballot_sync(kAll, on);
      if (lane == 0) rows[ry] = bits;
      mine |= on;
    }
  }
  int v[kRowsPerWarp];
  if (!__syncthreads_or(mine)) {  // an empty tile: its sentinels, and it leaves
    for (int j = 0; j < kRowsPerWarp; ++j) v[j] = INT_MAX;
    store4(labels, wide, lane, warp, x0, y0, h, w, v);
    return false;
  }

  // a run's first pixel stands for the run: each run start is its own
  // parent, the other pixels have none
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int ry = warp * kRowsPerWarp + j;
    if ((run_starts(rows[ry]) >> lane) & 1u) parent[ry * kTile + lane] = ry * kTile + lane;
  }
  __syncthreads();

  // the runs of two rows united once a stretch where they touch: lane
  // 8 j + s takes the stretches s, s + 8, ... between the warp's row j and
  // the row above, so a warp's four rows unite at once
  {
    const int ry = warp * kRowsPerWarp + (lane >> 3);
    unsigned todo = 0;
    if (ry > 0) {
      const unsigned touch = rows[ry] & rows[ry - 1];
      todo = touch & ~(touch << 1);
    }
    for (int t = lane & 7; t > 0 && todo; --t) todo &= todo - 1u;
    while (todo) {
      const int x = __ffs(todo) - 1;
      unite(parent, ry * kTile + run_start(rows[ry], x),
            (ry - 1) * kTile + run_start(rows[ry - 1], x));
      for (int t = 0; t < 8 && todo; ++t) todo &= todo - 1u;
    }
  }
  __syncthreads();

  // each run start's root, its four chains chased at once; written back as
  // its parent (a thread that reads it mid-chase still finds an ancestor)
  {
    int node[kRowsPerWarp];
    bool live[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int ry = warp * kRowsPerWarp + j;
      live[j] = (run_starts(rows[ry]) >> lane) & 1u;
      node[j] = ry * kTile + lane;
    }
    bool more = true;
    while (more) {
      more = false;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        if (live[j]) {
          const int up = parent[node[j]];
          if (up != node[j]) {
            node[j] = up;
            more = true;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      if (live[j]) parent[(warp * kRowsPerWarp + j) * kTile + lane] = node[j];
    }
  }
  __syncthreads();

  // each pixel as the global index of its run start's root
  for (int j = 0; j < kRowsPerWarp; ++j) {
    int ry, cx;
    pixel_of(wide, lane, warp, j, ry, cx);
    const unsigned r = rows[ry];
    v[j] = INT_MAX;
    if ((r >> cx) & 1u) {
      const int root = parent[ry * kTile + run_start(r, cx)];
      v[j] = (y0 + root / kTile) * w + x0 + root % kTile;
    }
  }
  store4(labels, wide, lane, warp, x0, y0, h, w, v);
  return true;
}

// Pass 2 for tile (tx, ty), by two warps: the top row's edges (top) and
// the left column's.
__device__ __forceinline__ void border_pass(const unsigned char* __restrict__ mask, int* labels,
                                            const int* nonempty, int h, int w, int tx, int ty,
                                            int tiles_x, bool top, int lane) {
  const int tile = ty * tiles_x + tx;
  if (!nonempty[tile]) return;
  if (top ? ty == 0 || !nonempty[tile - tiles_x] : tx == 0 || !nonempty[tile - 1]) return;
  const int x0 = tx * kTile, y0 = ty * kTile;
  int p = 0, q = 0;
  bool both = false;
  if (top) {
    const int x = x0 + lane;
    if (x < w) {
      p = y0 * w + x;
      q = p - w;
      both = mask[p] && mask[q];
    }
  } else {
    const int y = y0 + lane;
    if (y < h) {
      p = y * w + x0;
      q = p - 1;
      both = mask[p] && mask[q];
    }
  }
  const unsigned b = __ballot_sync(kAll, both);
  if (((b & ~(b << 1)) >> lane) & 1u) unite_global(labels, p, q);  // a stretch's first edge
}

// Pass 3 for a non-empty tile.  Block (32, kWarps).  No unions run now, so
// a tree's root stays put and every value read on the way (another thread
// may be writing its pixel's root meanwhile) is an ancestor: plain loads.
__device__ __forceinline__ void flatten_pass(int* labels, int h, int w, bool wide, int x0,
                                             int y0) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  int v[kRowsPerWarp];
  if (wide) {
    int ry, cx;
    pixel_of(true, lane, warp, 0, ry, cx);
    const int y = y0 + ry, x = x0 + cx;
    if (y >= h || x >= w) return;
    const int4 got = *reinterpret_cast<const int4*>(labels + (size_t)y * w + x);
    v[0] = got.x;
    v[1] = got.y;
    v[2] = got.z;
    v[3] = got.w;
  } else {
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int y = y0 + warp * kRowsPerWarp + j, x = x0 + lane;
      v[j] = y < h && x < w ? labels[(size_t)y * w + x] : INT_MAX;
    }
  }
  for (int j = 0; j < kRowsPerWarp; ++j) {
    if (v[j] == INT_MAX) continue;
    int x = v[j], px;
    while ((px = labels[x]) != x) x = px;
    v[j] = x;
  }
  store4(labels, wide, lane, warp, x0, y0, h, w, v);
}

__global__ void __launch_bounds__(kTile* kWarps)
cc_local_kernel(const unsigned char* __restrict__ mask, int* __restrict__ labels,
                int* __restrict__ nonempty, int h, int w, bool wide) {
  __shared__ unsigned rows[kTile];       // bit x of rows[y]: tile pixel (y, x) is masked
  __shared__ int parent[kTile * kTile];  // local union-find over local indices y * kTile + x
  const bool any = local_pass(mask, labels, h, w, wide, blockIdx.x * kTile, blockIdx.y * kTile,
                              rows, parent);
  if (threadIdx.x == 0 && threadIdx.y == 0) nonempty[blockIdx.y * gridDim.x + blockIdx.x] = any;
}

__global__ void __launch_bounds__(2 * 32)
cc_border_kernel(const unsigned char* __restrict__ mask, int* labels,
                 const int* __restrict__ nonempty, int h, int w) {
  border_pass(mask, labels, nonempty, h, w, blockIdx.x, blockIdx.y, gridDim.x, threadIdx.x < 32,
              threadIdx.x & 31);
}

__global__ void __launch_bounds__(kTile* kWarps)
cc_flatten_kernel(int* labels, const int* __restrict__ nonempty, int h, int w, bool wide) {
  if (!nonempty[blockIdx.y * gridDim.x + blockIdx.x]) return;
  flatten_pass(labels, h, w, wide, blockIdx.x * kTile, blockIdx.y * kTile);
}

}  // namespace

// mask (h, w) u8, nonzero = set; labels (h, w) int32, written; nonempty one
// int a tile (ceil(h / 32) x ceil(w / 32), row-major), scratch.
extern "C" int tod_cc_labels(const void* mask, void* labels, void* nonempty, int h, int w,
                             void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* lab = static_cast<int*>(labels);
  int* flags = static_cast<int*>(nonempty);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((w + kTile - 1) / kTile), (unsigned)((h + kTile - 1) / kTile));
  const dim3 block(32, kWarps);
  const bool wide = w % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(lab) % 16 == 0;
  cc_local_kernel<<<grid, block, 0, s>>>(m, lab, flags, h, w, wide);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_border_kernel<<<grid, 2 * 32, 0, s>>>(m, lab, flags, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_flatten_kernel<<<grid, block, 0, s>>>(lab, flags, h, w, wide);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

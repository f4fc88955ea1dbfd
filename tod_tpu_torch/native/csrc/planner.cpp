// Native multi-source Dijkstra over the fused scene grid: the host planner's
// fast backend (a copy of the JAX package's native/csrc/planner.cpp, planner
// entry points only).
//
// A priority-queue Dijkstra over the H x W grid with 8-neighbour edges,
// called from Python through ctypes (tod_tpu_torch/planner/native.py and
// planner/api.py).  Edge cost entering node n from neighbour m:
// connections[n][dir(m->n reversed)] + |height[n] - height[m]|, matching
// tod_tpu_torch/planner/dijkstra.py (the NumPy version it is tested against).
// Built with g++ at first use into build/tod_tpu_torch/
// (tod_tpu_torch/native/loader.py).

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// NEIGHBOR_OFFSETS order (tod_tpu_torch/core/types.py): N, NE, E, SE, S, SW, W, NW
constexpr int DY[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
constexpr int DX[8] = {0, 1, 1, 1, 0, -1, -1, -1};

struct QNode {
  double dist;
  int32_t y, x;
  bool operator>(const QNode& o) const { return dist > o.dist; }
};

}  // namespace

extern "C" {

// height: (h*w) f32; conns: (h*w*8) f32, -1 = no edge; seeds: (n_seeds*2) i32
// as (y, x) pairs.  Outputs: dist (h*w) f64 (INFINITY = unreached), parent
// (h*w) i64 linear next-hop toward the nearest seed (-1 at seeds/unreached).
// Returns 0 on success.
int tod_dijkstra(const float* height, const float* conns, int h, int w,
                 const int32_t* seeds, int n_seeds, double* dist,
                 int64_t* parent) {
  const int64_t n = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < n; ++i) {
    dist[i] = INFINITY;
    parent[i] = -1;
  }
  std::priority_queue<QNode, std::vector<QNode>, std::greater<QNode>> pq;
  for (int s = 0; s < n_seeds; ++s) {
    int32_t y = seeds[2 * s], x = seeds[2 * s + 1];
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    dist[static_cast<int64_t>(y) * w + x] = 0.0;
    pq.push({0.0, y, x});
  }
  while (!pq.empty()) {
    QNode top = pq.top();
    pq.pop();
    const int64_t idx = static_cast<int64_t>(top.y) * w + top.x;
    if (top.dist > dist[idx]) continue;
    for (int i = 0; i < 8; ++i) {
      const int ny = top.y + DY[i], nx = top.x + DX[i];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      const int64_t nidx = static_cast<int64_t>(ny) * w + nx;
      // edge as seen from the node being entered: opposite direction index
      const float c = conns[nidx * 8 + ((i + 4) & 7)];
      if (c < 0.0f) continue;
      const double nd =
          top.dist + c + std::fabs(static_cast<double>(height[nidx]) -
                                   static_cast<double>(height[idx]));
      if (nd < dist[nidx]) {
        dist[nidx] = nd;
        parent[nidx] = idx;
        pq.push({nd, static_cast<int32_t>(ny), static_cast<int32_t>(nx)});
      }
    }
  }
  return 0;
}

namespace {

// Binary-heap fallback for the height-only variant (used when the bucket
// queue's window would be degenerate — see tod_dijkstra_height).
void dijkstra_height_heap(const float* height, int h, int w,
                          const int32_t* seeds, int n_seeds, int start_y,
                          int start_x, double* dist, int64_t* parent) {
  std::priority_queue<QNode, std::vector<QNode>, std::greater<QNode>> pq;
  for (int s = 0; s < n_seeds; ++s) {
    int32_t y = seeds[2 * s], x = seeds[2 * s + 1];
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    dist[static_cast<int64_t>(y) * w + x] = 0.0;
    pq.push({0.0, y, x});
  }
  while (!pq.empty()) {
    QNode top = pq.top();
    pq.pop();
    const int64_t idx = static_cast<int64_t>(top.y) * w + top.x;
    if (top.dist > dist[idx]) continue;
    if (top.y == start_y && top.x == start_x) break;  // start settled
    const double h0 = height[idx];
    for (int i = 0; i < 8; ++i) {
      const int ny = top.y + DY[i], nx = top.x + DX[i];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      const int64_t nidx = static_cast<int64_t>(ny) * w + nx;
      const double dh = static_cast<double>(height[nidx]) - h0;
      const double base = (DY[i] != 0 && DX[i] != 0) ? 2.0 : 1.0;
      const double nd = top.dist + std::sqrt(base + dh * dh) + std::fabs(dh);
      if (nd < dist[nidx]) {
        dist[nidx] = nd;
        parent[nidx] = idx;
        pq.push({nd, static_cast<int32_t>(ny), static_cast<int32_t>(nx)});
      }
    }
  }
}

}  // namespace

// Height-only variant: edge weights are derived from the height map inline
// (connections[n][i] = sqrt(dx² + dy² + Δh²) — exactly what the fusion stage
// materializes per pt_cloud_weights.comp — plus the planner's |Δh| term,
// src/path.rs:59).  Avoids materializing and reading back the (H, W, 8)
// connections tensor: the hot serving loop only transfers the height map.
// start_y/start_x: early-exit target — the search stops once the start node
// is settled (its shortest path is final when popped), typically saving half
// the grid relaxations.  Pass (-1, -1) to settle the whole grid.
//
// Queue: Dial-style circular bucket queue.  Every edge weighs at least 1.0
// (a straight step is sqrt(1 + dh²) + |dh| ≥ 1), so with bucket width 1.0 a
// node popped from bucket ⌊d⌋ can never be improved by another node of the
// same bucket (any relaxation adds ≥ 1 and lands in a strictly later bucket).
// Processing buckets in increasing order therefore settles nodes in true
// Dijkstra order with O(1) pushes/pops instead of the binary heap's O(log n);
// the active window is at most cmax = sqrt(2 + Δhmax²) + Δhmax buckets wide,
// so a circular array of ⌈cmax⌉ + 2 buckets suffices.  Falls back to the
// heap when the height range makes that window degenerate (> 1<<16 buckets).
int tod_dijkstra_height(const float* height, int h, int w, const int32_t* seeds,
                        int n_seeds, int start_y, int start_x, double* dist,
                        int64_t* parent) {
  const int64_t n = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < n; ++i) {
    dist[i] = INFINITY;
    parent[i] = -1;
  }

  float hmin = INFINITY, hmax = -INFINITY;
  for (int64_t i = 0; i < n; ++i) {
    hmin = std::min(hmin, height[i]);
    hmax = std::max(hmax, height[i]);
  }
  const double dhmax = static_cast<double>(hmax) - hmin;
  const double cmax = std::sqrt(2.0 + dhmax * dhmax) + dhmax;
  if (!(cmax >= 0.0) || cmax > static_cast<double>(1 << 16)) {
    dijkstra_height_heap(height, h, w, seeds, n_seeds, start_y, start_x, dist,
                         parent);
    return 0;
  }

  const int64_t nbuckets = static_cast<int64_t>(cmax) + 2;
  // Hot serving path: labels are kept in f32 (the height map itself is f32 —
  // per-edge rounding ~6e-8 relative, linear accumulation over a few hundred
  // hops stays ≤ ~1e-5, inside the backend-agreement band) and the working
  // buffers persist across calls so the steady-state plan is allocation-free.
  static thread_local std::vector<std::vector<int32_t>> buckets;
  static thread_local std::vector<uint8_t> settled;
  static thread_local std::vector<float> fdist;
  if (static_cast<int64_t>(buckets.size()) < nbuckets) buckets.resize(nbuckets);
  for (auto& b : buckets) b.clear();
  settled.assign(n, 0);
  fdist.assign(n, INFINITY);
  int64_t pending = 0;

  for (int s = 0; s < n_seeds; ++s) {
    int32_t y = seeds[2 * s], x = seeds[2 * s + 1];
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const int32_t idx = y * w + x;
    if (fdist[idx] == 0.0f) continue;  // duplicate seed
    fdist[idx] = 0.0f;
    buckets[0].push_back(idx);
    ++pending;
  }
  const int32_t start_idx =
      (start_y >= 0 && start_x >= 0) ? start_y * w + start_x : -1;

  for (int64_t cur = 0; pending > 0; ++cur) {
    std::vector<int32_t>& bucket = buckets[cur % nbuckets];
    // A node relaxed within this bucket's distance band re-enters the SAME
    // bucket only via a stale earlier push (impossible: edges ≥ 1), so one
    // sweep settles it; iterate by index in case of reallocation anyway.
    for (size_t bi = 0; bi < bucket.size(); ++bi) {
      const int32_t idx = bucket[bi];
      --pending;
      if (settled[idx]) continue;  // stale entry (improved into earlier bucket)
      const float d0 = fdist[idx];
      if (static_cast<int64_t>(d0) != cur) continue;  // stale (moved buckets)
      settled[idx] = 1;
      if (idx == start_idx) {  // start settled — its label is final
        pending = 0;
        break;
      }
      const int32_t y = idx / w;
      const int32_t x = idx % w;
      const float h0 = height[idx];
      for (int i = 0; i < 8; ++i) {
        const int ny = y + DY[i], nx = x + DX[i];
        if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
        const int32_t nidx = ny * w + nx;
        if (settled[nidx]) continue;
        const float dh = height[nidx] - h0;
        const float base = (DY[i] != 0 && DX[i] != 0) ? 2.0f : 1.0f;
        const float nd = d0 + std::sqrt(base + dh * dh) + std::fabs(dh);
        if (nd < fdist[nidx]) {
          fdist[nidx] = nd;
          parent[nidx] = idx;
          buckets[static_cast<int64_t>(nd) % nbuckets].push_back(nidx);
          ++pending;
        }
      }
    }
    bucket.clear();
  }
  for (int64_t i = 0; i < n; ++i) dist[i] = fdist[i];
  return 0;
}

// Negative result, kept as a note: an A* variant with the planar
// Euclidean lower bound settles the SAME optimal path but measured ~2×
// SLOWER than this bucket-queue Dijkstra on both smooth and random QVGA
// heights — the |Δh| term dominates edge costs, so the planar heuristic
// barely prunes, while f = g + h breaks the width-1 bucket property and
// forces a binary heap.  Don't re-add it without a cost-aware bound.

// Bidirectional Dial-bucket Dijkstra on the height-derived grid (a
// "~2× fewer settled nodes" lever for the host path).  Two bucket
// queues — forward from the ball seeds, backward from the start node (edge
// costs are symmetric, so both run the same relaxation) — advanced in
// balanced order (smaller current-bucket side first).  Meeting bound μ is
// tightened on every successful relaxation whose node carries the opposite
// label; the searches stop when cur_f + cur_b ≥ μ (bucket indices are lower
// bounds of each side's unsettled labels, so no remaining path can beat μ —
// the classic bidirectional termination made conservative by bucket
// granularity).  Unlike A*, this keeps the width-1 bucket property on both
// sides, so it composes with the Dial queue instead of fighting it.
//
// Output contract is tod_dijkstra_height's (dist = cost-to-seed, parent =
// next hop toward the seed) filled ONLY along the optimal start→seed path —
// exactly what extract_directions (planner/dijkstra.py) walks; every other
// entry stays INFINITY/-1.  Off-path labels would be half-finished by
// construction (that's where the speedup comes from), so none are reported.
int tod_dijkstra_height_bidir(const float* height, int h, int w,
                              const int32_t* seeds, int n_seeds, int start_y,
                              int start_x, double* dist, int64_t* parent) {
  const int64_t n = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < n; ++i) {
    dist[i] = INFINITY;
    parent[i] = -1;
  }
  if (start_y < 0 || start_x < 0 || start_y >= h || start_x >= w) {
    // negative = whole-grid request (no target to search toward); out-of-
    // grid = caller bug — either way the plain forward pass handles it
    // safely (it treats any non-grid start as "no early exit"), whereas
    // seeding B.fd[start_idx] below would write past the heap buffer.
    return tod_dijkstra_height(height, h, w, seeds, n_seeds, start_y, start_x,
                               dist, parent);
  }

  float hmin = INFINITY, hmax = -INFINITY;
  for (int64_t i = 0; i < n; ++i) {
    hmin = std::min(hmin, height[i]);
    hmax = std::max(hmax, height[i]);
  }
  const double dhmax = static_cast<double>(hmax) - hmin;
  const double cmax = std::sqrt(2.0 + dhmax * dhmax) + dhmax;
  if (!(cmax >= 0.0) || cmax > static_cast<double>(1 << 16)) {
    return tod_dijkstra_height(height, h, w, seeds, n_seeds, start_y, start_x,
                               dist, parent);
  }
  const int64_t nbuckets = static_cast<int64_t>(cmax) + 2;

  struct Side {
    std::vector<std::vector<int32_t>> buckets;
    std::vector<uint8_t> settled;
    std::vector<float> fd;
    std::vector<int64_t> par;
    int64_t pending = 0;
    int64_t cur = 0;
  };
  static thread_local Side F, B;
  for (Side* s : {&F, &B}) {
    if (static_cast<int64_t>(s->buckets.size()) < nbuckets)
      s->buckets.resize(nbuckets);
    for (auto& b : s->buckets) b.clear();
    s->settled.assign(n, 0);
    s->fd.assign(n, INFINITY);
    s->par.assign(n, -1);
    s->pending = 0;
    s->cur = 0;
  }

  const int32_t start_idx = start_y * w + start_x;
  for (int s = 0; s < n_seeds; ++s) {
    int32_t y = seeds[2 * s], x = seeds[2 * s + 1];
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const int32_t idx = y * w + x;
    if (idx == start_idx) {  // the robot is standing on a seed
      dist[idx] = 0.0;
      return 0;
    }
    if (F.fd[idx] == 0.0f) continue;  // duplicate seed
    F.fd[idx] = 0.0f;
    F.buckets[0].push_back(idx);
    ++F.pending;
  }
  if (F.pending == 0) return 0;  // no valid seeds: everything unreached
  B.fd[start_idx] = 0.0f;
  B.buckets[0].push_back(start_idx);
  ++B.pending;

  float mu = INFINITY;   // best known start→seed cost via a doubly-labeled node
  int32_t meet = -1;

  // One full bucket sweep for side S (other side O), then S.cur advances.
  auto sweep = [&](Side& S, const Side& O) {
    std::vector<int32_t>& bucket = S.buckets[S.cur % nbuckets];
    for (size_t bi = 0; bi < bucket.size(); ++bi) {
      const int32_t idx = bucket[bi];
      --S.pending;
      if (S.settled[idx]) continue;
      const float d0 = S.fd[idx];
      if (static_cast<int64_t>(d0) != S.cur) continue;  // moved buckets
      S.settled[idx] = 1;
      const int32_t y = idx / w;
      const int32_t x = idx % w;
      const float h0 = height[idx];
      for (int i = 0; i < 8; ++i) {
        const int ny = y + DY[i], nx = x + DX[i];
        if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
        const int32_t nidx = ny * w + nx;
        if (S.settled[nidx]) continue;
        const float dh = height[nidx] - h0;
        const float base = (DY[i] != 0 && DX[i] != 0) ? 2.0f : 1.0f;
        const float nd = d0 + std::sqrt(base + dh * dh) + std::fabs(dh);
        if (nd < S.fd[nidx]) {
          S.fd[nidx] = nd;
          S.par[nidx] = idx;
          S.buckets[static_cast<int64_t>(nd) % nbuckets].push_back(nidx);
          ++S.pending;
          if (O.fd[nidx] != INFINITY) {  // carries both labels: meeting bound
            const float cand = nd + O.fd[nidx];
            if (cand < mu) {
              mu = cand;
              meet = nidx;
            }
          }
        }
      }
    }
    bucket.clear();
    ++S.cur;
  };

  while (F.pending > 0 || B.pending > 0) {
    if (static_cast<double>(F.cur) + static_cast<double>(B.cur) >=
        static_cast<double>(mu))
      break;  // no undiscovered path can beat μ
    // balanced advance: grow the side with the smaller frontier (for the
    // multi-source forward vs single-source backward asymmetry this
    // equalizes *work*, where equal bucket depth would not)
    if (B.pending == 0 || (F.pending > 0 && F.pending <= B.pending)) {
      sweep(F, B);
    } else {
      sweep(B, F);
    }
  }
  if (meet < 0) return 0;  // start unreachable from every seed

  // Materialize the path.  Cost-to-seed of a backward-chain node x is
  // total − db(x); parents along that chain are reversed to point seed-ward.
  const double total =
      static_cast<double>(F.fd[meet]) + static_cast<double>(B.fd[meet]);
  for (int64_t x = meet; x >= 0; x = F.par[x]) {
    dist[x] = static_cast<double>(F.fd[x]);
    parent[x] = F.par[x];
  }
  int64_t prev = meet;
  for (int64_t x = B.par[meet]; x >= 0; x = B.par[x]) {
    dist[x] = total - static_cast<double>(B.fd[x]);
    parent[x] = prev;
    prev = x;
  }
  return 0;
}

}  // extern "C"

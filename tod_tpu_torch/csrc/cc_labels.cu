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
// Design: union-find with a fixed launch count, three kernels on one stream,
// no host readback.
//   1. init:    parent[i] = i on the mask, INT_MAX off it;
//   2. merge:   each masked pixel unions itself with its masked left and up
//               neighbours (every 4-connected edge once);
//   3. flatten: parent[i] = find(i).
// The union is the lock-free atomicMin union: it hangs the larger of the two
// roots under the smaller, and retries from the old value when the larger
// was no longer a root.  A parent only ever decreases and never rises above
// its node, so each tree's root is its smallest index, whatever order the
// atomics ran in: the result is deterministic and equal, bit for bit, to the
// propagation's fixpoint (every pixel holds its component's minimum linear
// index).  find reads parents with volatile loads (another thread may be
// writing them) and halves paths with atomicMin, which keeps the "only
// decreases" rule, so chains stay short on long components.
//
// Bound: the mask read once (1 byte a pixel) and the int32 labels written
// once; at 480x640 1.5 MB, about 0.5 us of memory time.  A first pass that
// merges inside shared-memory tiles before the global pass is a later
// redesign.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void cc_init_kernel(const unsigned char* __restrict__ mask, int* __restrict__ parent,
                               int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = mask[i] ? i : INT_MAX;
}

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

__global__ void cc_merge_kernel(const unsigned char* __restrict__ mask, int* parent, int h,
                                int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w || !mask[i]) return;
  const int x = i % w;
  if (x > 0 && mask[i - 1]) unite(parent, i, i - 1);
  if (i >= w && mask[i - w]) unite(parent, i, i - w);
}

__global__ void cc_flatten_kernel(const unsigned char* __restrict__ mask, int* parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && mask[i]) parent[i] = find_root(parent, i);
}

}  // namespace

extern "C" int tod_cc_labels(const void* mask, void* labels, int h, int w, void* stream) {
  const int n = h * w;
  if (n <= 0) return 0;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* parent = static_cast<int*>(labels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  cc_init_kernel<<<blocks, kThreads, 0, s>>>(m, parent, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_merge_kernel<<<blocks, kThreads, 0, s>>>(m, parent, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cc_flatten_kernel<<<blocks, kThreads, 0, s>>>(m, parent, n);
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

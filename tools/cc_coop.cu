// The three passes of tod_tpu_torch/csrc/cc_labels.cu in one cooperative
// launch, with a grid barrier between passes in place of the launch
// boundaries: the alternative to the kernel's three launches, timed beside
// them by tools/kernel_ab.py --cc.  Not used by the package.
//
// Pass 3 reads the labels with volatile loads: inside one launch another
// SM's unions are not guaranteed visible through this SM's L1.  A block
// keeps its tile through the barriers, so the grid is one block a tile and
// the launch fails where the tiles do not fit on the card at once.

#include "../tod_tpu_torch/csrc/cc_labels.cu"

#include <cooperative_groups.h>

namespace {

__global__ void __launch_bounds__(kTile* kWarps)
cc_coop_kernel(const unsigned char* __restrict__ mask, int* labels, int* nonempty, int h, int w,
               bool wide) {
  __shared__ unsigned rows[kTile];
  __shared__ int parent[kTile * kTile];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const bool any = local_pass(mask, labels, h, w, wide, x0, y0, rows, parent);
  if (threadIdx.x == 0 && threadIdx.y == 0) nonempty[blockIdx.y * gridDim.x + blockIdx.x] = any;
  cooperative_groups::this_grid().sync();
  if (threadIdx.y < 2) {
    border_pass(mask, labels, nonempty, h, w, blockIdx.x, blockIdx.y, gridDim.x,
                threadIdx.y == 0, threadIdx.x);
  }
  cooperative_groups::this_grid().sync();
  if (!any) return;
  const int lane = threadIdx.x, warp = threadIdx.y;
  volatile int* vl = labels;
  int v[kRowsPerWarp];
  for (int j = 0; j < kRowsPerWarp; ++j) {
    int ry, cx;
    pixel_of(wide, lane, warp, j, ry, cx);
    const int y = y0 + ry, x = x0 + cx;
    v[j] = y < h && x < w ? vl[(size_t)y * w + x] : INT_MAX;
    if (v[j] == INT_MAX) continue;
    int q = v[j], pq;
    while ((pq = vl[q]) != q) q = pq;
    v[j] = q;
  }
  store4(labels, wide, lane, warp, x0, y0, h, w, v);
}

}  // namespace

// The arguments of tod_cc_labels.
extern "C" int tod_cc_coop(const void* mask, void* labels, void* nonempty, int h, int w,
                           void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* lab = static_cast<int*>(labels);
  int* flags = static_cast<int*>(nonempty);
  bool wide = w % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 4 == 0 &&
              reinterpret_cast<uintptr_t>(lab) % 16 == 0;
  const dim3 grid((unsigned)((w + kTile - 1) / kTile), (unsigned)((h + kTile - 1) / kTile));
  const dim3 block(32, kWarps);
  void* args[] = {&m, &lab, &flags, &h, &w, &wide};
  return (int)cudaLaunchCooperativeKernel((const void*)cc_coop_kernel, grid, block, args, 0,
                                          static_cast<cudaStream_t>(stream));
}

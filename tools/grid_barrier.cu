// An empty cooperative kernel that takes n grid barriers: the floor under
// any kernel that synchronises the same grid n times.  tools/block_sweep.py
// builds it and times it beside the relaxation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void barriers_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

}  // namespace

// `blocks` blocks of `threads` threads with `smem` bytes of dynamic shared
// memory each (which decides how many share an SM), n barriers.
extern "C" int tod_grid_barriers(int blocks, int threads, int smem, int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(barriers_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n};
  err = cudaLaunchCooperativeKernel((const void*)barriers_kernel, dim3((unsigned)blocks),
                                    dim3((unsigned)threads), args, (size_t)smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* tod_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

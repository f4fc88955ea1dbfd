// Hopper's 1-D bulk copy (cp.async.bulk: the asynchronous-copy engine moves a
// contiguous run of bytes from global to shared memory with no thread's
// loads), completing on an mbarrier in shared memory.
//
// Use: one thread calls bulk_init, then (before any thread waits) a
// __syncthreads; one thread announces the bytes of all its copies with
// bulk_expect and issues them with bulk_load; every thread that reads the
// data calls bulk_wait(bar, 0) first.  Each copy needs 16-byte-aligned
// addresses and a size that is a multiple of 16.
//
// A ring of stages reuses its barriers: bar_init sets how many arrivals
// complete a phase, bar_arrive is one of them, and bulk_wait(bar, parity)
// waits for the phase of that parity.

#pragma once

#include <cstdint>

namespace tod {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier whose phases complete on ``count`` arrivals and the bytes announced.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier that completes its phase 0 on one arrival and the bytes announced.
__device__ __forceinline__ void bulk_init(uint64_t* bar) { bar_init(bar, 1); }

// One arrival, with no bytes.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// The one arrival, with the bytes the copies will deliver.
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase ``parity`` has completed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace tod

// Bulk copies into shared memory that complete on an mbarrier, for NVIDIA
// Hopper (sm_90a): the pieces of the probes' TMA rings
// (csrc/probe_stream.cu, csrc/probe_dia_ring.cu).
//
// A slot of a ring has a "full" barrier, initialised with one arrival.
// One thread arrives on it with the bytes it expects
// (mbarrier.arrive.expect_tx) and issues the copies into the slot
// (cp.async.bulk, the 1-D form of the Tensor Memory Accelerator: no
// tensor map, a contiguous run of bytes whose source and destination are
// 16-byte aligned and whose size is a multiple of 16).  The hardware
// counts the bytes as they land; the phase completes once the arrival
// and all the bytes are in.  Every use of a slot completes one phase, so
// use u of a slot is waited for with parity u & 1.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tma_ring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread, before any use; then fence_init() and a __syncthreads().
__device__ __forceinline__ void init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` still to land.
__device__ __forceinline__ void arrive_expect(uint64_t* bar,
                                              uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One plain arrival (a consumer releasing a slot).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global `src` into shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace tma_ring

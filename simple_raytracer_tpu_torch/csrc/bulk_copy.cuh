// 1-D bulk copies from device memory into shared memory (TMA,
// cp.async.bulk) completed on an mbarrier, shared by the triangle kernel
// (triangle_kernel.cu) and the BVH kernel's warp walk (bvh_kernel.cu).  A
// copy's source and destination are 16-byte aligned and its size a
// multiple of 16 bytes.  A wait that outlasts kSpinLimit polls traps
// instead of hanging the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSpinLimit = 1u << 24;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier that completes a phase on one arrival (and the
// bytes it expects)
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar))
               : "memory");
}

// after bar_init, before any thread waits or copies on the barrier
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: `bytes` from src into dst, completing the barrier's phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// wait for the barrier's phase of the given parity to complete
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spin == kSpinLimit) __trap();
  }
}

}  // namespace

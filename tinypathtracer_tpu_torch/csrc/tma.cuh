// TMA bulk copies into shared memory, completing on mbarriers: the helpers
// kernels A, B and C (dense.cu, mega.cu, packet.cu) stage their planes
// with.
//
// One thread initialises a block's barriers (one arrival each) and issues
// the copies; a copy arms its barrier with the bytes it will bring, and the
// barrier's phase completes when they have landed. Readers wait on the
// phase's parity.
#pragma once

#include <cstdint>

namespace tpt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: `count` barriers of one arrival each, made visible to the
// async proxy. The block synchronises before any thread waits on them.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int count) {
  for (int k = 0; k < count; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bars + k))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16, 16-byte aligned at both
// ends) from global src to shared dst, completing on bar. The buffer's last
// readers are behind a __syncthreads; the proxy fence orders their reads
// before the copy's writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace tpt

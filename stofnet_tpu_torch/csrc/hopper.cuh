// Hopper helpers shared by the wgmma kernels of this directory (the conv
// stack and the streamed SGB kernel): mbarriers, bulk copies, the
// descriptor of 128-byte swizzled rows and the wgmma group fences.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

// spin until the phase of `bar` with this parity has completed (the loop
// stays inside the asm: a C++ loop around try_wait is a divergent path to
// the compiler, which then serializes the wgmma that follow)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one bulk copy of `bytes` from device memory into shared memory, counted
// on `bar` (which this thread's arrival arms with the byte count)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// descriptor of 128-byte rows from row `i` of a buffer at shared address
// `base` (1,024-byte aligned): K-major, 128-byte swizzle, 8-row groups
// 1,024 B apart; + 2 steps K by 16 bf16 (32 bytes). The card applies the
// swizzle to absolute shared addresses, so a start at any row needs no base
// offset (a base offset of (start >> 7) & 7 reads the wrong chunks).
__device__ __forceinline__ uint64_t rows_desc(uint32_t base, int i) {
  const uint32_t a = base + i * 128;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

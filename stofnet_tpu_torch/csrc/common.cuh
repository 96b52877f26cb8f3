// Helpers shared by the kernels of this directory: the bf16 tensor-core
// product, the cp.async copies of the ring kernels and the error string of
// the plain C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// d += a * b on one m16n8k16 tile: a row-major 16x16 bf16, b column-major
// 16x8 bf16, d 16x8 f32. Fragment layout (g = lane / 4, q = lane % 4):
// a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..), a3 (g+8, 2q+8..);
// b0 (k 2q..2q+1, n g), b1 (k 2q+8.., n g); d0,d1 (g, 2q..2q+1),
// d2,d3 (g+8, 2q..2q+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 values as one 32-bit register (lower index low)
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one 16-byte cp.async.cg copy from device to shared memory; src_bytes 0
// reads nothing and writes 16 zero bytes (the zero fill of a padded row)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// close this thread's copies issued since the last commit into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// make `device` current for this host thread, calling cudaSetDevice only
// where another device is current
inline cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

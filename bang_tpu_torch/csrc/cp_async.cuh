// Staging global memory into shared memory with cp.async, shared by the
// kernels that copy each block's inputs in one commit group and then work
// from shared memory only (frontier_lookup.cu, exact_frontier.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Commit every cp.async this thread issued and wait for all of them; a
// __syncthreads() after it makes the whole block's copies visible.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;\n" ::
          : "memory");
}

// Copy `bytes` from src to shared dst with the whole block: 16-byte or
// 4-byte cp.async, or plain byte copies (VEC = 1). src and dst must be
// VEC-aligned and `bytes` a multiple of VEC.
template <int VEC>
__device__ __forceinline__ void copy_to_shared(uint8_t* dst, const uint8_t* src,
                                               int bytes) {
  for (int i = threadIdx.x; i < bytes / VEC; i += blockDim.x) {
    if (VEC == 16) {
      cp_async16(dst + i * 16, src + i * 16);
    } else if (VEC == 4) {
      cp_async4(dst + i * 4, src + i * 4);
    } else {
      dst[i] = src[i];
    }
  }
}

}  // namespace

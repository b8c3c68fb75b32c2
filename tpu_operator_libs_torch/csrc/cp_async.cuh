// cp.async from global to shared memory and its groups, shared by the
// kernels that stage tiles with it (decode_attention.cu,
// flash_attention_bwd.cu's 3xTF32 kernels).
#pragma once

#include <cuda_runtime.h>

namespace {

// 16 (or 4) bytes from global to shared memory; with `valid` false no
// byte is read and the destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace

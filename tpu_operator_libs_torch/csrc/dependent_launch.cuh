// Programmatic dependent launch (Hopper's griddepcontrol) for the small
// row-wise kernels (rms_norm.cu, swiglu.cu).
//
// A kernel launched with launch_dependent() may start while the kernel
// before it on the stream is still finishing: its blocks are scheduled
// once every block of that kernel has exited or called
// launch_dependents(). Until wait_for_prerequisites() returns, the
// earlier kernel's writes are not visible, so a kernel does nothing
// before it that reads a buffer an earlier kernel may write, and writes
// nothing to global memory (an earlier kernel may still read the buffer
// that the memory pool handed over). Work that depends on no earlier
// kernel (offsets) runs before it.
// launch_dependents() lets a successor launched the same way start early;
// it does nothing for one launched without the attribute (cuBLAS), and
// the successor's own wait still waits for this kernel's whole grid.
// A kernel launched without the attribute returns from the wait at once.
// Stream capture records the attribute as a programmatic edge of the
// graph (CUDA 12.3 or later, in the toolkit and the driver).
#pragma once

#include <cuda_runtime.h>

namespace dependent_launch {

// Waits until the kernels before this one on the stream have completed
// and their writes are visible.
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the next kernel on the stream, if launched with the attribute,
// be scheduled once every block of this grid has called it or exited.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" :::);
}

// Launches kernel<<<blocks, threads, 0, stream>>>(args...) with the
// programmatic stream serialization attribute.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             int threads, void* stream, Args... args) {
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// Blocks of `threads` threads of `kernel` that fit on one SM at once (at
// least 1), for sizing a grid that strides.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, reinterpret_cast<const void*>(kernel), threads, 0)
      != cudaSuccess) {
    return -1;
  }
  return blocks < 1 ? 1 : blocks;
}

}  // namespace dependent_launch

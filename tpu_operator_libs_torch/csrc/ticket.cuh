// The ordered last-ticket combine of a launch's blocks (rms_norm.cu,
// cross_entropy.cu, global_norm.cu): each block writes its partial, then
// draws a ticket from a counter in device memory; the block that draws
// the last one reads every partial and adds them in a fixed order, so two
// launches, or a replayed graph, give the same bits with no float
// atomics. The combining block sets the counter back to 0.
#pragma once

#include <cuda_runtime.h>

namespace tickets {

// The ticket of a block: an atomic add with release semantics for the
// block's partial (which its fence and barrier ordered before it) and
// acquire semantics for the other blocks' partials, at the card's scope.
__device__ __forceinline__ int take(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Whether this block drew the last of n tickets of `counter`. The
// block's barrier orders its threads' writes (its partial) before thread
// 0's fence and ticket, whose release makes them visible at the card's
// scope; the last ticket's acquire, and the barrier after it, order the
// other blocks' writes before every thread's reads. One fence a block,
// not one a thread: a fence in every thread measured slower on the norm
// backward's combine at the train shape on the H100. `ticket` is a
// __shared__ int of the block.
__device__ __forceinline__ bool last(int* counter, int n, int* ticket) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *ticket = take(counter);
  }
  __syncthreads();
  return *ticket == n - 1;
}

}  // namespace tickets

// The SwiGLU gate, forward and backward.
//
// swiglu_fwd: y = silu(g) * u, with silu(x) = x / (1 + exp(-x)) computed
// in float32 and rounded to the dtype, as PyTorch's F.silu, and the
// product rounded again, as the plain version's `F.silu(g) * u`.
// Replaces the gate `jax.nn.silu(m @ w_gate) * (m @ w_up)` of
// tpu_operator_libs/examples/llama.py:311 and llama_decode.py:251-252,
// which XLA fuses on the TPU (no Pallas source).
//
// swiglu_bwd: from dy, g and u in one pass,
//   t = round(dy * u),   s = 1 / (1 + exp(-g)),
//   dg = round(t * s * (1 + g * (1 - s))),   du = round(dy * silu(g))
// (silu(g) rounded as in the forward): the gradient autograd takes
// through `F.silu(g) * u`, each float32 operation rounded on its own.
//
// Every step is a correctly rounded float32 operation (__fdiv_rn,
// __frcp_rn, __fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction) or
// expf, which torch.exp and F.silu also call on the card, so kernel and
// plain version agree bit for bit where their expf does.
//
// Design: elementwise and bytes-bound. A thread takes kVec neighbouring
// elements (8 or 4 with vector loads), the grid strides over the vectors
// and a scalar tail takes the elements past the last whole vector.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vector_io.cuh"

namespace {

using vector_io::load;
using vector_io::round_to;
using vector_io::store;

constexpr int kThreads = 256;

__device__ __forceinline__ float silu(float x, int dtype) {
  return round_to(__fdiv_rn(x, __fadd_rn(1.f, expf(-x))), dtype);
}

template <int kVec>
__device__ __forceinline__ void gate(const void* g, const void* u, void* y,
                                     long long i, int dtype) {
  float a[kVec], b[kVec];
  load<kVec>(g, i, dtype, a);
  load<kVec>(u, i, dtype, b);
#pragma unroll
  for (int e = 0; e < kVec; ++e) a[e] = __fmul_rn(silu(a[e], dtype), b[e]);
  store<kVec>(y, i, dtype, a);
}

template <int kVec>
__device__ __forceinline__ void gate_grad(const void* dy, const void* g,
                                          const void* u, void* dg, void* du,
                                          long long i, int dtype) {
  float d[kVec], a[kVec], b[kVec], da[kVec], db[kVec];
  load<kVec>(dy, i, dtype, d);
  load<kVec>(g, i, dtype, a);
  load<kVec>(u, i, dtype, b);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float t = round_to(__fmul_rn(d[e], b[e]), dtype);
    const float s = __frcp_rn(__fadd_rn(1.f, expf(-a[e])));
    da[e] = __fmul_rn(__fmul_rn(t, s),
                      __fadd_rn(1.f, __fmul_rn(a[e], __fsub_rn(1.f, s))));
    db[e] = __fmul_rn(d[e], silu(a[e], dtype));
  }
  store<kVec>(dg, i, dtype, da);
  store<kVec>(du, i, dtype, db);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    swiglu_fwd_kernel(const void* g, const void* u, void* y, long long n,
                      int dtype) {
  const long long vectors = n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  for (long long v = first; v < vectors; v += stride) {
    gate<kVec>(g, u, y, v * kVec, dtype);
  }
  const long long tail = vectors * kVec + first;
  if (tail < n) gate<1>(g, u, y, tail, dtype);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    swiglu_bwd_kernel(const void* dy, const void* g, const void* u, void* dg,
                      void* du, long long n, int dtype) {
  const long long vectors = n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  for (long long v = first; v < vectors; v += stride) {
    gate_grad<kVec>(dy, g, u, dg, du, v * kVec, dtype);
  }
  const long long tail = vectors * kVec + first;
  if (tail < n) gate_grad<1>(dy, g, u, dg, du, tail, dtype);
}

// Blocks for n elements at kVec a thread: one vector a thread, up to
// `max_blocks` (then the grid strides); at least one for the tail.
unsigned blocks_for(long long n, int vec, int max_blocks) {
  const long long vectors = n / vec;
  long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

bool args_ok(long long n, int dtype, int vec, int max_blocks) {
  return n >= 1 && (dtype == 0 || dtype == 1)
         && (vec == 1 || vec == 4 || vec == 8) && max_blocks >= 1;
}

}  // namespace

// g, u, y (n,) of dtype (0 float32, 1 bfloat16), contiguous; vec:
// elements a load (every buffer aligned to vec elements, at most 16
// bytes); at most max_blocks blocks of 256 threads.
extern "C" int swiglu_fwd(const void* g, const void* u, void* y, long long n,
                          int dtype, int vec, int max_blocks, void* stream) {
  using vector_io::aligned;
  if (g == nullptr || u == nullptr || y == nullptr
      || !args_ok(n, dtype, vec, max_blocks) || !aligned(g, vec, dtype)
      || !aligned(u, vec, dtype) || !aligned(y, vec, dtype)) {
    return cudaErrorInvalidValue;
  }
  const unsigned blocks = blocks_for(n, vec, max_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    swiglu_fwd_kernel<8><<<blocks, kThreads, 0, s>>>(g, u, y, n, dtype);
  } else if (vec == 4) {
    swiglu_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(g, u, y, n, dtype);
  } else {
    swiglu_fwd_kernel<1><<<blocks, kThreads, 0, s>>>(g, u, y, n, dtype);
  }
  return cudaGetLastError();
}

// dy, g, u, dg, du (n,) of dtype, contiguous; vec and max_blocks as
// swiglu_fwd.
extern "C" int swiglu_bwd(const void* dy, const void* g, const void* u,
                          void* dg, void* du, long long n, int dtype, int vec,
                          int max_blocks, void* stream) {
  using vector_io::aligned;
  if (dy == nullptr || g == nullptr || u == nullptr || dg == nullptr
      || du == nullptr || !args_ok(n, dtype, vec, max_blocks)
      || !aligned(dy, vec, dtype) || !aligned(g, vec, dtype)
      || !aligned(u, vec, dtype) || !aligned(dg, vec, dtype)
      || !aligned(du, vec, dtype)) {
    return cudaErrorInvalidValue;
  }
  const unsigned blocks = blocks_for(n, vec, max_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    swiglu_bwd_kernel<8><<<blocks, kThreads, 0, s>>>(dy, g, u, dg, du, n,
                                                     dtype);
  } else if (vec == 4) {
    swiglu_bwd_kernel<4><<<blocks, kThreads, 0, s>>>(dy, g, u, dg, du, n,
                                                     dtype);
  } else {
    swiglu_bwd_kernel<1><<<blocks, kThreads, 0, s>>>(dy, g, u, dg, du, n,
                                                     dtype);
  }
  return cudaGetLastError();
}

// The text of a cudaError_t that swiglu_fwd or swiglu_bwd returned.
extern "C" const char* swiglu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

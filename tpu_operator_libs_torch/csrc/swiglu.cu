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
// Design: elementwise and bytes-bound at the train shape (134M
// elements), a chain of latencies at the decode step's 65,536. The
// forward takes typed __restrict__ pointers (T float or bfloat16): a
// block takes a tile of kUnroll x 256 vectors of kVec neighbouring
// elements (8 or 4 with vector loads, 1 where an address does not allow
// them), each thread kUnroll of them 256 vectors apart, with every load
// of the tile (g, then u) issued before any arithmetic and held packed
// as loaded (two bfloat16 a register) until it; a grid sized to
// the SMs times the blocks resident on one strides over the tiles, and a
// scalar tail takes the elements past the last whole vector. It is
// launched with programmatic dependent launch (dependent_launch.cuh):
// nothing but offsets before the wait (g and u are the products just
// before it), every store after it. The backward (a thread a vector, the
// grid striding, untyped pointers) is launched plainly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dependent_launch.cuh"
#include "vector_io.cuh"

namespace {

using dependent_launch::launch_dependents;
using dependent_launch::wait_for_prerequisites;
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

// kVec elements of T (4 or 8) as one vector load brought them, read an
// element at a time as float32: a bfloat16 stays packed two to a
// register until its arithmetic, which halves the registers that the
// loads in flight hold
template <typename T, int kVec>
struct Packed {
  static constexpr int kWords = kVec * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int c = 0; c < kWords; c += 4) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[c / 4];
        w[c] = v.x;
        w[c + 1] = v.y;
        w[c + 2] = v.z;
        w[c + 3] = v.w;
      }
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    }
  }

  // a bfloat16 is the high half of the float32 with the same bits
  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[e]);
    return __uint_as_float(e % 2 == 0 ? w[e / 2] << 16
                                      : w[e / 2] & 0xffff0000u);
  }
};

// one element, converted as it is loaded
template <typename T>
struct Packed<T, 1> {
  float v;

  __device__ __forceinline__ void load(const T* p) {
    float x[1];
    vector_io::load<1>(p, 0, std::is_same<T, float>::value ? 0 : 1, x);
    v = x[0];
  }

  __device__ __forceinline__ float at(int) const { return v; }
};

template <typename T, int kVec, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    swiglu_fwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                      T* __restrict__ y, long long n) {
  constexpr int kDtype = std::is_same<T, float>::value ? 0 : 1;
  constexpr long long kTile = static_cast<long long>(kThreads) * kUnroll;
  const long long vectors = n / kVec;
  const long long tiles = (vectors + kTile - 1) / kTile;
  wait_for_prerequisites();
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long first = tile * kTile + threadIdx.x;
    Packed<T, kVec> a[kUnroll], b[kUnroll];
    // every load of the tile before any arithmetic
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long v = first + j * kThreads;
      if (v < vectors) a[j].load(g + v * kVec);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long v = first + j * kThreads;
      if (v < vectors) b[j].load(u + v * kVec);
    }
    if (tile + gridDim.x >= tiles) launch_dependents();
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long v = first + j * kThreads;
      if (v >= vectors) continue;
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        out[e] = __fmul_rn(silu(a[j].at(e), kDtype), b[j].at(e));
      }
      store<kVec>(y, v * kVec, kDtype, out);
    }
  }
  const long long tail = vectors * kVec
                         + static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x;
  if (tail < n) gate<1>(g, u, y, tail, kDtype);
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

// The forward instance for (T, vec, unroll), or null
template <typename T>
using FwdKernel = void (*)(const T*, const T*, T*, long long);

template <typename T, int kVec>
FwdKernel<T> forward_unrolled(int unroll) {
  switch (unroll) {
    case 1: return swiglu_fwd_kernel<T, kVec, 1>;
    case 2: return swiglu_fwd_kernel<T, kVec, 2>;
    case 4: return swiglu_fwd_kernel<T, kVec, 4>;
    default: return nullptr;
  }
}

template <typename T>
FwdKernel<T> forward_kernel(int vec, int unroll) {
  if (vec == 8) return forward_unrolled<T, 8>(unroll);
  if (vec == 4) return forward_unrolled<T, 4>(unroll);
  if (vec == 1) return forward_unrolled<T, 1>(unroll);
  return nullptr;
}

template <typename T>
int launch_forward(const void* g, const void* u, void* y, long long n,
                   int vec, int unroll, int blocks, void* stream) {
  const FwdKernel<T> kernel = forward_kernel<T>(vec, unroll);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return dependent_launch::launch_dependent(
      kernel, static_cast<unsigned>(blocks), kThreads, stream,
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(y),
      n);
}

}  // namespace

// g, u, y (n,) of dtype (0 float32, 1 bfloat16), contiguous; vec:
// elements a load (every buffer aligned to vec elements, at most 16
// bytes); unroll: vectors a thread a tile, 1, 2 or 4; blocks of 256
// threads, at least 1 and at most one a tile (one for n below a vector).
// Launched with programmatic dependent launch.
extern "C" int swiglu_fwd(const void* g, const void* u, void* y, long long n,
                          int dtype, int vec, int unroll, int blocks,
                          void* stream) {
  using vector_io::aligned;
  const long long tile = static_cast<long long>(kThreads) * unroll;
  if (g == nullptr || u == nullptr || y == nullptr
      || !args_ok(n, dtype, vec, blocks) || unroll < 1
      || (blocks > 1 && blocks > (n / vec + tile - 1) / tile)
      || !aligned(g, vec, dtype) || !aligned(u, vec, dtype)
      || !aligned(y, vec, dtype)) {
    return cudaErrorInvalidValue;
  }
  return dtype == 0
             ? launch_forward<float>(g, u, y, n, vec, unroll, blocks, stream)
             : launch_forward<__nv_bfloat16>(g, u, y, n, vec, unroll, blocks,
                                             stream);
}

// Blocks of the forward instance (dtype, vec, unroll) that fit on one SM
// of the current device, or -1 for an instance that does not exist or a
// failed query.
extern "C" int swiglu_fwd_resident(int dtype, int vec, int unroll) {
  if (dtype == 0) {
    const FwdKernel<float> kernel = forward_kernel<float>(vec, unroll);
    return kernel == nullptr
               ? -1 : dependent_launch::resident_blocks(kernel, kThreads);
  }
  const FwdKernel<__nv_bfloat16> kernel =
      forward_kernel<__nv_bfloat16>(vec, unroll);
  return dtype != 1 || kernel == nullptr
             ? -1 : dependent_launch::resident_blocks(kernel, kThreads);
}

// dy, g, u, dg, du (n,) of dtype, contiguous; vec as swiglu_fwd; a
// thread a vector, at most max_blocks blocks of 256 threads.
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

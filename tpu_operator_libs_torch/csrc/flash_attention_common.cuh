// What the flash-attention forward (flash_attention_fwd.cu), backward
// (flash_attention_bwd.cu) and the ring fold (attention_fold.cu) share: the
// (dtype, head_dim) dispatch, the base-2 constants and four-element loads
// and stores of f32 or bf16 rows. Inputs are f32 or bf16 and every sum is
// f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls fn(TypeTag<T>{}, std::integral_constant<int, D>{}) for the element
// type (0 = float32, 1 = bfloat16) and head_dim the kernels are built for.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& fn) {
  auto by_dim = [&](auto tag) -> cudaError_t {
    switch (head_dim) {
      case 16: return fn(tag, std::integral_constant<int, 16>{});
      case 32: return fn(tag, std::integral_constant<int, 32>{});
      case 64: return fn(tag, std::integral_constant<int, 64>{});
      case 128: return fn(tag, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_dim(TypeTag<float>{});
  if (dtype == 1) return by_dim(TypeTag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The text of a cudaError_t that an entry point returned. Each .cu file is
// its own shared library, so each defines this once.
extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

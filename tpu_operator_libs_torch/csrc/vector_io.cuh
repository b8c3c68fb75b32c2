// Loads and stores of kVec neighbouring elements of a float32 or bfloat16
// buffer, as float32 in registers, for the row-wise elementwise kernels
// (rms_norm.cu, swiglu.cu). The dtype is a run-time code (0 float32, 1
// bfloat16), so one kernel instance serves every mix of dtypes; kVec is a
// template argument: 8 or 4 elements take 16- or 8-byte vector loads
// (the caller guarantees kVec-element alignment), 1 takes one element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vector_io {

// x rounded to dtype's precision (bfloat16 round-to-nearest-even), as
// float32
__device__ __forceinline__ float round_to(float x, int dtype) {
  return dtype == 0 ? x : __bfloat162float(__float2bfloat16_rn(x));
}

template <int kVec>
__device__ __forceinline__ void load(const void* p, long long i, int dtype,
                                     float (&x)[kVec]) {
  if (dtype == 0) {
    const float* f = static_cast<const float*>(p) + i;
    if constexpr (kVec % 4 == 0) {
#pragma unroll
      for (int c = 0; c < kVec; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(f + c);
        x[c] = v.x;
        x[c + 1] = v.y;
        x[c + 2] = v.z;
        x[c + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) x[c] = f[c];
    }
    return;
  }
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p) + i;
  if constexpr (kVec == 8 || kVec == 4) {
    uint32_t w[kVec / 2];
    if constexpr (kVec == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(b);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(b);
      w[0] = v.x;
      w[1] = v.y;
    }
    // a bfloat16 is the high half of the float32 with the same bits
#pragma unroll
    for (int c = 0; c < kVec / 2; ++c) {
      x[2 * c] = __uint_as_float(w[c] << 16);
      x[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) x[c] = __bfloat162float(b[c]);
  }
}

// kVec values to a float32 (0) or bfloat16 (1, rounded to nearest even)
// buffer
template <int kVec>
__device__ __forceinline__ void store(void* p, long long i, int dtype,
                                      const float (&x)[kVec]) {
  if (dtype == 0) {
    float* f = static_cast<float*>(p) + i;
    if constexpr (kVec % 4 == 0) {
#pragma unroll
      for (int c = 0; c < kVec; c += 4) {
        *reinterpret_cast<float4*>(f + c) =
            make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) f[c] = x[c];
    }
    return;
  }
  __nv_bfloat16* b = static_cast<__nv_bfloat16*>(p) + i;
  if constexpr (kVec == 8 || kVec == 4) {
    uint32_t w[kVec / 2];
#pragma unroll
    for (int c = 0; c < kVec / 2; ++c) {
      union {
        __nv_bfloat162 h;
        uint32_t u;
      } pair;
      pair.h = __floats2bfloat162_rn(x[2 * c], x[2 * c + 1]);
      w[c] = pair.u;
    }
    if constexpr (kVec == 8) {
      *reinterpret_cast<uint4*>(b) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(b) = make_uint2(w[0], w[1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) b[c] = __float2bfloat16_rn(x[c]);
  }
}

// Whether ptr is aligned for vec-element vectors of dtype: to their
// size, at most 16 bytes (a null pointer passes)
inline bool aligned(const void* ptr, int vec, int dtype) {
  uintptr_t bytes = static_cast<uintptr_t>(vec) * (dtype == 0 ? 4 : 2);
  if (bytes > 16) bytes = 16;
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace vector_io

// The block of the flash-attention kernels that run their products as
// three TF32 mma.sync (tf32_mma.cuh): the forward (flash_attention_fwd.cu)
// and the backward's dK/dV and dQ (flash_attention_bwd.cu), for f32 at
// every head_dim and bf16 at 16 and 32. Its shape, the padded tiles that
// 16-byte cp.async stages (cp_async.cuh), the exchange through which the
// two warps of a row slice add their halves, and the stores of the
// accumulator fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "cp_async.cuh"

namespace {

namespace tf32 {

// The block: kWarps warps over kRows rows of its own (keys for dK/dV,
// queries for the forward and dQ), and the streamed tiles of kRows rows
// (queries for dK/dV, keys for the forward and dQ) through kStages
// stages. Warp w owns the own rows
// 16 (w % 4) + [0, 16) and the half kHalf (w / 4) + [0, kHalf) of each
// streamed tile.
constexpr int kRows = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kHalf = kRows / 2;
// Columns of the backward's first products' depth (head_dim) unrolled at
// once: a whole unrolled loop at D = 128 took 255 registers and spilled;
// 32 at a time does not (PERF.md §6).
template <int D>
__host__ __device__ constexpr int chunk() {
  return D < 32 ? D : 32;
}

// A tile's row stride in elements: 16 bytes of padding, which keeps every
// fragment load free of bank conflicts and every row 16-byte aligned.
template <typename T, int D>
__host__ __device__ constexpr int stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
__host__ __device__ constexpr int tile_bytes() {
  return kRows * stride<T, D>() * static_cast<int>(sizeof(T));
}

// A kernel's grid, flattened: a block per (kRows own rows, head, batch),
// with H query heads for dK/dV too (a group's heads on blocks of their
// own).
inline long long blocks(int B, int H, int rows) {
  return static_cast<long long>((rows + kRows - 1) / kRows) * H * B;
}

// Rows [r0, r0 + kRows) of a (rows x D) row-major plane in global memory
// into a padded tile, by 16-byte cp.async; rows at or past `rows` are
// zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, const T* plane, int r0,
                                           int rows) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kPerChunk;  // a row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int x = c % kChunks * kPerChunk;
    const bool valid = r0 + r < rows;
    cp_async16(dst + r * stride<T, D>() + x,
               plane + static_cast<size_t>(valid ? r0 + r : 0) * D + x,
               valid);
  }
}

// Warps w and w + 4 hold partial sums of the same accumulator rows, each
// over its half of the streamed rows. The second half's warps `put` theirs
// into shared memory that is free by then, and after a barrier the first
// half's `add` them to their own, first half first; `slot` picks one of a
// warp's accumulators.
template <int N>
__device__ __forceinline__ float* exchange_slot(float* xch, int slot,
                                                int slots) {
  return xch + ((threadIdx.x / 32 % 4) * slots + slot) * N * 4 * 32;
}

template <int N>
__device__ __forceinline__ void put(const float (&acc)[N][4], float* dst) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[(4 * n + e) * 32 + threadIdx.x % 32] = acc[n][e];
    }
  }
}

template <int N>
__device__ __forceinline__ void add(float (&acc)[N][4], const float* src) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += src[(4 * n + e) * 32 + threadIdx.x % 32];
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The rows of an accumulator fragment (row0 + 8 r, r = 0, 1) and its
// columns 8 n + 2 (lane % 4) + [0, 2) into a row-major (rows x D) array
// from row `row0`'s element 0 on, times `scale`; rows at or past `rows`
// are not written.
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[N][4],
                                           int row0, int rows, float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= rows) continue;
    T* row = out + static_cast<size_t>(8 * r) * (N * 8) + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      store2(row + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

}  // namespace tf32

}  // namespace

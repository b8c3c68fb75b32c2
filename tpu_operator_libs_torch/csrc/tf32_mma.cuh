// Float32 products on Hopper's tensor cores as three TF32 products
// (flash_attention_bwd.cu's tf32 kernels).
//
// A TF32 product keeps 10 bits of each operand's mantissa, so one product
// is some 2^-11 off in relative terms: far outside the f32 kernels' 2e-5.
// Each f32 operand x is split as hi = x rounded to TF32 (to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds) and lo = x - hi (exact in
// f32), and a * b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi into an
// f32 accumulator: what is dropped, a_lo b_lo and lo's bits below TF32's
// (the tensor core reads only a TF32 operand's top 19 bits), is some 2^-21
// of |a b|. hi is rounded by an integer add and mask: with
// cvt.rna.tf32.f32 in its place both kernels took 29-32% longer on an
// NVIDIA H100 80GB HBM3 at 700 W (flash_backward_variants.py, PERF.md
// §6). An operand that is exact in TF32 (a bf16 input widened to f32)
// has lo = 0, and its cross product is skipped at compile time.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, per warp, with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k8"):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)                       (k, n)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product's k index may be permuted as long as A and B take the same
// permutation. Reading A's k slot t as column 2t and slot t + 4 as column
// 2t + 1 makes an accumulator's fragment (c0, c2, c1, c3) the A fragment of
// the next product with no exchange between lanes: B then takes rows 2t
// and 2t + 1 (b_rows_pair below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tf32 {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x as hi + lo TF32 words (lo's low 13 bits left for the tensor core to
// drop); with kLo false x is exact in TF32 (hi = x, no lo). Finite x only.
template <bool kLo>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kLo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
  }
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as a_lo b_hi + a_hi b_lo + a_hi b_hi; a cross product whose lo
// word is 0 (kLoA or kLoB false) is not issued.
template <bool kLoA, bool kLoB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (kLoA) mma(d, a.lo, b.hi);
  if constexpr (kLoB) mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The A fragment of rows [0, 16) and columns [c0, c0 + 8) of a row-major
// tile (row stride `stride` elements) in shared memory.
template <bool kLo, typename T>
__device__ __forceinline__ FragA a_rows(const T* tile, int stride, int c0,
                                        int lane) {
  const T* p = tile + (lane / 4) * stride + c0 + lane % 4;
  FragA f;
  split<kLo>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kLo>(to_f32(p[8 * stride]), f.hi[1], f.lo[1]);
  split<kLo>(to_f32(p[4]), f.hi[2], f.lo[2]);
  split<kLo>(to_f32(p[8 * stride + 4]), f.hi[3], f.lo[3]);
  return f;
}

// The A fragment of an accumulator (its 16 x 8 as the next product's
// 16 x 8 slice of k, slots permuted as the header says).
template <bool kLo>
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  FragA f;
  split<kLo>(c[0], f.hi[0], f.lo[0]);
  split<kLo>(c[2], f.hi[1], f.lo[1]);
  split<kLo>(c[1], f.hi[2], f.lo[2]);
  split<kLo>(c[3], f.hi[3], f.lo[3]);
  return f;
}

// The B fragment of B = X^T for rows [0, 8) of a row-major X in shared
// memory and X's columns [c0, c0 + 8) as k: b0 = X[g][c0 + t],
// b1 = X[g][c0 + t + 4] (the products S = Q K^T and the like).
template <bool kLo, typename T>
__device__ __forceinline__ FragB b_cols(const T* x, int stride, int c0,
                                        int lane) {
  const T* p = x + (lane / 4) * stride + c0 + lane % 4;
  FragB f;
  split<kLo>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kLo>(to_f32(p[4]), f.hi[1], f.lo[1]);
  return f;
}

// The B fragment of B = X for X's rows [0, 8) as k, in the permuted slots
// that a_from_acc takes, and X's columns [c0, c0 + 8): b0 = X[2t][c0 + g],
// b1 = X[2t + 1][c0 + g] (the products dV = P^T dO and the like).
template <bool kLo, typename T>
__device__ __forceinline__ FragB b_rows_pair(const T* x, int stride, int c0,
                                             int lane) {
  const T* p = x + 2 * (lane % 4) * stride + c0 + lane / 4;
  FragB f;
  split<kLo>(to_f32(p[0]), f.hi[0], f.lo[0]);
  split<kLo>(to_f32(p[stride]), f.hi[1], f.lo[1]);
  return f;
}

}  // namespace tf32
}  // namespace

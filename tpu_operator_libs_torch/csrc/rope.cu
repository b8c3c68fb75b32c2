// RoPE of one layer's queries and keys in the batch forward, and its
// gradient, in one launch each.
//
// rope_qk rotates q (B, S, heads, dim) and k (B, S, kv_heads, dim) by the
// angles position * freqs[i] over the half-split pairs (i, i + dim / 2)
// and, with v, copies v (B, S, kv_heads, dim) beside them. It writes the
// input layout or, with head_major, (B, heads, S, dim): the layout that
// the flash kernels read, so the batch forward makes no transposed copies
// of q, k and v. rope_qk_bwd takes the gradients of those outputs (in
// the layout rope_qk wrote) back to the input layout: q's and k's rotated
// by the negated angles, v's copied. Replaces tpu_operator_libs/examples/
// llama.py::_rope (:117-136), called on q and k at :280, and its gradient
// through jax.grad, with the transposes of :292-298. XLA fuses them on the
// TPU (no Pallas source).
//
// Bound: bytes. Each element is read once and written once, with six
// float32 operations: at the train step's (16, 1024, 16/16, 128) bf16
// with v that is 384 MB a launch, 0.12 ms at 3.35 TB/s. The angle of a
// pair depends on the position and the pair alone, not on the head, and
// libdevice's cosf and sinf take tens of instructions each. So a thread
// owns one token's kVec neighbouring pairs, computes their cosines and
// sines once, and walks heads with them: the q, k and v heads of a layer
// in one flat index, split over gridDim.y so that the grid fills the
// card where tokens are few (the ring's blocks). Neighbouring threads
// take neighbouring pairs of one row, then the next token's: kVec = 8
// bf16 (or 4 float32) pairs give 16-byte loads and stores, 128 bytes of
// each half-row a token. The row's offset in either layout is computed,
// so both layouts cost the same.
//
// Every step is a correctly rounded float32 operation or libdevice's
// cosf / sinf, which torch.cos and torch.sin also call, so the outputs
// equal the plain versions bit for bit:
//  - forward, as _rope (rope_kv_append's rotation, csrc/kv_append.cu):
//    the angle is one product of the float32 position and the frequency
//    from a device buffer made by _rope's own expression; each product
//    and the sum or difference rounded on its own (no FMA contraction),
//    then once to x's dtype;
//  - backward, as autograd through _rope: each product of the gradient
//    with cos or sin rounded to x's dtype, then their sum (dx1 = dy1 c +
//    dy2 s, dx2 = dy2 c - dy1 s) rounded to it, then + 0, since autograd
//    adds the two half-slices' gradients into zeros (-0 becomes +0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vector_io.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  // q, k and v (v may be null); the outputs of the same shapes
  const void* in[3];
  void* out[3];
  const float* freqs;          // (dim / 2,) the rotation's frequencies
  const long long* positions;  // (seq,) int64, or null for 0 .. seq - 1
  int batch, seq, heads, kv_heads, dim, dtype;  // dtype: 0 f32, 1 bf16
  bool in_head_major, out_head_major;
};

// The offset of row (b, s, h) of a tensor with `heads` heads: (B, S,
// heads, dim) or, head-major, (B, heads, S, dim)
__device__ __forceinline__ long long row_of(bool head_major, int b, int s,
                                            int h, int heads, int seq) {
  return head_major
             ? (static_cast<long long>(b) * heads + h) * seq + s
             : (static_cast<long long>(b) * seq + s) * heads + h;
}

// The pairs (x1[e], x2[e]) rotated by the angles whose cosines and sines
// are c[e], s[e], as _rope: (x1 c - x2 s, x1 s + x2 c), each product and
// the sum or difference rounded on its own (the store rounds to dtype)
template <int kVec>
__device__ __forceinline__ void rotate(float (&x1)[kVec], float (&x2)[kVec],
                                       const float (&c)[kVec],
                                       const float (&s)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float y1 = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], s[e]));
    const float y2 = __fadd_rn(__fmul_rn(x1[e], s[e]), __fmul_rn(x2[e], c[e]));
    x1[e] = y1;
    x2[e] = y2;
  }
}

// The gradients (dy1[e], dy2[e]) of a rotated pair taken back through the
// rotation with autograd's roundings: (dy1 c + dy2 s, dy2 c - dy1 s), each
// product rounded to dtype, then the sum, then + 0
template <int kVec>
__device__ __forceinline__ void unrotate(float (&d1)[kVec], float (&d2)[kVec],
                                         const float (&c)[kVec],
                                         const float (&s)[kVec], int dtype) {
  using vector_io::round_to;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float d1c = round_to(__fmul_rn(d1[e], c[e]), dtype);
    const float d1s = round_to(__fmul_rn(d1[e], s[e]), dtype);
    const float d2c = round_to(__fmul_rn(d2[e], c[e]), dtype);
    const float d2s = round_to(__fmul_rn(d2[e], s[e]), dtype);
    d1[e] = __fadd_rn(round_to(__fadd_rn(d1c, d2s), dtype), 0.0f);
    d2[e] = __fadd_rn(round_to(__fsub_rn(d2c, d1s), dtype), 0.0f);
  }
}

// A thread: pairs j .. j + kVec - 1 of token (b, s), in the heads
// blockIdx.y, blockIdx.y + gridDim.y, ... of the flat index over q's,
// k's and v's heads
template <bool kBackward, int kVec>
__global__ void __launch_bounds__(kThreads) rope_kernel(const Params p) {
  const int half = p.dim / 2;
  const int per_token = half / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(p.batch) * p.seq * per_token) return;
  const int j = static_cast<int>(idx % per_token) * kVec;
  const long long token = idx / per_token;
  const int s = static_cast<int>(token % p.seq);
  const int b = static_cast<int>(token / p.seq);
  const float pos = p.positions != nullptr
                        ? static_cast<float>(p.positions[s])
                        : static_cast<float>(s);
  float c[kVec], sn[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float angle = __fmul_rn(pos, p.freqs[j + e]);
    c[e] = cosf(angle);
    sn[e] = sinf(angle);
  }
  const int total =
      p.heads + (p.in[2] != nullptr ? 2 : 1) * p.kv_heads;
  for (int flat = blockIdx.y; flat < total; flat += gridDim.y) {
    const int t = flat < p.heads ? 0 : flat < p.heads + p.kv_heads ? 1 : 2;
    const int heads = t == 0 ? p.heads : p.kv_heads;
    const int h = t == 0 ? flat : flat - p.heads - (t == 2 ? p.kv_heads : 0);
    const long long src =
        row_of(p.in_head_major, b, s, h, heads, p.seq) * p.dim + j;
    const long long dst =
        row_of(p.out_head_major, b, s, h, heads, p.seq) * p.dim + j;
    // selects, not an index into the parameters (that would copy them to
    // local memory)
    const void* in = t == 0 ? p.in[0] : t == 1 ? p.in[1] : p.in[2];
    void* out = t == 0 ? p.out[0] : t == 1 ? p.out[1] : p.out[2];
    float x1[kVec], x2[kVec];
    vector_io::load<kVec>(in, src, p.dtype, x1);
    vector_io::load<kVec>(in, src + half, p.dtype, x2);
    if (t < 2) {
      if constexpr (kBackward) {
        unrotate<kVec>(x1, x2, c, sn, p.dtype);
      } else {
        rotate<kVec>(x1, x2, c, sn);
      }
    }
    vector_io::store<kVec>(out, dst, p.dtype, x1);
    vector_io::store<kVec>(out, dst + half, p.dtype, x2);
  }
}

template <bool kBackward>
int launch(const Params& p, int vec, int splits, void* stream) {
  const int half = p.dim / 2;
  if (p.batch < 1 || p.seq < 1 || p.heads < 1 || p.kv_heads < 1
      || p.dim < 2 || p.dim % 2 != 0 || p.dtype < 0 || p.dtype > 1
      || p.in[0] == nullptr || p.in[1] == nullptr || p.out[0] == nullptr
      || p.out[1] == nullptr || (p.in[2] == nullptr) != (p.out[2] == nullptr)
      || p.freqs == nullptr || (vec != 1 && vec != 4 && vec != 8)
      || half % vec != 0 || splits < 1 || splits > 65535) {
    return cudaErrorInvalidValue;
  }
  for (int t = 0; t < 3; ++t) {
    if (!vector_io::aligned(p.in[t], vec, p.dtype)
        || !vector_io::aligned(p.out[t], vec, p.dtype)) {
      return cudaErrorInvalidValue;
    }
  }
  const long long threads =
      static_cast<long long>(p.batch) * p.seq * (half / vec);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    rope_kernel<kBackward, 8><<<grid, kThreads, 0, s>>>(p);
  } else if (vec == 4) {
    rope_kernel<kBackward, 4><<<grid, kThreads, 0, s>>>(p);
  } else {
    rope_kernel<kBackward, 1><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

Params params(const void* q, const void* k, const void* v, void* q_out,
              void* k_out, void* v_out, const void* freqs,
              const void* positions, int batch, int seq, int heads,
              int kv_heads, int dim, int dtype, bool in_head_major,
              bool out_head_major) {
  return Params{{q, k, v},
                {q_out, k_out, v_out},
                static_cast<const float*>(freqs),
                static_cast<const long long*>(positions),
                batch, seq, heads, kv_heads, dim, dtype, in_head_major,
                out_head_major};
}

}  // namespace

// q (B, S, heads, dim), k and v (B, S, kv_heads, dim; v may be null) of
// dtype (0 float32, 1 bfloat16), contiguous, into q_out, k_out and v_out
// of the same dtype, (B, S, *, dim) or, with head_major, (B, *, S, dim):
// q and k rotated by positions[s] * freqs[i] (freqs (dim / 2,) float32;
// positions (S,) int64, or null for s), v copied. vec: pairs a thread, 8
// or 4 (dim / 2 divisible by it, every buffer aligned to vec elements, at
// most 16 bytes) or 1; splits: the grid's head groups (gridDim.y).
extern "C" int rope_qk(const void* q, const void* k, const void* v,
                       void* q_out, void* k_out, void* v_out,
                       const void* freqs, const void* positions, int batch,
                       int seq, int heads, int kv_heads, int dim, int dtype,
                       int head_major, int vec, int splits, void* stream) {
  return launch<false>(params(q, k, v, q_out, k_out, v_out, freqs, positions,
                              batch, seq, heads, kv_heads, dim, dtype, false,
                              head_major != 0),
                       vec, splits, stream);
}

// The gradients dq, dk (and dv) of rope_qk's outputs, in the layout it
// wrote (head_major or not), into dq_out, dk_out (and dv_out) in its
// input layout: dq and dk rotated back with autograd's roundings, dv
// copied. The other arguments as rope_qk's.
extern "C" int rope_qk_bwd(const void* dq, const void* dk, const void* dv,
                           void* dq_out, void* dk_out, void* dv_out,
                           const void* freqs, const void* positions,
                           int batch, int seq, int heads, int kv_heads,
                           int dim, int dtype, int head_major, int vec,
                           int splits, void* stream) {
  return launch<true>(params(dq, dk, dv, dq_out, dk_out, dv_out, freqs,
                             positions, batch, seq, heads, kv_heads, dim,
                             dtype, head_major != 0, false),
                      vec, splits, stream);
}

// The text of a cudaError_t that rope_qk or rope_qk_bwd returned.
extern "C" const char* rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

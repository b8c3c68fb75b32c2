// The cached decode step's cache write, in two entries that share one
// kernel body:
//
// rope_kv_append: the whole of a layer's row work around the cache write
// in one launch. It rotates q and k (RoPE at positions start_pos + t), and
// writes the rotated k and v into the cache: quantized to int8 codes and a
// scale for an int8 cache, cast for a float cache. It returns the rotated
// q. Replaces tpu_operator_libs/examples/llama_decode.py::
// forward_with_cache :174 (the positions), :190-191 (_rope of q and k,
// tpu_operator_libs/examples/llama.py:117-136) and :193-214
// (_quantize_kv_block after RoPE, then dynamic_update_slice of the codes
// and scales at start_pos; or the cast and the same update). XLA fuses
// all of it on the TPU (it has no Pallas source).
//
// kv_append: the same write without the rotation (k and v as given), for
// callers that fill a cache with keys already rotated.
//
// Bound: bytes, and tiny: a decode step reads B x (H + 2 H_kv) rows of
// head_dim and writes as many. At the bench decode that is about 100 KB, a
// fraction of a microsecond at the memory rate; the launch and the chain
// of dependent steps within a row (load, rotate, max, divide, store) are
// the time. So the design does the layer's row work in one launch, one
// warp a (b, t, head) row of q, k or v (8 x 48 = 384 warps at the bench
// decode), with the fewest dependent steps a row:
//  - a lane owns the pairs (i, i + D/2), so the rotation needs no shuffle;
//    with kVec = 2 it loads two neighbouring pairs at once (8-byte or
//    4-byte loads), with kVec = 1 one element (the wrapper picks, the
//    entry checks);
//  - the angle is one float32 product of the position (converted from
//    int64) and the frequency, which comes from a device buffer computed
//    by _rope's own expression; cosf and sinf in registers;
//  - the rotation rounds each product and the sum or difference on its
//    own (__fmul_rn, __fsub_rn, __fadd_rn: no FMA contraction), as the
//    plain version's separate kernels do, then rounds to x's dtype;
//  - an int8 cache takes max|x| of the ROUNDED rotated row with a
//    butterfly (a max is exact in any order), then
//      s = max(max|x|, 1e-8) / 127,   q = clamp(rint(x / s), -127, 127)
//    with IEEE divisions (__fdiv_rn) and round-half-to-even (rintf), as
//    torch.round and jnp.round; the lanes recompute the row's rotation for
//    the codes rather than hold it across the reduction. A float cache
//    takes the round-to-nearest-even cast of the rounded value.
// Every step is a correctly rounded float32 operation or libdevice's
// cosf / sinf, which torch.cos and torch.sin also call, so the output
// equals the plain version's bit for bit. The position is read from the
// device (a captured step advances it in place); k and v rows whose
// position falls outside the cache are not written, rotated q is written
// for every row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block, one warp each

struct Params {
  const void* q;  // (B, T, heads, dim) of q_dtype; rope_kv_append only
  void* q_out;    // (B, T, heads, dim) of q_dtype, the rotated q
  const void* k;  // (B, T, kv_heads, dim) of k_dtype
  const void* v;  // (B, T, kv_heads, dim) of v_dtype
  void* k_cache;  // (B, S, kv_heads, dim) of cache_dtype
  void* v_cache;
  float* k_scale;  // (B, S, kv_heads), int8 cache only
  float* v_scale;
  const float* freqs;    // (dim / 2,) the rotation's frequencies
  const long long* pos;  // the position on the device, or null
  long long pos_value;   // the position when pos is null
  int batch, t_new, seq, heads, kv_heads, dim;
  int q_dtype, k_dtype, v_dtype, cache_dtype;  // 0 f32, 1 bf16, 2 int8
};

__device__ __forceinline__ float load_f32(const void* p, long long i,
                                          int dtype) {
  return dtype == 0
             ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// kVec neighbouring elements from i (aligned to kVec elements)
template <int kVec>
__device__ __forceinline__ void load_vec(const void* p, long long i,
                                         int dtype, float (&x)[kVec]) {
  if constexpr (kVec == 2) {
    if (dtype == 0) {
      const float2 f =
          *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
      x[0] = f.x;
      x[1] = f.y;
    } else {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(
          static_cast<const __nv_bfloat16*>(p) + i);
      x[0] = __low2float(h);
      x[1] = __high2float(h);
    }
  } else {
    x[0] = load_f32(p, i, dtype);
  }
}

// kVec values to a float32 (0) or bfloat16 (1) buffer, rounded to nearest
// even
template <int kVec>
__device__ __forceinline__ void store_vec(void* p, long long i, int dtype,
                                          const float (&x)[kVec]) {
  if constexpr (kVec == 2) {
    if (dtype == 0) {
      *reinterpret_cast<float2*>(static_cast<float*>(p) + i) =
          make_float2(x[0], x[1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) +
                                         i) = __floats2bfloat162_rn(x[0], x[1]);
    }
  } else if (dtype == 0) {
    static_cast<float*>(p)[i] = x[0];
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x[0]);
  }
}

// x rounded to dtype's precision (bfloat16 round-to-nearest-even), as
// float32
__device__ __forceinline__ float round_to(float x, int dtype) {
  return dtype == 0 ? x : __bfloat162float(__float2bfloat16_rn(x));
}

// The pairs (x1[e], x2[e]) at head-dim indices (j + e, j + e + dim / 2)
// rotated by the angles pos * freqs[j + e] and rounded to dtype:
//   (x1 cos - x2 sin, x1 sin + x2 cos)
// each product and the sum or difference rounded on its own, as _rope's
// separate kernels compute them.
template <int kVec>
__device__ __forceinline__ void rotate(float (&x1)[kVec], float (&x2)[kVec],
                                       float pos, const float* freqs, int j,
                                       int dtype) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float angle = __fmul_rn(pos, freqs[j + e]);
    const float c = cosf(angle);
    const float s = sinf(angle);
    const float y1 = __fsub_rn(__fmul_rn(x1[e], c), __fmul_rn(x2[e], s));
    const float y2 = __fadd_rn(__fmul_rn(x1[e], s), __fmul_rn(x2[e], c));
    x1[e] = round_to(y1, dtype);
    x2[e] = round_to(y2, dtype);
  }
}

// One warp's row: with kRotate the rows are the B x T x heads rows of q,
// then those of k, then those of v (B x T x kv_heads each); without it
// those of k and v alone.
template <bool kRotate, int kVec>
__device__ __forceinline__ void append_row(const Params& p) {
  const int lane = threadIdx.x & 31;
  // 32-bit row arithmetic: the entry checks that every row index fits
  const int q_rows = kRotate ? p.batch * p.t_new * p.heads : 0;
  const int kv_rows = p.batch * p.t_new * p.kv_heads;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= q_rows + 2 * kv_rows) return;
  const int half = p.dim / 2;
  const long long start = p.pos != nullptr ? *p.pos : p.pos_value;
  if (kRotate && row < q_rows) {
    const int t = (row / p.heads) % p.t_new;
    const float pos = static_cast<float>(start + t);
    const long long off = static_cast<long long>(row) * p.dim;
    for (int j = lane * kVec; j < half; j += 32 * kVec) {
      float x1[kVec], x2[kVec];
      load_vec<kVec>(p.q, off + j, p.q_dtype, x1);
      load_vec<kVec>(p.q, off + half + j, p.q_dtype, x2);
      rotate<kVec>(x1, x2, pos, p.freqs, j, p.q_dtype);
      store_vec<kVec>(p.q_out, off + j, p.q_dtype, x1);
      store_vec<kVec>(p.q_out, off + half + j, p.q_dtype, x2);
    }
    return;
  }
  row -= q_rows;
  const bool is_v = row >= kv_rows;
  if (is_v) row -= kv_rows;
  const int kvh = row % p.kv_heads;
  const int bt = row / p.kv_heads;
  const int t = bt % p.t_new;
  const int b = bt / p.t_new;
  const long long at = start + t;
  if (at < 0 || at >= p.seq) return;
  const bool rotated = kRotate && !is_v;
  const float pos = static_cast<float>(at);
  const void* src = is_v ? p.v : p.k;
  const int src_dtype = is_v ? p.v_dtype : p.k_dtype;
  const long long src_off = static_cast<long long>(row) * p.dim;
  const long long dst_row =
      (static_cast<long long>(b) * p.seq + at) * p.kv_heads + kvh;
  const long long dst_off = dst_row * p.dim;
  void* cache = is_v ? p.v_cache : p.k_cache;
  // the row's pair (j, j + half) as the cache takes it: rotated k rounded
  // to k's dtype, or v and unrotated k as given
  auto pair = [&](int j, float (&x1)[kVec], float (&x2)[kVec]) {
    load_vec<kVec>(src, src_off + j, src_dtype, x1);
    load_vec<kVec>(src, src_off + half + j, src_dtype, x2);
    if (rotated) rotate<kVec>(x1, x2, pos, p.freqs, j, src_dtype);
  };
  if (p.cache_dtype == 2) {
    float amax = 0.f;
    for (int j = lane * kVec; j < half; j += 32 * kVec) {
      float x1[kVec], x2[kVec];
      pair(j, x1, x2);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        amax = fmaxf(amax, fmaxf(fabsf(x1[e]), fabsf(x2[e])));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    int8_t* dst = static_cast<int8_t*>(cache) + dst_off;
    for (int j = lane * kVec; j < half; j += 32 * kVec) {
      float x1[kVec], x2[kVec];
      pair(j, x1, x2);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float c1 =
            fminf(fmaxf(rintf(__fdiv_rn(x1[e], s)), -127.f), 127.f);
        const float c2 =
            fminf(fmaxf(rintf(__fdiv_rn(x2[e], s)), -127.f), 127.f);
        dst[j + e] = static_cast<int8_t>(c1);
        dst[half + j + e] = static_cast<int8_t>(c2);
      }
    }
    if (lane == 0) (is_v ? p.v_scale : p.k_scale)[dst_row] = s;
  } else {
    for (int j = lane * kVec; j < half; j += 32 * kVec) {
      float x1[kVec], x2[kVec];
      pair(j, x1, x2);
      store_vec<kVec>(cache, dst_off + j, p.cache_dtype, x1);
      store_vec<kVec>(cache, dst_off + half + j, p.cache_dtype, x2);
    }
  }
}

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    kv_append_kernel(const Params p) {
  append_row<false, kVec>(p);
}

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    rope_kv_append_kernel(const Params p) {
  append_row<true, kVec>(p);
}

bool aligned8(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 8 == 0;
}

template <bool kRotate>
int launch(const Params& p, int vec, void* stream) {
  if (p.batch < 1 || p.t_new < 1 || p.seq < 1 || p.kv_heads < 1
      || p.dim < 2 || p.dim % 2 != 0
      || p.k_dtype < 0 || p.k_dtype > 1 || p.v_dtype < 0 || p.v_dtype > 1
      || p.cache_dtype < 0 || p.cache_dtype > 2
      || (p.cache_dtype == 2) != (p.k_scale != nullptr
                                  && p.v_scale != nullptr)
      || (kRotate && (p.heads < 1 || p.heads % p.kv_heads != 0
                      || p.q_dtype < 0 || p.q_dtype > 1
                      || p.freqs == nullptr))
      || (vec != 1 && vec != 2)) {
    return cudaErrorInvalidValue;
  }
  // two pairs a lane need an even half and 8-byte aligned rows
  if (vec == 2 && ((p.dim / 2) % 2 != 0 || !aligned8(p.q)
                   || !aligned8(p.q_out) || !aligned8(p.k) || !aligned8(p.v)
                   || !aligned8(p.k_cache) || !aligned8(p.v_cache))) {
    return cudaErrorInvalidValue;
  }
  const long long rows = static_cast<long long>(p.batch) * p.t_new
                         * ((kRotate ? p.heads : 0) + 2LL * p.kv_heads);
  if (rows + kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kRotate) {
    if (vec == 2) {
      rope_kv_append_kernel<2><<<blocks, kWarps * 32, 0, s>>>(p);
    } else {
      rope_kv_append_kernel<1><<<blocks, kWarps * 32, 0, s>>>(p);
    }
  } else if (vec == 2) {
    kv_append_kernel<2><<<blocks, kWarps * 32, 0, s>>>(p);
  } else {
    kv_append_kernel<1><<<blocks, kWarps * 32, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// k, v (B, T, kv_heads, dim) of k_dtype, v_dtype (0 float32, 1 bfloat16);
// k_cache, v_cache (B, S, kv_heads, dim) of cache_dtype (0, 1, or 2 int8
// with k_scale, v_scale (B, S, kv_heads) float32); all contiguous. Rows
// are written at positions *pos + t (int64 on the device) or, when pos is
// null, pos_value + t. vec: 2 pairs a lane (dim % 4 == 0, every buffer
// 8-byte aligned) or 1.
extern "C" int kv_append(const void* k, const void* v, void* k_cache,
                         void* v_cache, void* k_scale, void* v_scale,
                         const void* pos, long long pos_value, int batch,
                         int t_new, int seq, int kv_heads, int dim,
                         int k_dtype, int v_dtype, int cache_dtype, int vec,
                         void* stream) {
  const Params p{nullptr, nullptr, k, v, k_cache, v_cache,
                 static_cast<float*>(k_scale), static_cast<float*>(v_scale),
                 nullptr, static_cast<const long long*>(pos), pos_value,
                 batch, t_new, seq, 0, kv_heads, dim, 0, k_dtype, v_dtype,
                 cache_dtype};
  return launch<false>(p, vec, stream);
}

// As kv_append, after rotating k (and q, (B, T, heads, dim) of q_dtype,
// heads a multiple of kv_heads, into q_out of the same shape and dtype)
// by the angles (start + t) * freqs[i], freqs (dim / 2,) float32.
extern "C" int rope_kv_append(const void* q, void* q_out, const void* freqs,
                              int heads, int q_dtype, const void* k,
                              const void* v, void* k_cache, void* v_cache,
                              void* k_scale, void* v_scale, const void* pos,
                              long long pos_value, int batch, int t_new,
                              int seq, int kv_heads, int dim, int k_dtype,
                              int v_dtype, int cache_dtype, int vec,
                              void* stream) {
  if (q == nullptr || q_out == nullptr) return cudaErrorInvalidValue;
  const Params p{q, q_out, k, v, k_cache, v_cache,
                 static_cast<float*>(k_scale), static_cast<float*>(v_scale),
                 static_cast<const float*>(freqs),
                 static_cast<const long long*>(pos), pos_value, batch, t_new,
                 seq, heads, kv_heads, dim, q_dtype, k_dtype, v_dtype,
                 cache_dtype};
  return launch<true>(p, vec, stream);
}

// The text of a cudaError_t that kv_append or rope_kv_append returned.
extern "C" const char* kv_append_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

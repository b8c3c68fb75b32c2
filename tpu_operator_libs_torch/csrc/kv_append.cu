// The cached decode step's cache write: one block of new keys and values,
// quantized to int8 codes and a scale for an int8 cache or cast for a float
// cache, written at the step's position, K and V in one launch.
//
// Replaces tpu_operator_libs/examples/llama_decode.py::forward_with_cache
// :192-214, which XLA fuses on the TPU (it has no Pallas source):
// _quantize_kv_block after RoPE (_sym_int8 over head_dim, :74-97), then
// dynamic_update_slice of the codes and scales at start_pos; or the cast to
// the cache's dtype and the same update.
//
// Bound: bytes, and tiny: a decode step writes B x n_kv rows of head_dim
// for K and for V. One warp a (b, t, kv head) row of K or of V: the lanes
// read the row (neighbouring lanes on neighbouring elements), take max|x|
// with a butterfly (a max is exact in any order), and write the codes and,
// from lane 0, the scale:
//   s = max(max|x|, 1e-8) / 127,   q = clamp(rint(x / s), -127, 127)
// with IEEE divisions (__fdiv_rn) and round-half-to-even (rintf), as
// torch.round and jnp.round: every operation is exact float32 arithmetic,
// so the codes and scales equal the plain version's bit for bit. A float
// cache takes the round-to-nearest-even cast. The position is read from the
// device (a captured step advances it in place); rows whose position falls
// outside the cache are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block, one warp each

__device__ __forceinline__ float load_f32(const void* p, long long i,
                                          int dtype) {
  return dtype == 0
             ? static_cast<const float*>(p)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

struct Params {
  const void* k;  // (B, T, kv_heads, dim) of k_dtype
  const void* v;  // (B, T, kv_heads, dim) of v_dtype
  void* k_cache;  // (B, S, kv_heads, dim) of cache_dtype
  void* v_cache;
  float* k_scale;  // (B, S, kv_heads), int8 cache only
  float* v_scale;
  const long long* pos;  // the position on the device, or null
  long long pos_value;   // the position when pos is null
  int batch, t_new, seq, kv_heads, dim;
  int k_dtype, v_dtype, cache_dtype;  // 0 float32, 1 bfloat16, 2 int8
};

__global__ void __launch_bounds__(kWarps * 32)
    kv_append_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  // 32-bit row arithmetic: the entry checks that 2 x rows fits
  const int rows = p.batch * p.t_new * p.kv_heads;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= 2 * rows) return;
  const bool is_v = row >= rows;
  if (is_v) row -= rows;
  const int kvh = row % p.kv_heads;
  const int bt = row / p.kv_heads;
  const int t = bt % p.t_new;
  const int b = bt / p.t_new;
  const long long pos = (p.pos != nullptr ? *p.pos : p.pos_value) + t;
  if (pos < 0 || pos >= p.seq) return;
  const void* src = is_v ? p.v : p.k;
  const int src_dtype = is_v ? p.v_dtype : p.k_dtype;
  const long long src_off = static_cast<long long>(row) * p.dim;
  const long long dst_row =
      (static_cast<long long>(b) * p.seq + pos) * p.kv_heads + kvh;
  const long long dst_off = dst_row * p.dim;
  void* cache = is_v ? p.v_cache : p.k_cache;
  if (p.cache_dtype == 2) {
    float amax = 0.f;
    for (int d = lane; d < p.dim; d += 32) {
      amax = fmaxf(amax, fabsf(load_f32(src, src_off + d, src_dtype)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    int8_t* dst = static_cast<int8_t*>(cache) + dst_off;
    for (int d = lane; d < p.dim; d += 32) {
      const float x = load_f32(src, src_off + d, src_dtype);
      const float code = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
      dst[d] = static_cast<int8_t>(code);
    }
    if (lane == 0) (is_v ? p.v_scale : p.k_scale)[dst_row] = s;
  } else if (p.cache_dtype == 0) {
    float* dst = static_cast<float*>(cache) + dst_off;
    for (int d = lane; d < p.dim; d += 32) {
      dst[d] = load_f32(src, src_off + d, src_dtype);
    }
  } else {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(cache) + dst_off;
    for (int d = lane; d < p.dim; d += 32) {
      dst[d] = __float2bfloat16_rn(load_f32(src, src_off + d, src_dtype));
    }
  }
}

}  // namespace

// k, v (B, T, kv_heads, dim) of k_dtype, v_dtype (0 float32, 1 bfloat16);
// k_cache, v_cache (B, S, kv_heads, dim) of cache_dtype (0, 1, or 2 int8
// with k_scale, v_scale (B, S, kv_heads) float32); all contiguous. Rows
// are written at positions *pos + t (int64 on the device) or, when pos is
// null, pos_value + t.
extern "C" int kv_append(const void* k, const void* v, void* k_cache,
                         void* v_cache, void* k_scale, void* v_scale,
                         const void* pos, long long pos_value, int batch,
                         int t_new, int seq, int kv_heads, int dim,
                         int k_dtype, int v_dtype, int cache_dtype,
                         void* stream) {
  if (batch < 1 || t_new < 1 || seq < 1 || kv_heads < 1 || dim < 1
      || k_dtype < 0 || k_dtype > 1 || v_dtype < 0 || v_dtype > 1
      || cache_dtype < 0 || cache_dtype > 2
      || (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long rows = 2LL * batch * t_new * kv_heads;
  if (rows + kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const Params p{k,
                 v,
                 k_cache,
                 v_cache,
                 static_cast<float*>(k_scale),
                 static_cast<float*>(v_scale),
                 static_cast<const long long*>(pos),
                 pos_value,
                 batch,
                 t_new,
                 seq,
                 kv_heads,
                 dim,
                 k_dtype,
                 v_dtype,
                 cache_dtype};
  kv_append_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The text of a cudaError_t that kv_append returned.
extern "C" const char* kv_append_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The cached decode step's attention: the new queries of one step (or a
// prefill block) against one layer's whole KV cache, float or int8 with
// per-(token, kv-head) scales, under the mask of the step's position.
//
// Replaces the attention of
// tpu_operator_libs/examples/llama_decode.py::forward_with_cache (:216-246,
// the mask of :181-182), which XLA fuses on the TPU (it has no Pallas
// source): a grouped einsum of the queries over (kv-head, group) against
// the max_seq cache, scaled by head_dim^-0.5; float32 scores, keys past
// each query's position masked, a softmax; the value einsum. For an int8
// cache the K scale rescales the scores after the code contraction and the
// V scale the weights before the value contraction.
//
// Bound: bytes. At decode each query row meets every key once, 4 FLOPs a
// key element against 2 bytes (bf16) or 1 byte (int8) read: far below the
// card's 295 FLOPs a byte. So the kernel reads the cache once, in place, in
// its (B, S, n_kv, head_dim) layout: no permuted and no widened copy.
//
// Design: one block of 128 threads for each (batch row, kv head, tile of up
// to 16 query rows), a row being one (t, g) pair of the kv head's group, so
// a kv head's keys serve all of its group's heads at once. The block walks
// the whole cache in key tiles; tile i + 1's keys, values and scales are
// copied into shared memory by 16-byte cp.async (element loads where a
// row's bytes are not a multiple of 16) while tile i is computed:
//   A. each thread takes (row, key) pairs: the f32 dot product over
//      head_dim, times the scale (and the key's K scale);
//   B. one warp a row: the online softmax in f32. Key s is visible to the
//      row of query t when s <= start_pos + t (start_pos read from the
//      device); the others get weight 0, as exp(-1e30 - max) is 0 in the
//      reference. The running max and sum are rescaled once a tile; the
//      weights are multiplied by the key's V scale for an int8 cache;
//   C. each thread takes (row, 16-byte column chunk) outputs and, where
//      they are fewer than the threads, a share of the tile's keys, whose
//      partial sums are added in key-share order.
// The sums are divided by the row's softmax sum once and rounded once to
// the output's dtype. No atomics: every sum runs in a fixed order, so two
// launches, or a replayed graph, give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;   // query rows a block
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes of cache elements as floats.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[4 * i] = static_cast<float>(c[i].x);
      f[4 * i + 1] = static_cast<float>(c[i].y);
      f[4 * i + 2] = static_cast<float>(c[i].z);
      f[4 * i + 3] = static_cast<float>(c[i].w);
    }
  }
};

// Values c * kN .. c * kN + kN - 1 of a staged row: one 16-byte chunk, or
// (element loads) the single element c.
template <typename T, bool kVec>
__device__ __forceinline__ void load_values(const unsigned char* row, int c,
                                            float* f) {
  if constexpr (kVec) {
    Chunk<T>::load(row + 16 * c, f);
  } else {
    f[0] = to_f32(reinterpret_cast<const T*>(row)[c]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;           // (B, T, heads, dim), f32 or bf16
  const void* k;           // (B, S, kv_heads, dim) cache
  const void* v;
  const float* k_scale;    // (B, S, kv_heads), int8 cache only
  const float* v_scale;
  void* out;               // (B, T, heads, dim), f32 or bf16
  const long long* pos;    // the step's position on the device, or null
  long long pos_value;     // the position when pos is null
  int batch, t_new, heads, kv_heads, seq, dim;
  int q_dtype, out_dtype;  // 0 float32, 1 bfloat16
  int key_tile;            // keys a tile
  int row_stride;          // bytes between two keys' staged rows
  float scale;             // head_dim^-0.5
};

// The shared-memory layout, in bytes (kernels/decode_attention.py::
// smem_bytes computes the same).
__host__ __device__ inline long long smem_bytes(int dim, int key_tile,
                                                int row_stride) {
  return 2LL * kMaxRows * dim * 4 + kMaxRows * key_tile * 4
         + kThreads * 16 * 4 + 3 * kMaxRows * 4 + 2 * 2 * key_tile * 4
         + 2LL * 2 * key_tile * row_stride;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kN = kVec ? Chunk<T>::kN : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = p.dim;
  const int kt = p.key_tile;
  const int group = p.heads / p.kv_heads;
  const int row0 = blockIdx.x * kMaxRows;
  const int rows = min(kMaxRows, p.t_new * group - row0);
  const int chunks = dim / kN;  // chunks of a key's row
  const long long pos = p.pos != nullptr ? *p.pos : p.pos_value;
  const bool quant = p.k_scale != nullptr;

  float* q_s = reinterpret_cast<float*>(smem);     // rows x dim
  float* acc_s = q_s + kMaxRows * dim;             // rows x dim
  float* sc_s = acc_s + kMaxRows * dim;            // rows x key_tile
  float* part_s = sc_s + kMaxRows * kt;            // kThreads x 16
  float* m_s = part_s + kThreads * 16;             // running max
  float* l_s = m_s + kMaxRows;                     // running sum
  float* corr_s = l_s + kMaxRows;                  // this tile's rescale
  float* ksc_s = corr_s + kMaxRows;                // 2 stages x key_tile
  float* vsc_s = ksc_s + 2 * kt;
  unsigned char* k_t = reinterpret_cast<unsigned char*>(vsc_s + 2 * kt);
  unsigned char* v_t = k_t + 2 * kt * p.row_stride;

  // the block's query rows in f32; row r is (t, g) = divmod(row0 + r, group)
  for (int i = tid; i < rows * dim; i += kThreads) {
    const int r = i / dim;
    const int qi = row0 + r;
    const long long off =
        ((static_cast<long long>(b) * p.t_new + qi / group) * p.heads
         + kvh * group + qi % group) * dim + i % dim;
    q_s[i] = p.q_dtype == 0
                 ? static_cast<const float*>(p.q)[off]
                 : __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[off]);
    acc_s[i] = 0.f;
  }
  if (tid < kMaxRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // cache elements between two positions, and this (b, kv head)'s first
  const long long pos_elems = static_cast<long long>(p.kv_heads) * dim;
  const long long base =
      (static_cast<long long>(b) * p.seq * p.kv_heads + kvh) * dim;
  const T* k_g = static_cast<const T*>(p.k) + base;
  const T* v_g = static_cast<const T*>(p.v) + base;
  const long long sbase = static_cast<long long>(b) * p.seq * p.kv_heads + kvh;

  auto load_tile = [&](int tile, int stage) {
    const int s0 = tile * kt;
    const int n = min(kt, p.seq - s0);
    unsigned char* kd = k_t + stage * kt * p.row_stride;
    unsigned char* vd = v_t + stage * kt * p.row_stride;
    if constexpr (kVec) {
      for (int i = tid; i < n * chunks; i += kThreads) {
        const int j = i / chunks;
        const int c = i % chunks;
        const long long g = (s0 + j) * pos_elems + c * kN;
        cp_async16(kd + j * p.row_stride + 16 * c, k_g + g);
        cp_async16(vd + j * p.row_stride + 16 * c, v_g + g);
      }
    } else {
      for (int i = tid; i < n * dim; i += kThreads) {
        const int j = i / dim;
        const int d = i % dim;
        const long long g = (s0 + j) * pos_elems + d;
        reinterpret_cast<T*>(kd + j * p.row_stride)[d] = k_g[g];
        reinterpret_cast<T*>(vd + j * p.row_stride)[d] = v_g[g];
      }
    }
    if (quant) {
      for (int j = tid; j < n; j += kThreads) {
        const long long g = sbase + (s0 + j) * static_cast<long long>(p.kv_heads);
        cp_async4(ksc_s + stage * kt + j, p.k_scale + g);
        cp_async4(vsc_s + stage * kt + j, p.v_scale + g);
      }
    }
    cp_async_commit();
  };

  const int tiles = (p.seq + kt - 1) / kt;
  load_tile(0, 0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < tiles) {
      load_tile(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s0 = tile * kt;
    const int n = min(kt, p.seq - s0);
    const unsigned char* kst = k_t + stage * kt * p.row_stride;
    const unsigned char* vst = v_t + stage * kt * p.row_stride;
    const float* ksc = ksc_s + stage * kt;
    const float* vsc = vsc_s + stage * kt;

    // A. scores of (row, key) pairs; neighbouring threads take
    // neighbouring keys of one row
    for (int i = tid; i < rows * n; i += kThreads) {
      const int r = i / n;
      const int j = i % n;
      const float* qr = q_s + r * dim;
      const unsigned char* kr = kst + j * p.row_stride;
      float dot = 0.f;
      for (int c = 0; c < chunks; ++c) {
        float f[kN];
        load_values<T, kVec>(kr, c, f);
#pragma unroll
        for (int e = 0; e < kN; ++e) dot = fmaf(qr[c * kN + e], f[e], dot);
      }
      float s = dot * p.scale;
      if (quant) s *= ksc[j];
      sc_s[r * kt + j] = s;
    }
    __syncthreads();

    // B. the online softmax, one warp a row
    for (int r = warp; r < rows; r += kWarps) {
      const long long last = pos + (row0 + r) / group;  // last visible key
      const float m_old = m_s[r];
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        if (s0 + j <= last) mx = fmaxf(mx, sc_s[r * kt + j]);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        float w = 0.f;
        if (s0 + j <= last && m_new != -INFINITY) {
          w = expf(sc_s[r * kt + j] - m_new);
        }
        sum += w;
        // the V scale folds into the weight, not into the softmax's sum
        sc_s[r * kt + j] = quant ? w * vsc[j] : w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // C. acc = acc * corr + weights x values
    const int outs = rows * chunks;  // (row, chunk) outputs
    const int splits = max(1, min(n, kThreads / outs));
    if (splits == 1) {
      for (int o = tid; o < outs; o += kThreads) {
        const int r = o / chunks;
        const int c = o % chunks;
        float a[kN];
#pragma unroll
        for (int e = 0; e < kN; ++e) a[e] = 0.f;
        for (int j = 0; j < n; ++j) {
          const float w = sc_s[r * kt + j];
          float f[kN];
          load_values<T, kVec>(vst + j * p.row_stride, c, f);
#pragma unroll
          for (int e = 0; e < kN; ++e) a[e] = fmaf(w, f[e], a[e]);
        }
        const float corr = corr_s[r];
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          acc_s[o * kN + e] = fmaf(acc_s[o * kN + e], corr, a[e]);
        }
      }
    } else {
      if (tid < outs * splits) {
        const int o = tid % outs;
        const int share = tid / outs;
        const int r = o / chunks;
        const int c = o % chunks;
        float a[kN];
#pragma unroll
        for (int e = 0; e < kN; ++e) a[e] = 0.f;
        for (int j = share; j < n; j += splits) {
          const float w = sc_s[r * kt + j];
          float f[kN];
          load_values<T, kVec>(vst + j * p.row_stride, c, f);
#pragma unroll
          for (int e = 0; e < kN; ++e) a[e] = fmaf(w, f[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < kN; ++e) part_s[(share * outs + o) * kN + e] = a[e];
      }
      __syncthreads();
      for (int i = tid; i < outs * kN; i += kThreads) {
        float total = 0.f;
        for (int share = 0; share < splits; ++share) {
          total += part_s[share * outs * kN + i];
        }
        acc_s[i] = fmaf(acc_s[i], corr_s[i / kN / chunks], total);
      }
    }
    __syncthreads();
  }

  // divide by the softmax's sum once, round once
  for (int i = tid; i < rows * dim; i += kThreads) {
    const int r = i / dim;
    const int qi = row0 + r;
    const long long off =
        ((static_cast<long long>(b) * p.t_new + qi / group) * p.heads
         + kvh * group + qi % group) * dim + i % dim;
    const float o = __fdiv_rn(acc_s[i], l_s[r]);
    if (p.out_dtype == 0) {
      static_cast<float*>(p.out)[off] = o;
    } else {
      static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(o);
    }
  }
}

template <typename T, bool kVec>
int launch(const Params& p, cudaStream_t stream) {
  const long long smem = smem_bytes(p.dim, p.key_tile, p.row_stride);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int group = p.heads / p.kv_heads;
  const dim3 grid((p.t_new * group + kMaxRows - 1) / kMaxRows, p.kv_heads,
                  p.batch);
  decode_attention_kernel<T, kVec>
      <<<grid, kThreads, static_cast<size_t>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_loads(const Params& p, bool vec, cudaStream_t stream) {
  return vec ? launch<T, true>(p, stream) : launch<T, false>(p, stream);
}

}  // namespace

// q (B, T, heads, dim) of q_dtype (0 float32, 1 bfloat16); k, v (B, S,
// kv_heads, dim) of cache_dtype (0 float32, 1 bfloat16, 2 int8) with, for
// int8, k_scale and v_scale (B, S, kv_heads) float32; out (B, T, heads,
// dim) of out_dtype (0, 1); all contiguous. The position is *pos (int64 on
// the device) or, when pos is null, pos_value. The launch
// (kernels/decode_attention.py::plan): vec (16-byte loads: rows of a
// multiple of 16 bytes, k and v 16-byte aligned), key_tile keys a tile (8
// to 64, even) and row_stride bytes between staged rows (a multiple of 16
// holding a row), within the card's shared memory.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                void* out, const void* pos,
                                long long pos_value, int batch, int t_new,
                                int heads, int kv_heads, int seq, int dim,
                                int q_dtype, int cache_dtype, int out_dtype,
                                int vec, int key_tile, int row_stride,
                                float scale, void* stream) {
  if (batch < 1 || t_new < 1 || heads < 1 || kv_heads < 1 || seq < 1
      || dim < 2 || dim % 2 || heads % kv_heads || batch > 65535
      || kv_heads > 65535 || q_dtype < 0 || q_dtype > 1 || out_dtype < 0
      || out_dtype > 1 || cache_dtype < 0 || cache_dtype > 2
      || key_tile < 8 || key_tile > 64 || key_tile % 2
      || row_stride % 16) {
    return cudaErrorInvalidValue;
  }
  const int esize = cache_dtype == 0 ? 4 : cache_dtype == 1 ? 2 : 1;
  const int row_bytes = dim * esize;
  if (row_stride < row_bytes
      || smem_bytes(dim, key_tile, row_stride) > kMaxSmem
      || (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)
      || (vec && (row_bytes % 16 != 0
                  || reinterpret_cast<uintptr_t>(k) % 16 != 0
                  || reinterpret_cast<uintptr_t>(v) % 16 != 0))) {
    return cudaErrorInvalidValue;
  }
  Params p{q,
           k,
           v,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           out,
           static_cast<const long long*>(pos),
           pos_value,
           batch,
           t_new,
           heads,
           kv_heads,
           seq,
           dim,
           q_dtype,
           out_dtype,
           key_tile,
           row_stride,
           scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_dtype == 0) return launch_loads<float>(p, vec != 0, st);
  if (cache_dtype == 1) return launch_loads<__nv_bfloat16>(p, vec != 0, st);
  return launch_loads<int8_t>(p, vec != 0, st);
}

// The text of a cudaError_t that decode_attention returned.
extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

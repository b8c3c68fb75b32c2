// Causal flash-attention forward for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes (tpu_operator_libs_torch/kernels/_build.py).
//
// Replaces: the Pallas TPU forward kernel that
// tpu_operator_libs/examples/llama.py::forward reaches with
// attention_impl="flash": jax/experimental/pallas/ops/tpu/flash_attention.py
// ::_flash_attention_impl (pl.pallas_call, kernel _flash_attention_kernel).
// Same function: O = softmax(mask(Q K^T * sm_scale)) V with query i seeing
// keys <= i, f32 running max, sum and accumulator, plus the per-row
// log-sum-exp in f32 that the backward kernels and a ring fold read.
//
// Bound on an H100 SXM: 2*B*H*S^2*D FLOPs for the causal half (QK^T and PV)
// at 989 TFLOP/s for bf16 inputs (67 TFLOP/s f32), against Q, K, V and O
// read or written once at 3.35 TB/s. At the model's shapes (S >= 1024,
// D = 128) the FLOPs bound it by a wide margin.
//
// Design, simple first: one block of 256 threads per (64-query tile, head,
// batch); four threads share a query row, each holding a quarter of its
// head_dim in registers as float4 chunks interleaved so that the four read
// neighbouring shared-memory words. K/V tiles of 64 keys are staged in
// dynamic shared memory as f32 (2 * 64 * D * 4 bytes, 64 KB at D = 128, so
// the limit is raised with cudaFuncSetAttribute). The key loop stops at the
// diagonal, so fully-masked tiles are never loaded, and the longest query
// tiles are scheduled first. GQA is read natively: kv head = h / (H / Hkv).
// What it leaves on the table: the products run as scalar f32 FMAs, not on
// the tensor cores (mma.sync / wgmma would be ~15x the rate for bf16), tiles
// are loaded synchronously rather than by TMA or cp.async into a ring of
// stages, and at D = 128 each thread holds 232 registers (ptxas), so one
// 256-thread block fills an SM and no second block hides its latency.
#include <math.h>

#include "flash_attention_common.cuh"

namespace {

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); lse: (B, H, Sq) f32.
// scale_log2 = sm_scale * log2(e): scores are kept in base-2 units so the
// exponentials are exp2f.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 int causal, float scale_log2) {
  constexpr int kVecs = D / 4;                  // float4 per row
  constexpr int kChunks = kVecs / kRowThreads;  // float4 per thread
  extern __shared__ float4 smem[];
  float4* k_tile = smem;                        // [kBlockN][kVecs]
  float4* v_tile = smem + kBlockN * kVecs;      // [kBlockN][kVecs]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  const int qi = tile * kBlockM + row;
  const bool row_valid = qi < Sq;

  const size_t q_base = (static_cast<size_t>(b) * H + h) * Sq;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk;

  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kRowThreads * i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_valid) x = load4(q + (q_base + qi) * D + 4 * c);
    qr[i] = make_float4(x.x * scale_log2, x.y * scale_log2,
                        x.z * scale_log2, x.w * scale_log2);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float l = 0.f;

  // Keys past the tile's last query row are masked for every row of it.
  const int kv_end = causal ? min(Sk, (tile + 1) * kBlockM) : Sk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kBlockN * kVecs; e += kThreads) {
      const int r = e / kVecs;
      const int c = e % kVecs;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Sk) {
        const size_t off = (kv_base + k0 + r) * D + 4 * c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      k_tile[e] = kx;
      v_tile[e] = vx;
    }
    __syncthreads();

    float s[kBlockN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kx = k_tile[j * kVecs + sub + kRowThreads * i];
        part = fmaf(qr[i].x, kx.x, part);
        part = fmaf(qr[i].y, kx.y, part);
        part = fmaf(qr[i].z, kx.z, part);
        part = fmaf(qr[i].w, kx.w, part);
      }
      // the four threads of a row end with the same sum (xor butterfly)
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool visible = kj < Sk && (!causal || kj <= qi);
      s[j] = visible ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // Key 0 is visible to every row, so m is finite after the first tile
    // and alpha = exp2(-inf) = 0 there.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      s[j] = exp2f(s[j] - m_new);
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vx = v_tile[j * kVecs + sub + kRowThreads * i];
        acc[i].x = fmaf(s[j], vx.x, acc[i].x);
        acc[i].y = fmaf(s[j], vx.y, acc[i].y);
        acc[i].z = fmaf(s[j], vx.z, acc[i].z);
        acc[i].w = fmaf(s[j], vx.w, acc[i].w);
      }
    }
  }

  if (!row_valid) return;
  const float inv_l = 1.f / l;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kRowThreads * i;
    store4(o + (q_base + qi) * D + 4 * c,
           make_float4(acc[i].x * inv_l, acc[i].y * inv_l,
                       acc[i].z * inv_l, acc[i].w * inv_l));
  }
  if (sub == 0) lse[q_base + qi] = (m + log2f(l)) * kLn2;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk,
                   int causal, float sm_scale, cudaStream_t stream) {
  const int smem = 2 * kBlockN * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, Sq, Sk,
      causal, sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int Hkv, int Sq, int Sk, int D,
                                   int dtype, int causal, float sm_scale,
                                   void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch<T, decltype(dim)::value>(q, k, v, o, lse_f, B, H, Hkv, Sq,
                                           Sk, causal, sm_scale, s);
  });
  return static_cast<int>(err);
}

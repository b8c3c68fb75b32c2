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
// read or written once at 3.35 TB/s. For bf16 at S = 1024, D = 128 the two
// are within 20% of each other and the bytes are the larger (0.0101 against
// 0.0087 ms at (2, 16, 1024, 128)); the FLOPs bound it from S ~ 1200 up
// and at every f32 shape.
//
// Two designs, chosen by (dtype, head_dim) at compile time
// (sm90::kTakesWgmma):
// - bf16 at D = 64 and 128, flash_fwd_wgmma_kernel: one block of 288
//   threads per (128-query tile, head, batch): two consumer warpgroups of
//   64 query rows and a producer warp. The producer loads the Q tile once
//   and the K/V tiles of 64 keys into a two-stage ring by TMA (128-byte
//   swizzle, full/empty mbarriers, flash_attention_sm90.cuh), so the next
//   tile's copy overlaps this one's products. Each consumer warpgroup runs
//   S = Q K^T as wgmma from shared memory, the online softmax on the f32
//   accumulator fragments (scale in base-2 units, row max over the quad),
//   and O += P V as wgmma with P from registers and V from shared memory
//   (MN-major, the transpose bit). P is carried as two bf16 words, hi + lo,
//   so the product keeps ~16 bits of P: rounding P once to bf16, as the
//   Pallas kernel does before its P V (flash_attention.py:471), puts the
//   output outside its limit against the f32 plain version
//   (tests/test_torch_flash_attention.py). The key
//   loop stops at the diagonal, masks only the diagonal and ragged tiles,
//   skips a warpgroup's wholly masked tile, and the longest query tiles
//   are scheduled first. O is normalised in the epilogue.
// - f32 at every D, and bf16 at D = 16 and 32, flash_fwd_kernel: the
//   scalar design, one block of 256 threads per (64-query tile, head,
//   batch); four threads share a query row, each holding a quarter of its
//   head_dim in registers as float4 chunks; K/V tiles of 64 keys are staged
//   synchronously in shared memory as f32 (2 * 64 * D * 4 bytes) and every
//   product is an f32 FMA on the CUDA cores, which keeps the f32 kernels
//   exact to 2e-5 (TF32 tensor-core products would not).
// Both read GQA natively (kv head = h / (H / Hkv)) and write the lse.
// What the wgmma design leaves on the table: each warpgroup waits on its
// own S product before the softmax and on P V before the next tile (no
// overlap of one tile's softmax with the next tile's products inside a
// warpgroup, only across the two), the second product runs twice (hi and
// lo), and O is stored from registers rather than through shared memory by
// TMA.
#include <math.h>

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

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

namespace sm90 {

// Dynamic shared memory of the wgmma forward: the Q tile and kStages K and
// V tiles, plus the 1024 bytes of alignment slack.
template <int D>
constexpr int fwd_smem_bytes() {
  return tile_bytes(kBlockM, D) + 2 * kStages * tile_bytes(kBlockN, D)
         + 1024;
}

// The maps: q (B*H, Sq, D) with boxes of kBlockM rows; k, v (B*Hkv, Sk, D)
// with boxes of kBlockN rows. o: (B, H, Sq, D) bf16; lse: (B, H, Sq) f32.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int Hkv, int Sq,
                       int Sk, int causal, float scale_log2) {
  constexpr int kQBytes = tile_bytes(kBlockM, D);
  constexpr int kKVBytes = tile_bytes(kBlockN, D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* k_s = q_s + kQBytes;              // [kStages][kKVBytes]
  uint8_t* v_s = k_s + kStages * kKVBytes;   // [kStages][kKVBytes]
  __shared__ uint64_t q_full, full[kStages], empty[kStages];

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int bh_kv = b * Hkv + h / (H / Hkv);
  const int m0 = tile * kBlockM;
  // Keys past the tile's last query row are masked for every row of it.
  const int kv_end = causal ? min(Sk, m0 + kBlockM) : Sk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp; lane 0 loads
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&q_full, kQBytes);
      tma_load_tile<D>(q_s, &q_map, &q_full, m0, kBlockM, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_tile<D>(k_s + s * kKVBytes, &k_map, &full[s],
                         t * kBlockN, kBlockN, bh_kv);
        tma_load_tile<D>(v_s + s * kKVBytes, &v_map, &full[s],
                         t * kBlockN, kBlockN, bh_kv);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = m0 + 64 * wg;  // the warpgroup's first query row
  // this thread's two rows: row0 and row0 + 8
  const int row0 = wg_row0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const uint8_t* q_wg = q_s + 64 * wg * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBlockN;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (causal && k0 > wg_row0 + 63) {  // no row of this warpgroup sees it
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* k_t = k_s + s * kKVBytes;
    const uint8_t* v_t = v_s + s * kKVBytes;

    float sc[kBlockN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(sc, desc_k_major(q_wg, kBlockM, kk),
               desc_k_major(k_t, kBlockN, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Key 0 is visible to every row and the first tile is never skipped,
    // so m is finite after it and alpha = exp2(-inf) = 0 there.
    const bool masked = (causal && k0 + kBlockN - 1 > wg_row0)
                        || k0 + kBlockN > Sk;
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (masked) {
        const int row = row0 + 8 * frag_row(i);
        const int col = k0 + frag_col(i, lane);
        if (col >= Sk || (causal && col > row)) x = -INFINITY;
      }
      sc[i] = x;
      tile_max[frag_row(i)] = fmaxf(tile_max[frag_row(i)], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tile_max[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t p_hi[kBlockN / 4], p_lo[kBlockN / 4];
#pragma unroll
    for (int j = 0; j < kBlockN / 4; ++j) {
      const float p0 = exp2f(sc[2 * j] - m[frag_row(2 * j)]);
      const float p1 = exp2f(sc[2 * j + 1] - m[frag_row(2 * j)]);
      l[frag_row(2 * j)] += p0 + p1;
      split_bf16x2(p0, p1, p_hi[j], p_lo[j]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[frag_row(i)];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t v_desc = desc_mn_major(v_t, kBlockN, kk);
      wgmma_rs(acc, p_hi + 4 * kk, v_desc);
      wgmma_rs(acc, p_lo + 4 * kk, v_desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  const size_t o_base = static_cast<size_t>(bh) * Sq;
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv_l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + 8 * frag_row(i);
    if (row < Sq) {
      const float f = inv_l[frag_row(i)];
      *reinterpret_cast<__nv_bfloat162*>(
          o + (o_base + row) * D + frag_col(i, lane)) =
          __floats2bfloat162_rn(acc[i] * f, acc[i + 1] * f);
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Sq) lse[o_base + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk,
                   int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  // A map cuTensorMapEncodeTiled refuses (an unaligned base) is an
  // invalid value.
  if (!encode_tile_map(&q_map, q, D, Sq, B * H, kBlockM)
      || !encode_tile_map(&k_map, k, D, Sk, B * Hkv, kBlockN)
      || !encode_tile_map(&v_map, v, D, Sk, B * Hkv, kBlockN)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, Sq,
      Sk, causal, sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90

template <typename T, int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Hkv,
                          int Sq, int Sk, int causal, float sm_scale,
                          cudaStream_t stream) {
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

// The design is fixed per (dtype, D) when the library is compiled.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk,
                   int causal, float sm_scale, cudaStream_t stream) {
  if constexpr (sm90::kTakesWgmma<T, D>) {
    return sm90::launch<D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                           sm_scale, stream);
  } else {
    return launch_scalar<T, D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                               sm_scale, stream);
  }
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

// The design the (dtype, D) instance takes (1 = sm90 wgmma, 0 = scalar)
// and its dynamic shared memory in bytes; a cudaError_t for an instance
// that is not built. Each kernel's <entry point>_design has this
// signature.
extern "C" int flash_attention_fwd_design(int D, int dtype, int* design,
                                          int* smem_bytes) {
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int kD = decltype(dim)::value;
    if constexpr (sm90::kTakesWgmma<T, kD>) {
      *design = 1;
      *smem_bytes = sm90::fwd_smem_bytes<kD>();
    } else {
      *design = 0;
      *smem_bytes = 2 * kBlockN * kD * static_cast<int>(sizeof(float));
    }
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

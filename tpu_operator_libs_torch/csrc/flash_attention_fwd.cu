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
// at 989 TFLOP/s for bf16 inputs (67 TFLOP/s for f32 on the CUDA cores,
// the rate the f32 function needs; the tf32 design below runs three TF32
// products for each, 495 TFLOP/s dense, an effective 165 TFLOP/s), against
// Q, K, V and O read or written once at 3.35 TB/s. For bf16 at S = 1024,
// D = 128 the two are within 20% of each other and the bytes are the
// larger (0.0101 against 0.0087 ms at (2, 16, 1024, 128)); the FLOPs bound
// it from S ~ 1200 up and at every f32 shape.
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
// - f32 at every D, and bf16 at D = 16 and 32, flash_fwd_tf32_kernel:
//   both products on the tensor cores by mma.sync.m16n8k8 as three TF32
//   products (tf32_mma.cuh: each f32 operand split as hi + lo, hi by an
//   integer add and mask, a * b as a_lo b_hi + a_hi b_lo + a_hi b_hi),
//   which holds the f32 kernels within their 2e-5 limit where one TF32
//   product misses it more than tenfold (tests/test_torch_flash_attention.py).
//   A bf16 input is exact in TF32, so S = Q K^T takes one mma a step and
//   P V two (P's lo is kept). The block (tf32_block.cuh, the backward's dQ
//   block): 8 warps per (64-query tile, head, batch), longest causal rows
//   first, Q staged once and the K/V tiles of 64 keys up to the diagonal
//   through a two-stage ring of 16-byte cp.async, the next tile's loads
//   in flight under this tile's products; rows padded by 16 bytes, so
//   every fragment load is free of bank conflicts. Warp w
//   owns queries 16 (w % 4) + [0, 16) and keys 32 (w / 4) + [0, 32) of
//   each tile: S from Q (A, from shared memory) and K (B, its rows as
//   columns), head_dim unrolled whole, the
//   online softmax on S's accumulator fragments in base-2 units (a
//   thread holds rows g and g + 8; the quad reduces each row's max with
//   two shuffles a tile), then O += P V with P split from the accumulator
//   as A (tf32_mma.cuh's permuted k slots: no exchange between lanes) and
//   V's rows read untransposed. A warp skips a tile-half that lies wholly
//   after its rows; only the diagonal and ragged tiles are masked. Each
//   warp keeps its own running max, sum and accumulator over its half of
//   the keys, and the two warps of a query slice merge theirs in a fixed
//   order at the end, so two launches give bit-equal O and lse. Not wgmma:
//   TF32 wgmma takes both operands K-major, and V as B of P V is
//   MN-major, so it would need a transposed copy of V.
// Both read GQA natively (kv head = h / (H / Hkv)) and write the lse.
// What the wgmma design leaves on the table: each warpgroup waits on its
// own S product before the softmax and on P V before the next tile (no
// overlap of one tile's softmax with the next tile's products inside a
// warpgroup, only across the two), the second product runs twice (hi and
// lo), and O is stored from registers rather than through shared memory by
// TMA. What the tf32 design leaves: mma.sync, not wgmma; K and V split
// again by each of the four warps that read a tile-half; at D = 128 f32
// a block takes 165 KB of shared memory, and at D = 64 f32 132 registers
// a thread, one block (8 warps) an SM.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"
#include "tf32_block.cuh"
#include "tf32_mma.cuh"

namespace {

namespace tf32 {

// Q and kStages stages of K and V.
template <typename T, int D>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<T, D>();
}

}  // namespace tf32

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); lse: (B, H, Sq) f32.
// scale_log2 = sm_scale * log2(e): scores are kept in base-2 units so the
// exponentials are exp2f.
template <typename T, int D>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_fwd_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int B, int H, int Hkv, int Sq,
                      int Sk, int causal, float scale_log2) {
  using namespace tf32;
  constexpr bool kLo = std::is_same<T, float>::value;  // inputs' lo words
  constexpr int kStride = stride<T, D>();
  constexpr int kTile = kRows * kStride;
  constexpr int kN = D / 8;           // O's 8-column tiles
  constexpr int kCols = kHalf / 8;    // S's 8-key tiles
  // the second half's accumulators, then its running max and sum
  static_assert((4 * kN + 4) * 4 * 32 * 4 <= 2 * kStages * tile_bytes<T, D>(),
                "the halves' exchange must fit the stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kTile;               // [kStages][kTile]
  T* v_s = k_s + kStages * kTile;     // [kStages][kTile]

  const int n_qtiles = (Sq + kRows - 1) / kRows;
  const int tile = n_qtiles - 1 - blockIdx.x / (H * B);  // longest rows first
  const int b = blockIdx.x % (H * B) / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int m0 = tile * kRows;
  const size_t q_plane = (static_cast<size_t>(b) * H + h) * Sq;
  const size_t kv_plane = (static_cast<size_t>(b) * Hkv + hk) * Sk;
  // Keys past the tile's last query row are masked for every row of it.
  const int kv_end = causal ? min(Sk, m0 + kRows) : Sk;
  const int n_ktiles = (kv_end + kRows - 1) / kRows;

  auto stage = [&](int s, int kt) {
    stage_tile<T, D>(k_s + s * kTile, k + kv_plane * D, kt * kRows, Sk);
    stage_tile<T, D>(v_s + s * kTile, v + kv_plane * D, kt * kRows, Sk);
  };
  stage_tile<T, D>(q_s, q + q_plane * D, m0, Sq);
  stage(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int side = warp / 4;
  const int qrow0 = m0 + 16 * (warp % 4);  // the warp's first query
  const int row0 = qrow0 + lane / 4;  // this thread's rows: row0, row0 + 8
  const T* q_w = q_s + 16 * (warp % 4) * kStride;
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int s = kt % kStages;
    if (kt + 1 < n_ktiles) stage((kt + 1) % kStages, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int c0 = kt * kRows + kHalf * side;  // the warp's first key
    // Every row of a warp that does not skip the half sees its key c0, so
    // m is finite after the warp's first half and alpha = exp2(-inf) = 0
    // there.
    if (!((causal && c0 > qrow0 + 15) || c0 >= Sk || qrow0 >= Sq)) {
      const T* k_w = k_s + s * kTile + kHalf * side * kStride;
      const T* v_w = v_s + s * kTile + kHalf * side * kStride;
      // S = Q K^T, 16 queries x kHalf keys, head_dim unrolled whole
      // (unlike the backward's two first products, one fits the registers:
      // 158 at D = 128 f32, no spill; 3% faster at (c), PERF.md §6)
      float sc[kCols][4];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        const FragA qa = a_rows<kLo>(q_w, kStride, c, lane);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          mma3<kLo, kLo>(sc[j], qa, b_cols<kLo>(k_w + 8 * j * kStride,
                                                kStride, c, lane));
        }
      }
      const bool masked = (causal && c0 + kHalf - 1 > qrow0) || c0 + kHalf > Sk;
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (masked) {
            const int col = c0 + 8 * j + 2 * (lane % 4) + e % 2;
            const int row = row0 + 8 * (e / 2);
            if (col >= Sk || (causal && col > row)) x = -INFINITY;
          }
          sc[j][e] = x;
          tile_max[e / 2] = fmaxf(tile_max[e / 2], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], sm90::quad_max(tile_max[r]));
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(sc[j][e] - m[e / 2]);  // P
          l[e / 2] += sc[j][e];
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
      }
      // O += P V over the warp's keys
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const FragA pa = a_from_acc<true>(sc[j]);
        const T* v_j = v_w + 8 * j * kStride;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          mma3<true, kLo>(acc[n], pa,
                          b_rows_pair<kLo>(v_j, kStride, 8 * n, lane));
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // The second half's warps hand their (acc, m, l) to the first half's,
  // which merge them after their own.
  float* xch = reinterpret_cast<float*>(k_s);
  float* ml = xch + 4 * kN * 4 * 32 + (warp % 4) * 4 * 32 + lane;
  if (side == 1) {
    put(acc, exchange_slot<kN>(xch, 0, 1));
    ml[0] = m[0];
    ml[32] = m[1];
    ml[64] = l[0];
    ml[96] = l[1];
  }
  __syncthreads();
  if (side == 1) return;
  float a0[2], a1[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = ml[32 * r];
    const float m_all = fmaxf(m[r], m1);
    a0[r] = exp2f(m[r] - m_all);
    a1[r] = exp2f(m1 - m_all);
    m[r] = m_all;
    l[r] = sm90::quad_sum(l[r] * a0[r] + ml[64 + 32 * r] * a1[r]);
    inv_l[r] = 1.f / l[r];
  }
  const float* other = exchange_slot<kN>(xch, 0, 1);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = other[(4 * n + e) * 32 + lane];
      acc[n][e] = (acc[n][e] * a0[e / 2] + x * a1[e / 2]) * inv_l[e / 2];
    }
  }
  store_rows(o + (q_plane + row0) * D, acc, row0, Sq, 1.f);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Sq) lse[q_plane + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tf32 kernel reads rows 16 bytes at a time and stages up to 165 KB of
// shared memory (above the 48 KB default, hence the attribute).
template <typename T, int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int Hkv, int Sq,
                        int Sk, int causal, float sm_scale,
                        cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = tf32::fwd_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = tf32::blocks(B, H, Sq);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_tf32_kernel<T, D>
      <<<static_cast<int>(blocks), tf32::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, B, H, Hkv, Sq,
          Sk, causal, sm_scale * kLog2e);
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
    return launch_tf32<T, D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
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

// The design the (dtype, D) instance takes (1 = sm90 wgmma, 2 = 3xTF32
// mma.sync, the codes of flash_attention_bwd.cu) and its dynamic shared
// memory in bytes; a cudaError_t for an instance
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
      *design = 2;
      *smem_bytes = tf32::fwd_smem_bytes<T, kD>();
    }
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

// Causal flash-attention backward for Hopper (sm_90a): a dK/dV kernel and a
// dQ kernel behind a plain C interface loaded with ctypes
// (tpu_operator_libs_torch/kernels/_build.py).
//
// Replaces: the two Pallas TPU backward kernels that jax.grad of
// tpu_operator_libs/examples/llama.py::next_token_loss reaches with
// attention_impl="flash": jax/experimental/pallas/ops/tpu/flash_attention.py
// ::_flash_attention_bwd_dkv (pl.pallas_call, kernel
// _flash_attention_dkv_kernel) and ::_flash_attention_bwd_dq (pl.pallas_call,
// kernel _flash_attention_dq_kernel).
// Same function: with P = exp(Q K^T * sm_scale - lse) recomputed from the
// forward's per-row log-sum-exp (f32, natural log; the Pallas pair (l, m)
// carries the same information), dP = dO V^T, di = rowsum(O * dO) and
// dS = P * (dP - di):
//   dV = P^T dO,   dK = dS^T Q * sm_scale,   dQ = dS K * sm_scale,
// causal (query i sees keys <= i). di is computed by the caller.
//
// Bound on an H100 SXM, per call at the model's shapes (S >= 1024, D = 128):
// dK/dV does four products (Q K^T, dO V^T, P^T dO, dS^T Q) and dQ three
// (Q K^T, dO V^T, dS K) of 2*D FLOPs per visible (query, key) pair, at 989
// TFLOP/s for bf16 inputs, against Q, K, V, dO, lse and di read and the
// gradients written once at 3.35 TB/s: the FLOPs bound both. For f32
// inputs the f32 CUDA-core rate (67 TFLOP/s) bounds the function; the tf32
// design below runs three TF32 products for each (495 TFLOP/s dense), an
// effective 165 TFLOP/s.
//
// Both kernels take one of two designs, chosen by (dtype, head_dim) at
// compile time (sm90::kTakesWgmma): bf16 at D = 64 and 128 runs every
// product on the tensor cores (wgmma) over tiles that a producer stages
// by TMA (flash_attention_sm90.cuh); f32 at every D, and bf16 at D = 16
// and 32, run every product on the tensor cores by mma.sync as three TF32
// products (tf32_mma.cuh), which holds the f32 kernels to their 2e-5 limit
// where one TF32 product would miss it a hundredfold
// (tests/test_torch_flash_attention.py). A bf16 input is exact in TF32, so
// its lo word is 0 and the products with it are one (Q K^T, dO V^T) or two
// (P^T dO, dS^T Q, dS K) mma.sync, not three.
//
// dK/dV:
// - bf16 at D = 64 and 128, flash_bwd_dkv_wgmma_kernel: one block of 384
//   threads per (128-key tile, KV head, batch): two consumer warpgroups of
//   64 keys and a producer warpgroup that hands its registers to them
//   (setmaxnreg: 240 a consumer thread, 24 a producer thread), since dK
//   and dV take 128 of a thread's registers at D = 128 and a 288-thread
//   block caps each at 168. The producer's first thread loads the block's
//   K and V rows once by TMA (they stay in shared memory) and streams each
//   query tile's Q and dO (64 rows) through a two-stage TMA ring of
//   full/empty mbarriers; each consumer warpgroup stages the tile's lse
//   and di in shared memory itself, loaded while its first products run
//   (no TMA: a row of Sq f32 is not 16-byte aligned at odd Sq). The
//   walk: each query head of the KV head's group, then its query tiles from
//   the diagonal down; tiles wholly above the diagonal are never loaded,
//   and a warpgroup whose keys all lie after a tile's last query skips it.
//   Per tile each warpgroup runs the transposed products, keys as M:
//   S^T = K Q^T and dP^T = V dO^T as wgmma from shared memory (both
//   K-major), recomputes P^T = exp2(S^T * scale_log2 - lse * log2e) and
//   dS^T = P^T * (dP^T - di) in f32 on the fragments (a fragment's column
//   is a query, so lse and di are read by column), and runs
//   dV += P^T dO and dK += dS^T Q as wgmma with P^T and dS^T from registers
//   (the m64n64 accumulator repacked is the A operand) and dO, Q MN-major.
//   P^T and dS^T are carried as hi + lo bf16 words: rounding them once, as
//   the Pallas kernel does (flash_attention.py:900, :918), puts dK and dV
//   outside the bf16 limit against the f32 plain version
//   (tests/test_torch_flash_attention.py). dK is scaled by sm_scale in the
//   epilogue. The dK and dV accumulators (D / 2 f32 each a thread) stay in
//   registers across the whole walk, so GQA's sum over the group needs no
//   atomics and K/V are read narrow (the Pallas call needs them repeated to
//   H heads and a sum afterwards). Blocks of the first key tiles, which see
//   the most queries, are scheduled first.
// - otherwise flash_bwd_dkv_tf32_kernel: one block of 8 warps per (64-key
//   tile, query head, batch), so that a GQA group's heads spread over
//   blocks (256 blocks at (2, 8 / 2, 1000), where a block per KV head gave
//   64). K and V of the block's keys are staged once and each 64-query
//   tile's Q, dO, lse and di pass through a two-stage ring by 16-byte (lse
//   and di 4-byte) cp.async, the next tile's loads in flight under this
//   tile's products. Warp w owns keys 16 (w % 4) + [0, 16) and queries
//   32 (w / 4) + [0, 32) of each tile: S^T = K Q^T and dP^T = V dO^T into
//   16 x 32 accumulators, P^T and dS^T on them in f32, then dV += P^T dO
//   and dK += dS^T Q with P^T and dS^T split from the accumulators as A
//   operands (tf32_mma.cuh's permuted k slots: no exchange between lanes)
//   and dO, Q read by the lanes from shared memory untransposed. Rows are
//   padded by 16 bytes, so every fragment load is free of bank conflicts.
//   The two warps of a key slice add their halves in a fixed order at the
//   end. Where the group is 1 the block writes dK and dV; otherwise each
//   block writes its head's f32 partials and the group's last block to
//   finish (csrc/ticket.cuh) adds them in head order, so two launches give
//   the same bits with no float atomics. The partials take 2 * B * H * Sk
//   * D f32, twice dK and dV in f32 times the group: 8 MB at (2, 8 / 2,
//   1000, 64), 4.3 GB at (16, 32 / 8, 8192, 128). Key tiles are scheduled
//   heaviest first (the first tiles see the most queries).
//
// dQ:
// - bf16 at D = 64 and 128, flash_bwd_dq_wgmma_kernel: the wgmma forward's
//   block (flash_attention_fwd.cu): 128 query rows as two consumer
//   warpgroups and a producer warp that loads the Q and dO tiles once and
//   the K/V tiles of 64 keys into a two-stage TMA ring. Per tile each
//   warpgroup runs S = Q K^T and dP = dO V^T as wgmma from shared memory,
//   recomputes P = exp2(S * scale_log2 - lse * log2e) and dS = P * (dP -
//   di) in f32 on the fragments, and runs dQ += dS K as wgmma with dS from
//   registers and K from shared memory (MN-major). dS is carried as hi + lo
//   for the same reason; the Pallas kernel rounds it once
//   (flash_attention.py:1258). dQ is scaled by sm_scale in the epilogue.
// - otherwise flash_bwd_dq_tf32_kernel: the dK/dV tf32 block turned
//   round, one block of 8 warps per (64-query tile, head, batch), longest
//   causal rows first: Q and dO staged once, the K/V tiles of 64 keys up to
//   the diagonal through the two-stage cp.async ring; warp w owns queries
//   16 (w % 4) + [0, 16) with their lse and di in registers and keys
//   32 (w / 4) + [0, 32) of each tile: S = Q K^T and dP = dO V^T, then
//   dQ += dS K, the two warps of a query slice adding their halves in a
//   fixed order at the end.
// Every sum runs in a fixed order and no float is accumulated by atomics,
// so two launches on the same inputs give bit-equal results.
// What the wgmma designs leave on the table: each warpgroup waits on its
// first two products before the elementwise work and on the second
// products before the next tile (the two warpgroups overlap only each
// other); the second products run twice (hi and lo), 1.5x the function's
// tensor-core work for dK/dV and 1.33x for dQ; dK/dV's grid is
// (S / 128, H_kv, B), which leaves SMs idle where H_kv * B is small (32
// blocks at (2, 8 / 2, 1000)); the gradients are stored from registers
// rather than through shared memory by TMA. What the tf32 design leaves:
// mma.sync, not wgmma (which takes TF32 only with both operands K-major in
// shared memory, so dO, Q and K would need transposed copies); every
// operand is split again by each warp that reads it; at D = 128 f32 a
// block takes 199 KB of shared memory, one block (8 warps) an SM.
#include <limits.h>
#include <math.h>

#include "cp_async.cuh"
#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"
#include "tf32_block.cuh"
#include "tf32_mma.cuh"
#include "ticket.cuh"

namespace {

namespace tf32 {

// dK/dV: K and V, kStages stages of Q and dO, and of lse and di (f32).
template <typename T, int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<T, D>() + 2 * kStages * kRows * 4;
}

// dQ: Q and dO, kStages stages of K and V.
template <typename T, int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<T, D>();
}

}  // namespace tf32

// q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); lse, di: (B, H, Sq) f32;
// dk, dv: (B, Hkv, Sk, D). Where H > Hkv, `partials` holds 2 * B * H * Sk
// * D f32 (each query head's dK, then dV, unscaled) and `counters`
// ceil(Sk / 64) * Hkv * B ints, 0 before the launch and after it.
// scale_log2 = sm_scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_bwd_dkv_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ partials,
                          int* __restrict__ counters, int B, int H, int Hkv,
                          int Sq, int Sk, int causal, float scale_log2,
                          float sm_scale) {
  using namespace tf32;
  constexpr bool kLo = std::is_same<T, float>::value;  // inputs' lo words
  constexpr int kStride = stride<T, D>();
  constexpr int kTile = kRows * kStride;
  constexpr int kN = D / 8;  // the accumulators' 8-column tiles
  constexpr int kChunk = chunk<D>();
  static_assert(4 * 2 * kN * 4 * 32 * 4 <= 2 * kStages * tile_bytes<T, D>(),
                "the halves' exchange must fit the stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTile;
  T* q_s = v_s + kTile;               // [kStages][kTile]
  T* do_s = q_s + kStages * kTile;    // [kStages][kTile]
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * kTile);
  float* di_s = lse_s + kStages * kRows;  // each [kStages][kRows]
  __shared__ int ticket;

  // The heaviest key tiles (the first: they see the most queries) first;
  // a group's heads side by side.
  const int tile = blockIdx.x / (H * B);
  const int b = blockIdx.x % (H * B) / H;
  const int h = blockIdx.x % H;
  const int group = H / Hkv;
  const int hk = h / group;
  const int k0 = tile * kRows;
  const size_t q_plane = (static_cast<size_t>(b) * H + h) * Sq;
  const size_t kv_plane = (static_cast<size_t>(b) * Hkv + hk) * Sk;
  // Query i sees key j iff j <= i: the query tiles before the one holding
  // the block's first key see none of its keys and are never loaded.
  const int qt0 = causal ? k0 / kRows : 0;
  const int n_qtiles = (Sq + kRows - 1) / kRows;

  auto stage = [&](int s, int qt) {
    stage_tile<T, D>(q_s + s * kTile, q + q_plane * D, qt * kRows, Sq);
    stage_tile<T, D>(do_s + s * kTile, dout + q_plane * D, qt * kRows, Sq);
    if (threadIdx.x < 2 * kRows) {
      const int qi = qt * kRows + threadIdx.x % kRows;
      const bool is_lse = threadIdx.x < kRows;
      cp_async4((is_lse ? lse_s : di_s) + s * kRows + threadIdx.x % kRows,
                (is_lse ? lse : di) + q_plane + (qi < Sq ? qi : 0), qi < Sq);
    }
  };
  stage_tile<T, D>(k_s, k + kv_plane * D, k0, Sk);
  stage_tile<T, D>(v_s, v + kv_plane * D, k0, Sk);
  if (qt0 < n_qtiles) stage(0, qt0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int side = warp / 4;
  const int key0 = k0 + 16 * (warp % 4);  // the warp's first key
  const int row0 = key0 + lane / 4;  // this thread's keys: row0, row0 + 8
  const T* k_w = k_s + 16 * (warp % 4) * kStride;
  const T* v_w = v_s + 16 * (warp % 4) * kStride;

  float dk_acc[kN][4], dv_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }
  }

  for (int qt = qt0; qt < n_qtiles; ++qt) {
    const int s = (qt - qt0) % kStages;
    if (qt + 1 < n_qtiles) stage((qt + 1 - qt0) % kStages, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();

    const int q0 = qt * kRows + kHalf * side;  // the warp's first query
    if (!((causal && key0 > q0 + kHalf - 1) || key0 >= Sk || q0 >= Sq)) {
      const T* q_w = q_s + s * kTile + kHalf * side * kStride;
      const T* do_w = do_s + s * kTile + kHalf * side * kStride;
      const float* lse_w = lse_s + s * kRows + kHalf * side;
      const float* di_w = di_s + s * kRows + kHalf * side;
      // S^T = K Q^T and dP^T = V dO^T, 16 keys x kHalf queries
      float st[kHalf / 8][4], dpt[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
      }
#pragma unroll 1
      for (int c0 = 0; c0 < D; c0 += kChunk) {
#pragma unroll
        for (int c = c0; c < c0 + kChunk; c += 8) {
          const FragA ka = a_rows<kLo>(k_w, kStride, c, lane);
          const FragA va = a_rows<kLo>(v_w, kStride, c, lane);
#pragma unroll
          for (int j = 0; j < kHalf / 8; ++j) {
            mma3<kLo, kLo>(st[j], ka, b_cols<kLo>(q_w + 8 * j * kStride,
                                                  kStride, c, lane));
            mma3<kLo, kLo>(dpt[j], va, b_cols<kLo>(do_w + 8 * j * kStride,
                                                   kStride, c, lane));
          }
        }
      }
      // P^T and dS^T in place of S^T and dP^T: a fragment's row is a key
      // and its column a query, so lse and di are read by column.
      const bool masked = (causal && key0 + 15 > q0) || key0 + 16 > Sk
                          || q0 + kHalf > Sq;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_w + col);
        const float2 d2 = *reinterpret_cast<const float2*>(di_w + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool visible = true;
          if (masked) {
            const int key = row0 + 8 * (e / 2);
            const int qi = q0 + col + e % 2;
            visible = key < Sk && qi < Sq && (!causal || key <= qi);
          }
          const float p =
              visible ? exp2f(fmaf(st[j][e], scale_log2,
                                   -((e % 2 ? l2.y : l2.x) * kLog2e)))
                      : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (e % 2 ? d2.y : d2.x));
        }
      }
      // dV += P^T dO and dK += dS^T Q over the warp's queries
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const FragA pa = a_from_acc<true>(st[j]);
        const FragA dsa = a_from_acc<true>(dpt[j]);
        const T* do_j = do_w + 8 * j * kStride;
        const T* q_j = q_w + 8 * j * kStride;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          mma3<true, kLo>(dv_acc[n], pa,
                          b_rows_pair<kLo>(do_j, kStride, 8 * n, lane));
          mma3<true, kLo>(dk_acc[n], dsa,
                          b_rows_pair<kLo>(q_j, kStride, 8 * n, lane));
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before its refill
  }
  cp_async_wait<0>();  // nothing in flight (K and V where no tile ran)
  __syncthreads();

  float* xch = reinterpret_cast<float*>(q_s);
  if (side == 1) {
    put(dk_acc, exchange_slot<kN>(xch, 0, 2));
    put(dv_acc, exchange_slot<kN>(xch, 1, 2));
  }
  __syncthreads();
  if (side == 0) {
    add(dk_acc, exchange_slot<kN>(xch, 0, 2));
    add(dv_acc, exchange_slot<kN>(xch, 1, 2));
    if (group == 1) {
      const size_t off = (kv_plane + row0) * D;
      store_rows(dk + off, dk_acc, row0, Sk, sm_scale);
      store_rows(dv + off, dv_acc, row0, Sk, 1.f);
    } else {  // this head's partials, unscaled
      const size_t off = ((static_cast<size_t>(b) * H + h) * Sk + row0) * D;
      store_rows(partials + off, dk_acc, row0, Sk, 1.f);
      store_rows(partials + static_cast<size_t>(B) * H * Sk * D + off,
                 dv_acc, row0, Sk, 1.f);
    }
  }
  if (group == 1) return;

  // The group's last block to finish adds its heads' partials in head
  // order, scales dK and writes both.
  const int n_ktiles = (Sk + kRows - 1) / kRows;
  int* counter = counters + (static_cast<size_t>(b) * Hkv + hk) * n_ktiles
                 + tile;
  if (!tickets::last(counter, group, &ticket)) return;
  const size_t head = static_cast<size_t>(Sk) * D / 4;  // float4s a head
  const float4* pk = reinterpret_cast<const float4*>(partials)
                     + ((static_cast<size_t>(b) * H + hk * group) * Sk + k0)
                       * D / 4;
  const float4* pv = pk + static_cast<size_t>(B) * H * head;
  const int n = min(kRows, Sk - k0) * D / 4;
  for (int i = threadIdx.x; i < n; i += tf32::kThreads) {
    float4 sk = __ldcg(pk + i);
    float4 sv = __ldcg(pv + i);
    for (int g = 1; g < group; ++g) {
      const float4 xk = __ldcg(pk + g * head + i);
      const float4 xv = __ldcg(pv + g * head + i);
      sk = make_float4(sk.x + xk.x, sk.y + xk.y, sk.z + xk.z, sk.w + xk.w);
      sv = make_float4(sv.x + xv.x, sv.y + xv.y, sv.z + xv.z, sv.w + xv.w);
    }
    const size_t off = (kv_plane + k0) * D + 4 * static_cast<size_t>(i);
    store4(dk + off, scale4(sk, sm_scale));
    store4(dv + off, sv);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// dq: (B, H, Sq, D); the other arguments as for the dK/dV kernel.
template <typename T, int D>
__global__ void __launch_bounds__(tf32::kThreads, 1)
flash_bwd_dq_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dq,
                         int B, int H, int Hkv, int Sq, int Sk, int causal,
                         float scale_log2, float sm_scale) {
  using namespace tf32;
  constexpr bool kLo = std::is_same<T, float>::value;
  constexpr int kStride = stride<T, D>();
  constexpr int kTile = kRows * kStride;
  constexpr int kN = D / 8;
  constexpr int kChunk = chunk<D>();
  static_assert(4 * kN * 4 * 32 * 4 <= 2 * kStages * tile_bytes<T, D>(),
                "the halves' exchange must fit the stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kTile;
  T* k_s = do_s + kTile;              // [kStages][kTile]
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
  stage_tile<T, D>(do_s, dout + q_plane * D, m0, Sq);
  if (n_ktiles > 0) stage(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int side = warp / 4;
  const int qrow0 = m0 + 16 * (warp % 4);  // the warp's first query
  const int row0 = qrow0 + lane / 4;  // this thread's rows: row0, row0 + 8
  const T* q_w = q_s + 16 * (warp % 4) * kStride;
  const T* do_w = do_s + 16 * (warp % 4) * kStride;
  float lse2[2], di_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? lse[q_plane + row] * kLog2e : 0.f;
    di_row[r] = row < Sq ? di[q_plane + row] : 0.f;
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int s = kt % kStages;
    if (kt + 1 < n_ktiles) stage((kt + 1) % kStages, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int c0 = kt * kRows + kHalf * side;  // the warp's first key
    if (!((causal && c0 > qrow0 + 15) || c0 >= Sk || qrow0 >= Sq)) {
      const T* k_w = k_s + s * kTile + kHalf * side * kStride;
      const T* v_w = v_s + s * kTile + kHalf * side * kStride;
      // S = Q K^T and dP = dO V^T, 16 queries x kHalf keys
      float sc[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      }
#pragma unroll 1
      for (int c0 = 0; c0 < D; c0 += kChunk) {
#pragma unroll
        for (int c = c0; c < c0 + kChunk; c += 8) {
          const FragA qa = a_rows<kLo>(q_w, kStride, c, lane);
          const FragA doa = a_rows<kLo>(do_w, kStride, c, lane);
#pragma unroll
          for (int j = 0; j < kHalf / 8; ++j) {
            mma3<kLo, kLo>(sc[j], qa, b_cols<kLo>(k_w + 8 * j * kStride,
                                                  kStride, c, lane));
            mma3<kLo, kLo>(dp[j], doa, b_cols<kLo>(v_w + 8 * j * kStride,
                                                   kStride, c, lane));
          }
        }
      }
      const bool masked = (causal && c0 + kHalf - 1 > qrow0)
                          || c0 + kHalf > Sk || qrow0 + 16 > Sq;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          bool visible = true;
          if (masked) {
            const int col = c0 + 8 * j + 2 * (lane % 4) + e % 2;
            const int row = row0 + 8 * r;
            visible = col < Sk && row < Sq && (!causal || col <= row);
          }
          const float p =
              visible ? exp2f(fmaf(sc[j][e], scale_log2, -lse2[r])) : 0.f;
          dp[j][e] = p * (dp[j][e] - di_row[r]);
        }
      }
      // dQ += dS K over the warp's keys
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const FragA dsa = a_from_acc<true>(dp[j]);
        const T* k_j = k_w + 8 * j * kStride;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          mma3<true, kLo>(acc[n], dsa,
                          b_rows_pair<kLo>(k_j, kStride, 8 * n, lane));
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* xch = reinterpret_cast<float*>(k_s);
  if (side == 1) put(acc, exchange_slot<kN>(xch, 0, 1));
  __syncthreads();
  if (side == 0) {
    add(acc, exchange_slot<kN>(xch, 0, 1));
    store_rows(dq + (q_plane + row0) * D, acc, row0, Sq, sm_scale);
  }
}

namespace sm90 {

constexpr int kKeyTile = 128;  // keys per dK/dV block: 64 per warpgroup
constexpr int kQueryTile = 64;  // query rows per Q/dO stage of the ring
// The dK/dV block: two consumer warpgroups and a producer warpgroup, whose
// first thread issues every TMA load. A warp scheduler's share of the
// register file (16,384) holds one warp of each warpgroup, so at launch a
// thread has at most 168 registers; the dK and dV accumulators alone take
// D = 128 of them. The producer gives registers up and the consumers take
// them (setmaxnreg), within the block's 3 * 168 = 504 a lane.
constexpr int kDkvThreads = kConsumers + 128;
// A consumer keeps dK, dV, S^T and dP^T live at once, 192 f32 at D = 128.
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
static_assert(2 * kConsumerRegs + kProducerRegs <= 3 * 168,
              "setmaxnreg would wait for registers the block does not have");

// The dK/dV grid: a block per (kKeyTile keys, KV head, batch).
inline dim3 dkv_grid(int B, int Hkv, int Sk) {
  return dim3((Sk + kKeyTile - 1) / kKeyTile, Hkv, B);
}

// Dynamic shared memory of the wgmma dK/dV: the block's K and V tiles and
// kStages Q and dO tiles, plus the 1024 bytes of alignment slack.
template <int D>
constexpr int dkv_smem_bytes() {
  return 2 * tile_bytes(kKeyTile, D) + 2 * kStages * tile_bytes(kQueryTile, D)
         + 1024;
}

// The maps: q, dout (B*H, Sq, D) with boxes of kQueryTile rows; k, v
// (B*Hkv, Sk, D) with boxes of kKeyTile rows. dk, dv: (B, Hkv, Sk, D)
// bf16; lse, di: (B, H, Sq) f32.
//
// Every product runs transposed, keys as the M dimension, so that the
// accumulators are the block's own dK and dV rows and P^T and dS^T come out
// of the first products in the layout of the second products' A operand:
// S^T = K Q^T and dP^T = V dO^T from shared memory (both K-major), then
// dV += P^T dO and dK += dS^T Q with P^T, dS^T from registers and dO, Q
// MN-major. A fragment's row is a key and its column a query, so lse and
// di are read by column: each warpgroup stages the tile's 64 of each in
// shared memory itself, loaded while its first products run.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                           int Sq, int Sk, int causal, float scale_log2,
                           float sm_scale) {
  constexpr int kQBytes = tile_bytes(kQueryTile, D);
  constexpr int kKVBytes = tile_bytes(kKeyTile, D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + kKVBytes;
  uint8_t* q_s = v_s + kKVBytes;              // [kStages][kQBytes]
  uint8_t* do_s = q_s + kStages * kQBytes;    // [kStages][kQBytes]
  // [warpgroup][tile parity]: lse * log2(e) and di of the tile's queries
  __shared__ __align__(16) float lse_s[2][2][kQueryTile];
  __shared__ __align__(16) float di_s[2][2][kQueryTile];
  __shared__ uint64_t kv_full, full[kStages], empty[kStages];

  const int tile = blockIdx.x;  // the first key tiles see the most queries
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int n0 = tile * kKeyTile;
  // Query i sees key j iff j <= i: the query tiles before the one holding
  // the block's first key see none of its keys and are never loaded.
  const int q_first = causal ? n0 / kQueryTile : 0;
  const int n_qtiles = (Sq + kQueryTile - 1) / kQueryTile;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The walk, the same for the producer and the consumers: each query head
  // of the KV head's group, then its query tiles from the diagonal down;
  // `it` counts the stages filled.
  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&kv_full, 2 * kKVBytes);
      tma_load_tile<D>(k_s, &k_map, &kv_full, n0, kKeyTile, b * Hkv + hk);
      tma_load_tile<D>(v_s, &v_map, &kv_full, n0, kKeyTile, b * Hkv + hk);
      int it = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int bh = b * H + hk * group + hh;
        for (int t = q_first; t < n_qtiles; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[s], 2 * kQBytes);
          tma_load_tile<D>(q_s + s * kQBytes, &q_map, &full[s],
                           t * kQueryTile, kQueryTile, bh);
          tma_load_tile<D>(do_s + s * kQBytes, &do_map, &full[s],
                           t * kQueryTile, kQueryTile, bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int kw0 = n0 + 64 * wg;  // the warpgroup's first key
  // this thread's two keys: row0 and row0 + 8
  const int row0 = kw0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const uint8_t* k_wg = k_s + 64 * wg * 128;
  const uint8_t* v_wg = v_s + 64 * wg * 128;
  // thread r < 64 of the warpgroup stages lse of query r, 64 + r its di
  const int stat_row = threadIdx.x % kQueryTile;
  const bool stages_lse = threadIdx.x % 128 < kQueryTile;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  mbar_wait(&kv_full, 0);
  int it = 0;
  int parity = 0;  // flips with every tile the warpgroup computes
  for (int hh = 0; hh < group; ++hh) {
    const float* stat = (stages_lse ? lse : di)
                        + static_cast<size_t>(b * H + hk * group + hh) * Sq;
    for (int t = q_first; t < n_qtiles; ++t, ++it) {
      const int s = it % kStages;
      const int q0 = t * kQueryTile;
      mbar_wait(&full[s], (it / kStages) & 1);
      if (causal && kw0 > q0 + kQueryTile - 1) {  // no query sees its keys
        mbar_arrive(&empty[s]);
        continue;
      }
      const uint8_t* q_t = q_s + s * kQBytes;
      const uint8_t* do_t = do_s + s * kQBytes;
      // rows past Sq read 0; their columns are masked
      const int stat_q = q0 + stat_row;
      const float x = stat_q < Sq ? stat[stat_q] : 0.f;

      float st[kQueryTile / 2], dpt[kQueryTile / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(st, desc_k_major(k_wg, kKeyTile, kk),
                 desc_k_major(q_t, kQueryTile, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dpt, desc_k_major(v_wg, kKeyTile, kk),
                 desc_k_major(do_t, kQueryTile, kk), kk > 0);
      }
      wgmma_commit();
      // Two buffers by parity: a warp that runs ahead writes the other one
      // while the rest of its warpgroup still reads this tile's.
      float* lse_t = lse_s[wg][parity];
      float* di_t = di_s[wg][parity];
      if (stages_lse) {
        lse_t[stat_row] = x * kLog2e;
      } else {
        di_t[stat_row] = x;
      }
      named_barrier_sync(1 + wg, 128);
      parity ^= 1;
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const bool masked = (causal && kw0 + 63 > q0) || kw0 + 64 > Sk
                          || q0 + kQueryTile > Sq;
      // P^T and dS^T as hi + lo bf16 pairs, in place of S^T and dP^T
      uint32_t p_hi[kQueryTile / 4], p_lo[kQueryTile / 4];
      uint32_t ds_hi[kQueryTile / 4], ds_lo[kQueryTile / 4];
#pragma unroll
      for (int j = 0; j < kQueryTile / 4; ++j) {
        const int col = frag_col(2 * j, lane);  // queries col, col + 1
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 di2 = *reinterpret_cast<const float2*>(di_t + col);
        const int key = row0 + 8 * frag_row(2 * j);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool visible = true;
          if (masked) {
            const int qi = q0 + col + e;
            visible = key < Sk && qi < Sq && (!causal || key <= qi);
          }
          p[e] = visible ? exp2f(fmaf(st[2 * j + e], scale_log2,
                                      -(e ? lse2.y : lse2.x)))
                         : 0.f;
          ds[e] = p[e] * (dpt[2 * j + e] - (e ? di2.y : di2.x));
        }
        split_bf16x2(p[0], p[1], p_hi[j], p_lo[j]);
        split_bf16x2(ds[0], ds[1], ds_hi[j], ds_lo[j]);
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQueryTile / 16; ++kk) {
        const uint64_t do_desc = desc_mn_major(do_t, kQueryTile, kk);
        wgmma_rs(dv_acc, p_hi + 4 * kk, do_desc);
        wgmma_rs(dv_acc, p_lo + 4 * kk, do_desc);
      }
#pragma unroll
      for (int kk = 0; kk < kQueryTile / 16; ++kk) {
        const uint64_t q_desc = desc_mn_major(q_t, kQueryTile, kk);
        wgmma_rs(dk_acc, ds_hi + 4 * kk, q_desc);
        wgmma_rs(dk_acc, ds_lo + 4 * kk, q_desc);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);
    }
  }

  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = row0 + 8 * frag_row(i);
    if (key < Sk) {
      const size_t off = (kv_base + key) * D + frag_col(i, lane);
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          dk_acc[i] * sm_scale, dk_acc[i + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, int causal, float sm_scale,
                       cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  // A map cuTensorMapEncodeTiled refuses (an unaligned base) is an
  // invalid value.
  if (!encode_tile_map(&q_map, q, D, Sq, B * H, kQueryTile)
      || !encode_tile_map(&do_map, dout, D, Sq, B * H, kQueryTile)
      || !encode_tile_map(&k_map, k, D, Sk, B * Hkv, kKeyTile)
      || !encode_tile_map(&v_map, v, D, Sk, B * Hkv, kKeyTile)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = dkv_grid(B, Hkv, Sk);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Sk, causal,
      sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

// The dQ grid: a block per (kBlockM queries, head, batch).
inline dim3 dq_grid(int B, int H, int Sq) {
  return dim3((Sq + kBlockM - 1) / kBlockM, H, B);
}

// Dynamic shared memory of the wgmma dQ: the Q and dO tiles and kStages K
// and V tiles, plus the 1024 bytes of alignment slack.
template <int D>
constexpr int dq_smem_bytes() {
  return 2 * tile_bytes(kBlockM, D) + 2 * kStages * tile_bytes(kBlockN, D)
         + 1024;
}

// The maps: q, dout (B*H, Sq, D) with boxes of kBlockM rows; k, v
// (B*Hkv, Sk, D) with boxes of kBlockN rows. dq: (B, H, Sq, D) bf16;
// lse, di: (B, H, Sq) f32.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                          int Sq, int Sk, int causal, float scale_log2,
                          float sm_scale) {
  constexpr int kQBytes = tile_bytes(kBlockM, D);
  constexpr int kKVBytes = tile_bytes(kBlockN, D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + kQBytes;
  uint8_t* k_s = do_s + kQBytes;             // [kStages][kKVBytes]
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
      mbar_expect_tx(&q_full, 2 * kQBytes);
      tma_load_tile<D>(q_s, &q_map, &q_full, m0, kBlockM, bh);
      tma_load_tile<D>(do_s, &do_map, &q_full, m0, kBlockM, bh);
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
  const uint8_t* do_wg = do_s + 64 * wg * 128;
  const size_t q_base = static_cast<size_t>(bh) * Sq;

  float lse2[2], di_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? lse[q_base + row] * kLog2e : 0.f;
    di_row[r] = row < Sq ? di[q_base + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

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

    float sc[kBlockN / 2], dp[kBlockN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(sc, desc_k_major(q_wg, kBlockM, kk),
               desc_k_major(k_t, kBlockN, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss(dp, desc_k_major(do_wg, kBlockM, kk),
               desc_k_major(v_t, kBlockN, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool masked = (causal && k0 + kBlockN - 1 > wg_row0)
                        || k0 + kBlockN > Sk;
    uint32_t ds_hi[kBlockN / 4], ds_lo[kBlockN / 4];
#pragma unroll
    for (int j = 0; j < kBlockN / 4; ++j) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * j + e;
        const int r = frag_row(i);
        bool visible = true;
        if (masked) {
          const int col = k0 + frag_col(i, lane);
          visible = col < Sk && (!causal || col <= row0 + 8 * r);
        }
        const float p =
            visible ? exp2f(fmaf(sc[i], scale_log2, -lse2[r])) : 0.f;
        ds[e] = p * (dp[i] - di_row[r]);
      }
      split_bf16x2(ds[0], ds[1], ds_hi[j], ds_lo[j]);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t k_desc = desc_mn_major(k_t, kBlockN, kk);
      wgmma_rs(acc, ds_hi + 4 * kk, k_desc);
      wgmma_rs(acc, ds_lo + 4 * kk, k_desc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = row0 + 8 * frag_row(i);
    if (row < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (q_base + row) * D + frag_col(i, lane)) =
          __floats2bfloat162_rn(acc[i] * sm_scale, acc[i + 1] * sm_scale);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Hkv, int Sq, int Sk,
                      int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  // A map cuTensorMapEncodeTiled refuses (an unaligned base) is an
  // invalid value.
  if (!encode_tile_map(&q_map, q, D, Sq, B * H, kBlockM)
      || !encode_tile_map(&do_map, dout, D, Sq, B * H, kBlockM)
      || !encode_tile_map(&k_map, k, D, Sk, B * Hkv, kBlockN)
      || !encode_tile_map(&v_map, v, D, Sk, B * Hkv, kBlockN)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = dq_grid(B, H, Sq);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, di, static_cast<__nv_bfloat16*>(dq),
      H, Hkv, Sq, Sk, causal, sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

}  // namespace sm90

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tf32 kernels read and write 16 bytes at a time and stage up to
// 199 KB of shared memory (above the 48 KB default, hence the attribute).
template <typename T, int D>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* di, void* dk, void* dv,
                            float* partials, int* counters, int B, int H,
                            int Hkv, int Sq, int Sk, int causal,
                            float sm_scale, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout)
      || !aligned16(dk) || !aligned16(dv)
      || (H > Hkv && (partials == nullptr || !aligned16(partials)
                      || counters == nullptr))) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = tf32::dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = tf32::blocks(B, H, Sk);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dkv_tf32_kernel<T, D>
      <<<static_cast<int>(blocks), tf32::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
          static_cast<T*>(dk), static_cast<T*>(dv), partials, counters, B, H,
          Hkv, Sq, Sk, causal, sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* di, void* dq, int B, int H, int Hkv,
                           int Sq, int Sk, int causal, float sm_scale,
                           cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout)
      || !aligned16(dq)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = tf32::dq_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = tf32::blocks(B, H, Sq);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_tf32_kernel<T, D>
      <<<static_cast<int>(blocks), tf32::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
          static_cast<T*>(dq), B, H, Hkv, Sq, Sk, causal, sm_scale * kLog2e,
          sm_scale);
  return cudaGetLastError();
}

// Each kernel's design is fixed per (dtype, D) when the library is
// compiled.
template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, float* partials, int* counters,
                       int B, int H, int Hkv, int Sq, int Sk, int causal,
                       float sm_scale, cudaStream_t stream) {
  if constexpr (sm90::kTakesWgmma<T, D>) {
    return sm90::launch_dkv<D>(q, k, v, dout, lse, di, dk, dv, B, H, Hkv, Sq,
                               Sk, causal, sm_scale, stream);
  } else {
    return launch_dkv_tf32<T, D>(q, k, v, dout, lse, di, dk, dv, partials,
                                 counters, B, H, Hkv, Sq, Sk, causal,
                                 sm_scale, stream);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Hkv, int Sq, int Sk,
                      int causal, float sm_scale, cudaStream_t stream) {
  if constexpr (sm90::kTakesWgmma<T, D>) {
    return sm90::launch_dq<D>(q, k, v, dout, lse, di, dq, B, H, Hkv, Sq, Sk,
                              causal, sm_scale, stream);
  } else {
    return launch_dq_tf32<T, D>(q, k, v, dout, lse, di, dq, B, H, Hkv, Sq,
                                Sk, causal, sm_scale, stream);
  }
}

// The blocks each launcher's grid holds.
long long grid_size(dim3 grid) {
  return static_cast<long long>(grid.x) * grid.y * grid.z;
}

template <typename T, int D>
long long dkv_blocks(int B, int H, int Hkv, int Sk) {
  if constexpr (sm90::kTakesWgmma<T, D>) {
    return grid_size(sm90::dkv_grid(B, Hkv, Sk));
  } else {
    return tf32::blocks(B, H, Sk);
  }
}

template <typename T, int D>
long long dq_blocks(int B, int H, int Sq) {
  if constexpr (sm90::kTakesWgmma<T, D>) {
    return grid_size(sm90::dq_grid(B, H, Sq));
  } else {
    return tf32::blocks(B, H, Sq);
  }
}

bool valid_shape(int B, int H, int Hkv, int Sq, int Sk) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 1 && Sk >= 1;
}

// Design codes of the _design queries.
constexpr int kDesignWgmma = 1;
constexpr int kDesignTf32 = 2;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 =
// launched). partials and counters: the scratch that
// flash_attention_bwd_dkv_scratch asks for (null where it asks for none).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, void* partials,
                                       void* counters, int B, int H, int Hkv,
                                       int Sq, int Sk, int D, int dtype,
                                       int causal, float sm_scale,
                                       void* stream) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_dkv<T, decltype(dim)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(di), dk, dv, static_cast<float*>(partials),
        static_cast<int*>(counters), B, H, Hkv, Sq, Sk, causal, sm_scale,
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int Hkv,
                                      int Sq, int Sk, int D, int dtype,
                                      int causal, float sm_scale,
                                      void* stream) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_dq<T, decltype(dim)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(di), dq, B, H, Hkv, Sq, Sk, causal,
        sm_scale, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

// The scratch a dK/dV launch takes: f32 partials (each query head's dK and
// dV) and int ticket counters, both 0 where the instance's design or a
// group of 1 needs none; the counters must be 0 before the launch (it
// leaves them 0).
extern "C" int flash_attention_bwd_dkv_scratch(int B, int H, int Hkv,
                                               int Sk, int D, int dtype,
                                               long long* partial_floats,
                                               long long* counters) {
  if (!valid_shape(B, H, Hkv, 1, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    const bool partial = !sm90::kTakesWgmma<T, decltype(dim)::value>
                         && H > Hkv;
    *partial_floats = partial ? 2LL * B * H * Sk * D : 0;
    // a counter per (key tile, KV head, batch)
    *counters = partial ? tf32::blocks(B, Hkv, Sk) : 0;
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

// The design the (dtype, D) instance of each kernel takes (1 = sm90 wgmma,
// 2 = 3xTF32 mma.sync) and its dynamic shared memory in bytes; a
// cudaError_t for an instance that is not built.
extern "C" int flash_attention_bwd_dkv_design(int D, int dtype, int* design,
                                              int* smem_bytes) {
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int kD = decltype(dim)::value;
    if constexpr (sm90::kTakesWgmma<T, kD>) {
      *design = kDesignWgmma;
      *smem_bytes = sm90::dkv_smem_bytes<kD>();
    } else {
      *design = kDesignTf32;
      *smem_bytes = tf32::dkv_smem_bytes<T, kD>();
    }
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dq_design(int D, int dtype, int* design,
                                             int* smem_bytes) {
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int kD = decltype(dim)::value;
    if constexpr (sm90::kTakesWgmma<T, kD>) {
      *design = kDesignWgmma;
      *smem_bytes = sm90::dq_smem_bytes<kD>();
    } else {
      *design = kDesignTf32;
      *smem_bytes = tf32::dq_smem_bytes<T, kD>();
    }
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

// The blocks a launch of each kernel at (B, H, Hkv, Sq, Sk) runs, from the
// grid its launcher takes; a cudaError_t for an instance that is not built
// or a shape the launch refuses.
extern "C" int flash_attention_bwd_dkv_blocks(int B, int H, int Hkv, int Sq,
                                              int Sk, int D, int dtype,
                                              long long* blocks) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    *blocks = dkv_blocks<T, decltype(dim)::value>(B, H, Hkv, Sk);
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dq_blocks(int B, int H, int Hkv, int Sq,
                                             int Sk, int D, int dtype,
                                             long long* blocks) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    *blocks = dq_blocks<T, decltype(dim)::value>(B, H, Sq);
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

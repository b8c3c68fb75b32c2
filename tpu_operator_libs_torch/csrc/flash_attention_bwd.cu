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
// TFLOP/s for bf16 inputs (67 TFLOP/s f32), against Q, K, V, dO, lse and di
// read and the gradients written once at 3.35 TB/s: the FLOPs bound both.
//
// Both kernels take one of two designs, chosen by (dtype, head_dim) at
// compile time (sm90::kTakesWgmma): bf16 at D = 64 and 128 runs every
// product on the tensor cores (wgmma) over tiles that a producer stages
// by TMA (flash_attention_sm90.cuh); f32 at every D, and bf16 at
// D = 16 and 32, keep the scalar design, f32 FMAs on the CUDA cores, which
// holds the f32 kernels to 2e-5 (TF32 products would not).
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
// - otherwise flash_bwd_dkv_kernel: the scalar design on the forward's
//   layout (flash_attention_common.cuh): 256 threads, four per row, each
//   row's vectors split in float4 chunks over its four threads, dot
//   products finished by an xor shuffle. One block per (64-key tile, KV
//   head, batch) holds its keys' K and V rows and the dK and dV
//   accumulators in registers and walks the group's query heads and tiles
//   as above, staging Q, dO, lse and di in shared memory as f32.
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
// - otherwise flash_bwd_dq_kernel: the scalar design, one block per
//   (64-query tile, head, batch) holding its rows' Q, dO and dQ in
//   registers with lse and di, walking the K/V tiles up to the diagonal,
//   staged in shared memory as f32.
// Every sum runs in a fixed order and nothing is accumulated across blocks,
// so two launches on the same inputs give bit-equal results.
// What the wgmma designs leave on the table: each warpgroup waits on its
// first two products before the elementwise work and on the second
// products before the next tile (the two warpgroups overlap only each
// other); the second products run twice (hi and lo), 1.5x the function's
// tensor-core work for dK/dV and 1.33x for dQ; dK/dV's grid is
// (S / 128, H_kv, B), which leaves SMs idle where H_kv * B is small (32
// blocks at (2, 8 / 2, 1000)), and splitting the group across blocks would
// need a reduction across them; the gradients are stored from registers
// rather than through shared memory by TMA.
#include <math.h>

#include "flash_attention_common.cuh"
#include "flash_attention_sm90.cuh"

namespace {

// q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); lse, di: (B, H, Sq) f32;
// dk, dv: (B, Hkv, Sk, D). scale_log2 = sm_scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                     int causal, float scale_log2, float sm_scale) {
  constexpr int kVecs = D / 4;                  // float4 per row
  constexpr int kChunks = kVecs / kRowThreads;  // float4 per thread
  extern __shared__ float4 smem[];
  float4* q_tile = smem;                        // [kBlockM][kVecs]
  float4* do_tile = smem + kBlockM * kVecs;     // [kBlockM][kVecs]
  __shared__ float lse_tile[kBlockM];           // lse * log2(e)
  __shared__ float di_tile[kBlockM];

  const int tile = blockIdx.x;  // the first key tiles see the most queries
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int row = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  const int kj = tile * kBlockN + row;
  const bool key_valid = kj < Sk;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk;

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kRowThreads * i;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vx = kx;
    if (key_valid) {
      kx = load4(k + (kv_base + kj) * D + 4 * c);
      vx = load4(v + (kv_base + kj) * D + 4 * c);
    }
    kr[i] = scale4(kx, scale_log2);
    vr[i] = vx;
    dk_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[i] = dk_acc[i];
  }

  // Query i sees key j iff j <= i: the query tiles before the one holding
  // this tile's first key see none of its keys.
  const int q_first = causal ? (tile * kBlockN) / kBlockM : 0;
  const int n_qtiles = (Sq + kBlockM - 1) / kBlockM;

  for (int hh = 0; hh < group; ++hh) {
    const size_t q_base = (static_cast<size_t>(b) * H + hk * group + hh) * Sq;
    for (int t = q_first; t < n_qtiles; ++t) {
      const int q0 = t * kBlockM;
      __syncthreads();  // every thread is done with the previous tile
      for (int e = threadIdx.x; e < kBlockM * kVecs; e += kThreads) {
        const int r = e / kVecs;
        const int c = e % kVecs;
        float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dx = qx;
        if (q0 + r < Sq) {
          const size_t off = (q_base + q0 + r) * D + 4 * c;
          qx = load4(q + off);
          dx = load4(dout + off);
        }
        q_tile[e] = qx;
        do_tile[e] = dx;
      }
      if (threadIdx.x < kBlockM) {
        const int qi = q0 + threadIdx.x;
        lse_tile[threadIdx.x] = qi < Sq ? lse[q_base + qi] * kLog2e : 0.f;
        di_tile[threadIdx.x] = qi < Sq ? di[q_base + qi] : 0.f;
      }
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < kBlockM; ++i) {
        const float4* q_row = q_tile + i * kVecs + sub;
        const float4* do_row = do_tile + i * kVecs + sub;
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          s = dot4(kr[c], q_row[kRowThreads * c], s);
          dp = dot4(vr[c], do_row[kRowThreads * c], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const int qi = q0 + i;
        const bool visible = key_valid && qi < Sq && (!causal || kj <= qi);
        const float p = visible ? exp2f(s - lse_tile[i]) : 0.f;
        const float ds = p * (dp - di_tile[i]);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          dv_acc[c] = axpy4(p, do_row[kRowThreads * c], dv_acc[c]);
          dk_acc[c] = axpy4(ds, q_row[kRowThreads * c], dk_acc[c]);
        }
      }
    }
  }

  if (!key_valid) return;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const size_t off = (kv_base + kj) * D + 4 * (sub + kRowThreads * i);
    store4(dk + off, scale4(dk_acc[i], sm_scale));
    store4(dv + off, dv_acc[i]);
  }
}

// dq: (B, H, Sq, D); the other arguments as for the dK/dV kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int Hkv, int Sq, int Sk, int causal, float scale_log2,
                    float sm_scale) {
  constexpr int kVecs = D / 4;
  constexpr int kChunks = kVecs / kRowThreads;
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

  float4 qr[kChunks], dor[kChunks], acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kRowThreads * i;
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dx = qx;
    if (row_valid) {
      qx = load4(q + (q_base + qi) * D + 4 * c);
      dx = load4(dout + (q_base + qi) * D + 4 * c);
    }
    qr[i] = scale4(qx, scale_log2);
    dor[i] = dx;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse2 = row_valid ? lse[q_base + qi] * kLog2e : 0.f;
  const float di_row = row_valid ? di[q_base + qi] : 0.f;

  // Keys past the tile's last query row are masked for every row of it.
  const int kv_end = causal ? min(Sk, (tile + 1) * kBlockM) : Sk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();
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

#pragma unroll 2
    for (int j = 0; j < kBlockN; ++j) {
      const float4* k_row = k_tile + j * kVecs + sub;
      const float4* v_row = v_tile + j * kVecs + sub;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        s = dot4(qr[c], k_row[kRowThreads * c], s);
        dp = dot4(dor[c], v_row[kRowThreads * c], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int kj = k0 + j;
      const bool visible = row_valid && kj < Sk && (!causal || kj <= qi);
      const float p = visible ? exp2f(s - lse2) : 0.f;
      const float ds = p * (dp - di_row);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        acc[c] = axpy4(ds, k_row[kRowThreads * c], acc[c]);
      }
    }
  }

  if (!row_valid) return;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    store4(dq + (q_base + qi) * D + 4 * (sub + kRowThreads * i),
           scale4(acc[i], sm_scale));
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
  const dim3 grid((Sk + kKeyTile - 1) / kKeyTile, Hkv, B);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Sk, causal,
      sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
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
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, di, static_cast<__nv_bfloat16*>(dq),
      H, Hkv, Sq, Sk, causal, sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

}  // namespace sm90

// Both scalar kernels stage two 64-row tiles of f32 (64 KB at D = 128,
// above the 48 KB default, hence the attribute).
template <typename T, int D>
cudaError_t launch_dkv_scalar(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* di, void* dk, void* dv, int B,
                              int H, int Hkv, int Sq, int Sk, int causal,
                              float sm_scale, cudaStream_t stream) {
  const int smem = 2 * kBlockM * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBlockN - 1) / kBlockN, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Sk, causal,
      sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_scalar(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dq, int B, int H,
                             int Hkv, int Sq, int Sk, int causal,
                             float sm_scale, cudaStream_t stream) {
  const int smem = 2 * kBlockN * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), H, Hkv, Sq, Sk, causal, sm_scale * kLog2e,
      sm_scale);
  return cudaGetLastError();
}

// Each kernel's design is fixed per (dtype, D) when the library is
// compiled.
template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, int causal, float sm_scale,
                       cudaStream_t stream) {
  if constexpr (sm90::kTakesWgmma<T, D>) {
    return sm90::launch_dkv<D>(q, k, v, dout, lse, di, dk, dv, B, H, Hkv, Sq,
                               Sk, causal, sm_scale, stream);
  } else {
    return launch_dkv_scalar<T, D>(q, k, v, dout, lse, di, dk, dv, B, H, Hkv,
                                   Sq, Sk, causal, sm_scale, stream);
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
    return launch_dq_scalar<T, D>(q, k, v, dout, lse, di, dq, B, H, Hkv, Sq,
                                  Sk, causal, sm_scale, stream);
  }
}

bool valid_shape(int B, int H, int Hkv, int Sq, int Sk) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 1 && Sk >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 =
// launched).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, int B, int H,
                                       int Hkv, int Sq, int Sk, int D,
                                       int dtype, int causal, float sm_scale,
                                       void* stream) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_dkv<T, decltype(dim)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(di), dk, dv, B, H, Hkv, Sq, Sk, causal,
        sm_scale, static_cast<cudaStream_t>(stream));
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

// The design the (dtype, D) instance of each kernel takes (1 = sm90 wgmma,
// 0 = scalar) and its dynamic shared memory in bytes; a cudaError_t for an
// instance that is not built.
extern "C" int flash_attention_bwd_dkv_design(int D, int dtype, int* design,
                                              int* smem_bytes) {
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    constexpr int kD = decltype(dim)::value;
    if constexpr (sm90::kTakesWgmma<T, kD>) {
      *design = 1;
      *smem_bytes = sm90::dkv_smem_bytes<kD>();
    } else {
      *design = 0;
      *smem_bytes = 2 * kBlockM * kD * static_cast<int>(sizeof(float));
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
      *design = 1;
      *smem_bytes = sm90::dq_smem_bytes<kD>();
    } else {
      *design = 0;
      *smem_bytes = 2 * kBlockN * kD * static_cast<int>(sizeof(float));
    }
    return cudaSuccess;
  });
  return static_cast<int>(err);
}

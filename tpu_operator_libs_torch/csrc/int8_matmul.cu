// The int8-weight matmul (W8A16): out = (x @ q) * s with int8 codes q read
// as int8 from device memory and converted on the SM.
//
// Replaces tpu_operator_libs/examples/llama_decode.py::_mm (:135-143),
// `(x @ q.astype(x.dtype)) * s.astype(x.dtype)`, which XLA fuses on the
// TPU (no Pallas source): the convert happens in the matmul's operand
// load, so device memory sees int8 bytes. x is (M, K) in float32 or
// bfloat16, q is (K, N) int8 row-major (quantize_params_int8's layout),
// s is the float32 per-output-channel scale (N,).
//
// Rounding points, those of the plain PyTorch version: the products are
// summed in f32 and rounded once to x's dtype, s is rounded to x's dtype,
// and their product is rounded again. |q| <= 127 is exact in bf16 and a
// bf16 x bf16 product is exact in f32, so every product is exact and only
// the sums round.
//
// Bound: at decode (M = batch, 2 to 16) bytes. The weight's K*N int8 bytes
// dominate `K*N + 2*M*K + 2*M*N + 4*N`; at 3.35 TB/s a (2048, 8192)
// weight takes 5.0 us. At prefill (M = 512) operations: 2*M*K*N FLOPs at
// 989 TFLOP/s on the tensor cores (4.3 us for (2048, 2048)).
//
// Four kernels; the wrapper's plan (tpu_operator_libs_torch/kernels/
// int8_matmul.py::plan, a function of the shape, x's dtype and the SM
// count alone) picks one and the C entry checks what it was given:
//
// 1. int8_matmul_wgmma_kernel<kN>, prefill: bf16 x with M >= 64,
//    N % 16 == 0 and K % 8 == 0 (TMA's 16-byte row strides), and 64-row
//    output tiles for at least a quarter of the SMs (it does not split K,
//    so with fewer the stream-K kernel 4 is faster). A persistent grid of
//    at most one block an SM walks tiles of kN rows of x by 128 columns
//    (the plan's choice from the shape: 256 rows for the chat prefill,
//    128 or 64 where the tiles are few) in a grouped raster. A
//    producer warpgroup, its registers lowered by setmaxnreg, keeps a TMA
//    ring of x and code boxes (both 128-byte swizzled) full, running into
//    the next tile while the consumers finish this one. The product runs
//    transposed, out^T = q^T x^T: two consumer warpgroups take 64
//    columns each; the codes, loaded by ldmatrix.trans, are converted to
//    bf16 in registers and are wgmma's A operand, x its B from the ring
//    (register-A wgmma, no converted tile in shared memory). Each stage's
//    four k-steps are one commit group, waited for before the stage is
//    released; the two warpgroups' groups interleave on the tensor cores.
//    The epilogue rounds as the plain version does, writes bf16 pairs to
//    a swizzled buffer and stores it by TMA.
// 2. int8_matmul_mma_kernel: bf16 x whose shape or bases TMA cannot take
//    (N % 16 != 0, K % 8 != 0, or a view from an unaligned offset). 256
//    threads own 128 columns and 8 rows of x (32 above 8 rows, each
//    converted code then serving 4 mma), and run the product
//    transposed on the tensor cores, out^T = q^T x^T with mma.sync
//    m16n8k16: the weight is the A operand, so a decode batch of up to 8
//    rows fills the instruction's n. The block's slice of K streams
//    through a ring of kRing shared-memory stages of 128 rows of codes
//    (16 KB, swizzled) and the matching x columns, filled by 16-byte
//    cp.async (bytewise synchronous loads where rows are not 16-byte
//    aligned), so kRing - 1 stages are in flight
//    while one is multiplied; each warp converts its 16 rows of a stage
//    to bf16 in registers, in the A fragment's order. (f32 FMAs on the CUDA
//    cores over the same ring, as kernel 3 runs them, were slower at
//    decode on an H100: the FMAs, and the 32-way block reduction they
//    need, cost more than the loads.)
// 3. int8_matmul_kernel: f32 x (which TF32 products would not hold to its
//    limit), on the CUDA cores: 256 threads, each 16 neighbouring columns
//    by up to 8 rows of x (kM) for 2 of every 64 rows of K, over a ring
//    of 64-row stages; codes become f32 by a byte permute and one add
//    (exact).
// 4. int8_matmul_streamk_kernel, decode: the rest of bf16 x (decode and
//    short prefill with TMA's alignment). A persistent grid of at most one
//    block an SM cuts the product's (tile, stage) units into equal
//    contiguous runs, one a block, so every SM streams the same weight
//    bytes to within one 16 KB stage; where the tiles are few, the grid
//    is a multiple of them and every run lies in one tile (the plan's
//    choice). A tile is 8, 16 or 32 rows of x (the fewest that hold M) by
//    128 columns, or 256 where the 128-column grid does not fill the card
//    (a stage then reads each row of K 256 contiguous bytes at a time). A
//    producer warp keeps 4 stages of code boxes and x boxes in flight by
//    TMA into a full/empty mbarrier ring; 8 consumer warps each own 16
//    columns of every code box and all of K, so each holds whole sums and
//    none waits for another. The product runs on mma.sync m16n8k16 with
//    the weight as A, as in kernel 2, its fragments loaded by ldmatrix
//    (.trans for the codes) from 128-byte-swizzled boxes.
//
// Codes become bf16 (kernels 1, 2 and 4) two at a time and exactly: 128 plus
// a code's low 7 bits, less 128 plus 128 times its sign bit, both made by
// masks under the exponent of 128, in one bf16x2 subtract.
//
// Kernels 2 and 3 split K over blocks when the output has too few tiles
// for the card (the plan fills one wave, at most kMaxSplits), in one
// launch; kernel 4 adds the blocks' sums of a tile cut between them in
// block order, after one ticket a (tile, warp) (see its kernel). No float
// atomics: each block sums its warps in a fixed order
// (through the ring's memory, reused), each split writes its f32 sums to
// a workspace and, after the block's barrier, one thread fences and takes
// a ticket from the tile's counter; the block that draws the last ticket
// adds the splits in split order 0..S-1 (all its loads in flight at
// once), applies the epilogue and puts the counter back to 0. The
// order of every sum is fixed by the shape, so two launches, and the
// host-driven and graph-replayed decode loops, are bit-equal.
//
// What is left on the table: kernel 1 (on an H100 with 256-row tiles,
// 0.049 ms for (1024, 4096, 4096) against a 0.035 ms bound, 0.214 ms for
// (4096, 4096, 4096) against 0.139, 5.04 ms for the (4096, 4096, 102400)
// head against 3.47: 65-73% of the tensor cores' peak, about cuBLAS's on
// a bf16 copy of the weight) waits for each stage's group before it
// loads and converts the next stage's codes, so only the other
// warpgroup's group keeps the tensor cores busy meanwhile: 128 sums a
// thread leave no registers for a second group in flight (ptxas then
// serialises the wgmma). Both warpgroups drain at each tile's epilogue,
// and the tiles fill their last wave only in part (at (1024, 4096, 11008)
// 344 tiles on 132 SMs: 87% of three waves). A cluster of two blocks sharing x by TMA multicast was no
// faster at the chat prefill's shapes and slower at small ones. Kernel 4 (on an H100 at the served DeepSeek-7B's 16 rows:
// 12.6 us for (4096, 4096) against a 5.09 us bound, 23.9 us for (4096,
// 11008) and 24.9 us for (11008, 4096) against 13.6, 163 us for the
// (4096, 102400) head against 126) pays a fixed cost a launch: ~1.6 us
// of launch and grid, the ramp before the first stage lands, and, for a
// cut tile, a ticket's round trip and a read of every block's sums at the
// end (2.1-3.3 us at these shapes; an acq_rel atomic, no fence); its
// stream alone runs at 62-85% of the memory rate, launch included. Launching it with
// programmatic dependent launch, so that its ramp overlaps the kernel
// before, and fewer products a step (q, k, v and gate, up as one) are
// what is left. Kernels 2 and 3 pay the same fixup (a fence, an atomic
// and a read of every split's sums).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"
#include "ticket.cuh"

namespace {

// ---- shared by the kernels

// round(round(acc) * round(s)) in x's dtype: the plain version's order
__device__ __forceinline__ float epilogue(float acc, float s, float*) {
  return __fmul_rn(acc, s);
}
__device__ __forceinline__ __nv_bfloat16 epilogue(float acc, float s,
                                                  __nv_bfloat16*) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  const float b = __bfloat162float(__float2bfloat16_rn(s));
  return __float2bfloat16_rn(__fmul_rn(a, b));
}

// Code b (0..3) of the word w as an exact f32: the byte, offset by 128, is
// placed under the exponent of 2^23, and 2^23 + 128 is taken off again.
__device__ __forceinline__ float code_to_float(uint32_t biased, int b) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | b))
         - 8388736.f;
}

// The four codes of a word as f32, in byte order.
__device__ __forceinline__ void word_to_floats(uint32_t w, float* f) {
  const uint32_t biased = w ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = code_to_float(biased, b);
}

// The codes in bytes 0 and 2 of w (bytes 1 and 3 are ignored) as an exact
// bf16x2, byte 0 in the lower half: 128 plus a code's low 7 bits (under
// the exponent of 128), less 128 plus 128 times its sign bit. Both terms,
// and their difference, the code, are exact in bf16: one bf16x2 subtract.
__device__ __forceinline__ uint32_t code_pair_to_bf16x2(uint32_t w) {
  const uint32_t top = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t sign = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&top),
              *reinterpret_cast<const __nv_bfloat162*>(&sign));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_addr(p)) : "memory");
}

// The A fragments of two k-steps of 16 from one ldmatrix.x4.trans of 32
// rows of K by 16 codes (c): lane (g, t) holds the codes of columns 2g and
// 2g + 1 at rows 2t, 2t + 1 (c[0], c[2] the first 8 rows of each k-step,
// c[1], c[3] the next 8), which are A's rows g (bytes 0 and 2) and g + 8
// (bytes 1 and 3): A's row g is column 2g of the 16, row g + 8 column
// 2g + 1.
__device__ __forceinline__ void codes_to_a(const uint32_t (&c)[4], int step,
                                           uint32_t (&a)[4]) {
  const uint32_t lo = c[2 * step];
  const uint32_t hi = c[2 * step + 1];
  a[0] = code_pair_to_bf16x2(lo);
  a[1] = code_pair_to_bf16x2(lo >> 8);
  a[2] = code_pair_to_bf16x2(hi);
  a[3] = code_pair_to_bf16x2(hi >> 8);
}

// ---- kernel 1: bf16 prefill, a persistent warp-specialised wgmma GEMM

namespace wg {

using namespace sm90;

// Two consumer warpgroups and a producer warpgroup, whose first thread
// issues every TMA load. At launch a thread of a 384-thread block has at
// most 168 registers; the producer gives registers up and the consumers
// take them (setmaxnreg), within the block's 3 * 168 a lane: 40 for the
// producer's walk over the raster, 232 for a consumer's sums and operands.
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
static_assert(2 * kConsumerRegs + kProducerRegs <= 3 * 168,
              "setmaxnreg would wait for registers the block does not have");
constexpr int kBlockK = 64;     // rows of K a stage: one swizzled x box
constexpr int kCodeBox = 128;   // columns of a code box, one 128-byte row
constexpr int kCodeBoxBytes = kBlockK * kCodeBox;  // 8 KB
constexpr int kGroupM = 8;      // row tiles a raster group
constexpr int kMaxStages = 8;
// shared memory a block may take on an H100, less the barriers' room
constexpr int kSmemLimit = 232448 - 256;

// A tile is kN rows of x (wgmma's n) by 128 output columns: each
// warpgroup owns 64 columns (wgmma's m), kN / 2 f32 sums a thread. A
// stage holds 64 rows of K: the x box (64 columns of K by kN rows) and the
// code box (128 columns by 64 rows of K), both 128-byte swizzled; the
// epilogue's buffer holds each warpgroup's 64 columns by kN rows of bf16
// output, as the output's boxes.
template <int kN>
struct Tile {
  static constexpr int kXBytes = kN * 128;
  static constexpr int kStageBytes = kXBytes + kCodeBoxBytes;
  static constexpr int kOutBoxBytes = kN * 128;
  static constexpr int kEpiBytes = 2 * kOutBoxBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - kEpiBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // from a 1024-byte boundary: the launch asks for 1024 bytes more
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kEpiBytes;
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// The order in which a block's tiles are taken: tile u of the grouped
// raster lies in row tile first + r % rows and column tile r / rows, where
// groups of kGroupM row tiles (fewer in the last group) are walked column
// tile by column tile, so that the tiles the card runs at once share x's
// rows and the codes' columns in L2. Block b takes tiles b, b + grid, ...
// tpu_operator_libs_torch/kernels/int8_matmul.py::wgmma_raster mirrors it.
struct Raster {
  int m_tiles, n_tiles;
  __device__ __forceinline__ void tile(int u, int& mt, int& nt) const {
    const int per_group = kGroupM * n_tiles;
    const int group = u / per_group;
    const int first = group * kGroupM;
    const int rows = min(m_tiles - first, kGroupM);
    const int r = u - group * per_group;
    mt = first + r % rows;
    nt = r / rows;
  }
};

// The persistent grid: at most one block an SM, each walking its tiles in
// the raster's order. x_map: x as (1, M, K) bf16, boxes of 64 columns x kN
// rows; q_map: q as (K, N) uint8, boxes of 128 columns x 64 rows; out_map:
// out as (1, M, N) bf16, boxes of 64 columns x kN rows; all 128-byte
// swizzled. Rows of x past M and of q past K, and columns of q past N, read
// as zeros; outputs past M or N are not written.
//
// The producer's first thread loads each stage's x box and code box into
// a ring of kStages stages with full/empty mbarriers, running ahead into
// the block's next tile while the consumers finish this one.
//
// The product runs transposed, out^T = q^T x^T: the codes are wgmma's A
// operand from registers and x its B, K-major from the ring. Warp w of
// warpgroup g takes columns [64 g + 16 w, + 16) of the tile, loads their
// 64 rows of K by two ldmatrix.x4.trans from the stage and converts them
// to bf16 in registers (codes_to_a); its A rows g and g + 8 are columns 2g
// and 2g + 1 of the 16. A stage's four k-steps are one commit group,
// waited for inside the iteration before the stage is released: a wait
// across the loop's back edge, or registers of an in-flight product
// written, makes ptxas serialise the wgmma. While one warpgroup waits and
// converts, the other's group runs. The sums stay f32 in registers, added
// k-step by k-step in order: their order is fixed by the shape.
//
// Epilogue: the sums, rounded as the plain version rounds them (epilogue),
// go as bf16 pairs (columns 2g, 2g + 1 of a row of x) into the warpgroup's
// swizzled output box, and its first thread stores it by TMA while the
// warpgroup starts the next tile; it waits for that store to have read the
// buffer before the buffer is written again.
template <int kN>
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap out_map,
                             const float* __restrict__ s, int M, int K,
                             int N, Raster raster) {
  using T = Tile<kN>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);  // [kStages][x box, code box]
  uint8_t* epi = ring + kStages * T::kStageBytes;  // [warpgroup]
  __shared__ uint64_t full[kStages], empty[kStages];

  const int tiles = raster.m_tiles * raster.n_tiles;
  const int steps = (K + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    prefetch_map(&x_map);
    prefetch_map(&q_map);
    prefetch_map(&out_map);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      int it = 0;
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        int mt, nt;
        raster.tile(u, mt, nt);
        for (int t = 0; t < steps; ++t, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          uint8_t* stage = ring + st * T::kStageBytes;
          mbar_expect_tx(&full[st], T::kStageBytes);
          tma_load(stage, &x_map, &full[st], t * kBlockK, mt * kN, 0);
          tma_load_2d(stage + T::kXBytes, &q_map, &full[st], nt * kCodeBox,
                      t * kBlockK);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wgi = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int chunk = 4 * wgi + warp;  // this warp's 16 columns of the box
  uint8_t* my_epi = epi + wgi * T::kOutBoxBytes;

  float acc[kN / 2];
  int it = 0;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    int mt, nt;
    raster.tile(u, mt, nt);
    for (int t = 0; t < steps; ++t, ++it) {
      const int st = it % kStages;
      const uint8_t* stage = ring + st * T::kStageBytes;
      mbar_wait(&full[st], (it / kStages) & 1);
      // this warp's columns, rows 0-31 and 32-63 of K, as four k-steps' A
      uint32_t a[4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * h + lane;
        uint32_t c[4];
        ldmatrix_x4_trans(c, stage + T::kXBytes + row * 128
                                 + ((chunk ^ (row & 7)) << 4));
        codes_to_a(c, 0, a[2 * h]);
        codes_to_a(c, 1, a[2 * h + 1]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wgmma_rs_k(acc, a[kk], desc_k_major(stage, kN, kk), t > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // the last tile's store has read the buffer
    if (threadIdx.x % 128 == 0) bulk_wait_read();
    named_barrier_sync(1 + wgi, 128);
    __nv_bfloat16* tag = nullptr;
    const int col = nt * kCodeBox + 64 * wgi + 16 * warp + 2 * g;
    // N % 16 == 0: col + 1 < N too; columns past N are not stored
    const float s0 = col < N ? s[col] : 0.f;
    const float s1 = col < N ? s[col + 1] : 0.f;
    const int out_chunk = 2 * warp + (g >> 2);
#pragma unroll
    for (int i = 0; i < kN / 2; i += 4) {
      // acc[i], acc[i + 2]: row 2t of the 8 at i / 4, columns 2g and
      // 2g + 1; acc[i + 1], acc[i + 3]: the next row
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 2 * i + 2 * t4 + e;
        __nv_bfloat162 v;
        v.x = epilogue(acc[i + e], s0, tag);
        v.y = epilogue(acc[i + 2 + e], s1, tag);
        *reinterpret_cast<__nv_bfloat162*>(
            my_epi + row * 128 + ((out_chunk ^ (row & 7)) << 4)
            + 4 * (g & 3)) = v;
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wgi, 128);
    if (threadIdx.x % 128 == 0) {
      const int c0 = nt * kCodeBox + 64 * wgi;
      if (c0 < N) tma_store(&out_map, my_epi, c0, mt * kN, 0);
      bulk_commit();
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait_all();
}

// q as a 2-D uint8 map (N columns, K rows), boxes of 128 columns x box_k
// rows, 128-byte swizzled.
inline bool encode_codes_map(CUtensorMap* map, const void* q, int K, int N,
                             int box_k) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {kCodeBox, static_cast<cuuint32_t>(box_k)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kN>
cudaError_t launch_tile(const void* x, const void* q, const float* s,
                        void* out, int M, int K, int N, int blocks,
                        cudaStream_t stream) {
  using T = Tile<kN>;
  CUtensorMap x_map, q_map, out_map;
  // a map cuTensorMapEncodeTiled refuses (a base not 16-byte aligned) is
  // an invalid value
  if (!encode_tile_map(&x_map, x, K, M, 1, kN)
      || !encode_codes_map(&q_map, q, K, N, kBlockK)
      || !encode_tile_map(&out_map, out, N, M, 1, kN)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_wgmma_kernel<kN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const Raster raster{(M + kN - 1) / kN, (N + kCodeBox - 1) / kCodeBox};
  int8_matmul_wgmma_kernel<kN><<<blocks, kThreads, T::kSmemBytes, stream>>>(
      x_map, q_map, out_map, s, M, K, N, raster);
  return cudaGetLastError();
}

// block_m rows of x a tile: 64, 128 or 256 (by 128 columns)
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   int M, int K, int N, int block_m, int blocks,
                   cudaStream_t stream) {
  switch (block_m) {
    case 64: return launch_tile<64>(x, q, s, out, M, K, N, blocks, stream);
    case 128: return launch_tile<128>(x, q, s, out, M, K, N, blocks, stream);
    case 256: return launch_tile<256>(x, q, s, out, M, K, N, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace wg

// ---- kernels 2 and 3: one launch, a cp.async ring, split-K with an
// in-kernel fixup

constexpr int kBlockN = 128;     // output columns a block
constexpr int kChunkK = 64;      // the plan's unit of K (k_per_split)
constexpr int kMaxSplits = 16;

// 16 bytes from global to shared memory; src_bytes < 16 fills the rest
// with zeros (0: no read at all)
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sm90::smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [kc, kc + kStageK) of K into a ring stage: the codes of the
// block's 128 columns, 128 bytes a row, 16-byte segment c of row r at
// segment c ^ swizzle(r); and x's rows [m0, m0 + kRows) at those rows of
// K, xs[m][r] with rows kXStride elements apart. Rows past k_end, rows of
// x past M and columns past N are zeros. Codes by 16-byte cp.async where
// every row is 16-byte aligned (kAligned; thread i stages the same places
// of every stage), else by bytewise synchronous loads; x by 16-byte
// cp.async where x_vec, else elementwise.
template <typename T, int kStageK, int kRows, int kXStride, int kThreadsN,
          bool kAligned, typename Swizzle>
__device__ __forceinline__ void stage_chunk(uint8_t* codes, T* xs,
                                            const T* __restrict__ x,
                                            const int8_t* __restrict__ q,
                                            int kc, int k_end, int n_base,
                                            int m0, int M, int K, int N,
                                            bool x_vec, Swizzle swizzle) {
  constexpr int kSegs = kStageK * kBlockN / 16;
  static_assert(kSegs % kThreadsN == 0, "whole segments a thread");
#pragma unroll
  for (int j = 0; j < kSegs / kThreadsN; ++j) {
    const int i = threadIdx.x + j * kThreadsN;
    const int r = i / (kBlockN / 16);
    const int c = i % (kBlockN / 16);
    const long long row = kc + r;
    const int col = n_base + c * 16;
    uint8_t* dst = codes + r * kBlockN + (c ^ swizzle(r)) * 16;
    if (kAligned) {
      const bool ok = row < k_end && col < N;
      cp_async(dst, ok ? q + row * N + col : q, ok ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (row < k_end) {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (col + b < N) {
            w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             __ldg(q + row * N + col + b)))
                         << (8 * (b & 3));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // x a segment
  for (int i = threadIdx.x; i < kRows * kStageK / kPer; i += kThreadsN) {
    const int m = i / (kStageK / kPer);
    const int c = (i % (kStageK / kPer)) * kPer;
    const long long at = static_cast<long long>(m0 + m) * K + kc + c;
    T* dst = xs + m * kXStride + c;
    if (x_vec) {
      const bool ok = m0 + m < M && kc + c < k_end;
      cp_async(dst, ok ? x + at : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int b = 0; b < kPer; ++b) {
        dst[b] = (m0 + m < M && kc + c + b < k_end) ? x[at + b] : T(0.f);
      }
    }
  }
}

// Four outputs of a row from their f32 sums and scales, rounded as the
// plain version rounds them (out 8- or 16-byte aligned).
__device__ __forceinline__ void store4(float* out, float4 v, float4 s) {
  *reinterpret_cast<float4*>(out) =
      make_float4(epilogue(v.x, s.x, out), epilogue(v.y, s.y, out),
                  epilogue(v.z, s.z, out), epilogue(v.w, s.w, out));
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v,
                                       float4 s) {
  __nv_bfloat162 a, b;
  a.x = epilogue(v.x, s.x, out);
  a.y = epilogue(v.y, s.y, out);
  b.x = epilogue(v.z, s.z, out);
  b.y = epilogue(v.w, s.w, out);
  uint2 bits;
  bits.x = *reinterpret_cast<const uint32_t*>(&a);
  bits.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(out) = bits;
}

// The block's f32 sums of its tile, element e = m * 128 + c at
// red[e] (the warps already added in order): written with the epilogue,
// or, with K split over gridDim.y blocks, to the workspace; then the block
// that draws the tile's last ticket adds the splits in split order
// 0..S-1, writes the epilogue and puts the counter back to 0. The fences
// are thread 0's, after the block's barrier (as CUTLASS's split-K
// semaphores do); the last block's loads of the splits' sums are all in
// flight at once (eight splits at a time), from addresses clamped into
// the workspace so that no branch sits between them.
template <typename T, int kRows, int kThreadsN>
__device__ __forceinline__ void finish_tile(
    const float* red, const float* __restrict__ s, T* __restrict__ out,
    float* __restrict__ partial, int* __restrict__ counters, int m0,
    int n_base, int M, int N, int* ticket) {
  constexpr int kVecs = kRows * kBlockN / 4;  // float4s of the tile
  constexpr int kPer = (kVecs + kThreadsN - 1) / kThreadsN;
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const long long mn = static_cast<long long>(M) * N;
  // float4s of sums and scales where rows and s are 16-byte aligned
  const bool vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  if (!vec4) {  // element by element
    for (int e = tid; e < kRows * kBlockN; e += kThreadsN) {
      const int row = m0 + e / kBlockN;
      const int n = n_base + e % kBlockN;
      if (row >= M || n >= N) continue;
      const long long at = static_cast<long long>(row) * N + n;
      if (splits == 1) {
        out[at] = epilogue(red[e], s[n], out);
      } else {
        partial[split * mn + at] = red[e];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = tid + j * kThreadsN;
      const int row = m0 + v / (kBlockN / 4);
      const int n = n_base + (v % (kBlockN / 4)) * 4;
      if (v >= kVecs || row >= M || n >= N) continue;
      const long long at = static_cast<long long>(row) * N + n;
      const float4 sum = *reinterpret_cast<const float4*>(red + 4 * v);
      if (splits == 1) {
        store4(out + at, sum, *reinterpret_cast<const float4*>(s + n));
      } else {
        *reinterpret_cast<float4*>(partial + split * mn + at) = sum;
      }
    }
  }
  if (splits == 1) return;
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();  // release the block's sums
    *ticket = atomicAdd(&counters[tile], 1);
    __threadfence();  // acquire the other splits', if last
  }
  __syncthreads();
  if (*ticket != splits - 1) return;
  if (!vec4) {
    for (int e = tid; e < kRows * kBlockN; e += kThreadsN) {
      const int row = m0 + e / kBlockN;
      const int n = n_base + e % kBlockN;
      if (row >= M || n >= N) continue;
      const float* p = partial + static_cast<long long>(row) * N + n;
      float total = __ldcg(p);
      for (int i = 1; i < splits; ++i) total += __ldcg(p + i * mn);
      out[static_cast<long long>(row) * N + n] = epilogue(total, s[n], out);
    }
  } else {
    float4 total[kPer];
    for (int base = 0; base < splits; base += 8) {
      float4 v[8][kPer];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int vec = min(tid + j * kThreadsN, kVecs - 1);
          const int row = min(m0 + vec / (kBlockN / 4), M - 1);
          const int n = min(n_base + (vec % (kBlockN / 4)) * 4, N - 4);
          v[i][j] = __ldcg(reinterpret_cast<const float4*>(
              partial + min(base + i, splits - 1) * mn
              + static_cast<long long>(row) * N + n));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (base + i == 0) {
            total[j] = v[i][j];
          } else if (base + i < splits) {
            total[j].x += v[i][j].x;
            total[j].y += v[i][j].y;
            total[j].z += v[i][j].z;
            total[j].w += v[i][j].w;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int v = tid + j * kThreadsN;
      const int row = m0 + v / (kBlockN / 4);
      const int n = n_base + (v % (kBlockN / 4)) * 4;
      if (v < kVecs && row < M && n < N) {
        store4(out + static_cast<long long>(row) * N + n, total[j],
               *reinterpret_cast<const float4*>(s + n));
      }
    }
  }
  if (tid == 0) counters[tile] = 0;
}

// Whether every row of the (K, N) int8 codes is 16-byte aligned, for
// cp.async; else the codes are staged by bytewise loads.
inline bool rows_aligned(const void* q, int N) {
  return N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// ---- kernel 2: the rest of bf16, mma.sync on the tensor cores

namespace mma {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageK = 16 * kWarps;  // rows of K a ring stage: 16 a warp
constexpr int kRing = 4;              // stages
// bf16 a staged row of x: 288 bytes, so that the lanes' 8-byte loads of a
// half warp take 16 different bank pairs
constexpr int kXStride = kStageK + 16;
constexpr int kCodeBytes = kStageK * kBlockN;  // 16 KB

// A block takes kRows = 8 * kR rows of x: kR mma's n of 8 for every
// converted A fragment (8 at decode; 32 for more rows, so that a code is
// converted once for every 32 rows of x, not 8)
__host__ __device__ constexpr int x_bytes(int kR) {
  return 8 * kR * kXStride * 2;
}
// the ring, or the [kWarps][kRows][128] f32 reduction buffer that reuses
// it after the loop
__host__ __device__ constexpr int smem_bytes(int kR) {
  return kRing * (kCodeBytes + x_bytes(kR)) > kWarps * 8 * kR * kBlockN * 4
             ? kRing * (kCodeBytes + x_bytes(kR))
             : kWarps * 8 * kR * kBlockN * 4;
}

// 16-byte segment c of code row r lies at c ^ 2 * (r / 4 % 4): the four
// rows a lane group reads (4t .. 4t + 3) and the columns (16 g) of a
// quarter warp then fall in eight different bank groups.
struct Swizzle {
  __device__ __forceinline__ int operator()(int r) const {
    return 2 * ((r >> 2) & 3);
  }
};

// d += a b: m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: columns [blockIdx.x * 128, +128), rows of x [blockIdx.z *
// kRows, +kRows), rows of K [blockIdx.y * k_per_split, +k_per_split); see
// finish_tile for the split-K workspace and counters.
//
// The product runs transposed, out^T = q^T x^T, so the weight is the mma's
// A (16 columns of q a tile, as its m) and 8 rows of x its B (n = 8): a
// decode batch of up to 8 rows fills the instruction. Warp w takes rows
// [16 w, 16 w + 16) of every 128-row stage. Lane (g, t) = (lane / 4, lane
// % 4) reads rows 16 w + 4 t .. + 3 at columns [16 g, 16 g + 16) (four
// 16-byte loads) and x's rows g + 8 r at those four K (one 8-byte load
// each); both operands are permuted alike along K, so the sums are those
// of the product. Tile i's A rows g and g + 8 are columns 16 g + 2 i and
// + 1; its sums land at (rows 8 r + 2 t, + 1) x (those columns).
template <bool kAligned, int kR>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ q,
                           const float* __restrict__ s,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ partial,
                           int* __restrict__ counters, int M, int K, int N,
                           int k_per_split, bool x_vec) {
  constexpr int kRows = 8 * kR;
  constexpr int kXElems = x_bytes(kR) / 2;  // a stage's x
  extern __shared__ float4 smem[];  // 16-byte aligned
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(smem);  // [kRing][16 KB]
  __nv_bfloat16* xs_s =
      reinterpret_cast<__nv_bfloat16*>(codes_s + kRing * kCodeBytes);
  // after the loop the ring is the [kWarps][kRows][128] f32 reduction
  // buffer
  float* red = reinterpret_cast<float*>(smem);
  __shared__ int ticket;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n_base = blockIdx.x * kBlockN;
  const int m0 = blockIdx.z * kRows;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int chunks = (k_end - k_begin + kStageK - 1) / kStageK;

  float acc[kR][8][4];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][i][j] = 0.f;
    }
  }

  auto stage = [&](int c) {
    stage_chunk<__nv_bfloat16, kStageK, kRows, kXStride, kThreads, kAligned>(
        codes_s + (c % kRing) * kCodeBytes, xs_s + (c % kRing) * kXElems, x,
        q, k_begin + c * kStageK, k_end, n_base, m0, M, K, N, x_vec,
        Swizzle());
  };
  // the first kRing - 1 stages in flight; one commit group a stage (empty
  // groups past the end keep the count)
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  const int row0 = 16 * warp + 4 * t;  // this lane's 4 rows of a stage
  const int seg = (g ^ Swizzle()(row0)) * 16;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kRing - 2>();  // stage c has landed (this thread's part)
    // everyone's part of stage c, and everyone is done with stage c - 1,
    // whose buffer is refilled next
    __syncthreads();
    if (c + kRing - 1 < chunks) stage(c + kRing - 1);
    cp_async_commit();
    const uint8_t* codes = codes_s + (c % kRing) * kCodeBytes;
    uint4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = *reinterpret_cast<const uint4*>(codes + (row0 + j) * kBlockN
                                             + seg);
    }
    uint2 b[kR];
#pragma unroll
    for (int r2 = 0; r2 < kR; ++r2) {
      b[r2] = *reinterpret_cast<const uint2*>(
          xs_s + (c % kRing) * kXElems + (g + 8 * r2) * kXStride + row0);
    }
    const uint32_t w[4][4] = {{r[0].x, r[0].y, r[0].z, r[0].w},
                              {r[1].x, r[1].y, r[1].z, r[1].w},
                              {r[2].x, r[2].y, r[2].z, r[2].w},
                              {r[3].x, r[3].y, r[3].z, r[3].w}};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      // byte k of word wi of rows 4t, 4t + 1 (a0, a1) and 4t + 2, 4t + 3
      // (a2, a3) is column 4 wi + k: tile 2 wi takes bytes 0 (its row g)
      // and 1 (row g + 8), tile 2 wi + 1 bytes 2 and 3
      const auto pair = [&](int row, uint32_t sel) {
        return code_pair_to_bf16x2(
            __byte_perm(w[row][wi], w[row + 1][wi], sel));
      };
      const uint32_t a_even[4] = {pair(0, 0x4400u), pair(0, 0x5511u),
                                  pair(2, 0x4400u), pair(2, 0x5511u)};
      const uint32_t a_odd[4] = {pair(0, 0x6622u), pair(0, 0x7733u),
                                 pair(2, 0x6622u), pair(2, 0x7733u)};
#pragma unroll
      for (int r2 = 0; r2 < kR; ++r2) {
        mma_bf16(acc[r2][2 * wi], a_even, b[r2].x, b[r2].y);
        mma_bf16(acc[r2][2 * wi + 1], a_odd, b[r2].x, b[r2].y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes `red`

  // tile i of rows 8r..: (row 8r + 2t, column 16g + 2i) = acc[r][i][0],
  // (8r + 2t + 1, same) = acc[r][i][1], the next column acc[r][i][2], [3]
  float* mine = red + warp * kRows * kBlockN;
#pragma unroll
  for (int r2 = 0; r2 < kR; ++r2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 16 * g + 2 * i;
      const int row = 8 * r2 + 2 * t;
      *reinterpret_cast<float2*>(mine + row * kBlockN + col) =
          make_float2(acc[r2][i][0], acc[r2][i][2]);
      *reinterpret_cast<float2*>(mine + (row + 1) * kBlockN + col) =
          make_float2(acc[r2][i][1], acc[r2][i][3]);
    }
  }
  __syncthreads();
  // the warps in order, into warp 0's place
  for (int e = tid; e < kRows * kBlockN; e += kThreads) {
    float v = red[e];
#pragma unroll
    for (int w2 = 1; w2 < kWarps; ++w2) v += red[w2 * kRows * kBlockN + e];
    red[e] = v;
  }
  __syncthreads();
  finish_tile<__nv_bfloat16, kRows, kThreads>(red, s, out, partial, counters,
                                              m0, n_base, M, N, &ticket);
}

template <bool kAligned, int kR>
cudaError_t launch_rows(const void* x, const void* q, const float* s,
                        void* out, float* partial, int* counters, int M,
                        int K, int N, int splits, int k_per_split, bool x_vec,
                        cudaStream_t stream) {
  constexpr int smem = smem_bytes(kR);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_mma_kernel<kAligned, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits,
                  (M + 8 * kR - 1) / (8 * kR));
  int8_matmul_mma_kernel<kAligned, kR><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), s,
      static_cast<__nv_bfloat16*>(out), partial, counters, M, K, N,
      k_per_split, x_vec);
  return cudaGetLastError();
}

template <bool kAligned>
cudaError_t launch_aligned(const void* x, const void* q, const float* s,
                           void* out, float* partial, int* counters, int M,
                           int K, int N, int block_m, int splits,
                           int k_per_split, bool x_vec, cudaStream_t stream) {
  return block_m == 8
             ? launch_rows<kAligned, 1>(x, q, s, out, partial, counters, M, K,
                                        N, splits, k_per_split, x_vec, stream)
             : launch_rows<kAligned, 4>(x, q, s, out, partial, counters, M, K,
                                        N, splits, k_per_split, x_vec, stream);
}

// block_m: 8 or 32 rows of x a block
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   float* partial, int* counters, int M, int K, int N,
                   int block_m, int splits, int k_per_split,
                   cudaStream_t stream) {
  const bool x_vec = K % 8 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return rows_aligned(q, N)
             ? launch_aligned<true>(x, q, s, out, partial, counters, M, K, N,
                                    block_m, splits, k_per_split, x_vec,
                                    stream)
             : launch_aligned<false>(x, q, s, out, partial, counters, M, K, N,
                                     block_m, splits, k_per_split, x_vec,
                                     stream);
}

}  // namespace mma

// ---- kernel 4: bf16 decode, a persistent stream-K grid fed by TMA

namespace sk {

using namespace sm90;

constexpr int kBoxN = 128;   // columns of a code box: one swizzled row
constexpr int kCodeBytes = 16384;            // codes a stage
constexpr int kWarps = 8;  // consumers, 16 columns of every box each
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kStages = 4;                   // the ring: 64 KB of codes
constexpr int kBoxK = 64;  // columns of x in one 128-byte swizzled box

// A tile is kBoxes code boxes side by side, so that a stage reads every
// row of K kBoxes * 128 contiguous bytes at a time; a stage holds
// kCodeBytes of codes, so kStageK rows of K.
template <int kBoxes>
struct Tile {
  static constexpr int kTileN = kBoxes * kBoxN;  // output columns
  static constexpr int kStageK = kCodeBytes / kTileN;  // rows of K a stage
  static constexpr int kBoxBytes = kStageK * kBoxN;    // 128-byte swizzle
  static constexpr int kXBoxes = kStageK / kBoxK;      // x boxes a stage
  // a stage's x: kXBoxes boxes of 64 columns by kRows rows
  __host__ __device__ static constexpr int x_bytes(int kRows) {
    return kXBoxes * kRows * 128;
  }
  // the ring from a 1024-byte boundary (the launch asks for 1024 more)
  __host__ __device__ static constexpr int smem_bytes(int kRows) {
    return 1024 + kStages * (kCodeBytes + x_bytes(kRows));
  }
};

// The product's work as units (tile, stage of kStageK rows of K),
// tile-major, tile = column tile * m_tiles + row tile. Block b takes the
// contiguous units [begin(b), begin(b + 1)): every block streams the same
// weight bytes to within one stage. A function of the shape and the grid
// alone, which the plan sets from the SM count
// (tpu_operator_libs_torch/kernels/int8_matmul.py::stream_ranges).
struct Split {
  int units, stages, blocks;
  __device__ __forceinline__ int begin(int b) const {
    return static_cast<int>(static_cast<long long>(b) * units / blocks);
  }
  // the block whose units hold unit u
  __device__ __forceinline__ int block_of(int u) const {
    return static_cast<int>(
        (static_cast<long long>(u + 1) * blocks - 1) / units);
  }
};

// The grid is at most one block an SM; block blockIdx.x walks its units.
// x_map: x as (1, M, K) bf16, boxes of 64 columns x kRows rows; q_map: q
// as (K, N) uint8, boxes of 128 columns x kStageK rows; both 128-byte
// swizzled. A stage is kBoxes code boxes side by side, so that every row
// of K is read kTileN contiguous bytes at a time. Rows of x past M and of
// q past K, and columns past N in a loaded box, read as zeros; a box
// wholly past N is not loaded, and its columns are never written.
//
// The producer warp's lane 0 loads each unit's code boxes and the
// matching x boxes into a ring of kStages stages with full/empty mbarriers.
// Warp w owns columns [16 w, 16 w + 16) of every box of the tile and sums
// them over every row of K it is given, so it holds whole sums and no
// warp waits for another. The product runs transposed, out^T = q^T x^T
// with mma.sync m16n8k16 (the weight is A): ldmatrix.trans of 8 rows of K
// x 16 codes hands lane (g, t) the codes of columns 2g and 2g + 1 at rows
// 2t and 2t + 1, which are A's rows g and g + 8 at k 2t, 2t + 1
// (code_pair_to_bf16x2 of the word and of it shifted by a byte); x's rows
// 8 r .. 8 r + 7 come as B by a plain ldmatrix, shared by the boxes. The
// sums land at (rows 8 r + 2t, + 1) x (columns 2g, 2g + 1).
//
// A tile whose units lie in one block is written with the epilogue. A
// tile cut between blocks: each block's warps write their f32 sums to the
// block's slot in `partial` (slot 0 for the block's first tile, 1 for its
// last) and take a ticket, one counter a (cut tile, warp), indexed by the
// tile's first block; the warp drawing the last ticket adds the blocks'
// sums in block order, writes the epilogue and puts the counter back to
// 0. The order is fixed by the shape and the grid.
template <int kR, int kBoxes>
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_streamk_kernel(const __grid_constant__ CUtensorMap x_map,
                               const __grid_constant__ CUtensorMap q_map,
                               const float* __restrict__ s,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ partial,
                               int* __restrict__ counters, int M, int K,
                               int N, int m_tiles, Split split) {
  using T = Tile<kBoxes>;
  constexpr int kTileN = T::kTileN;
  constexpr int kStageK = T::kStageK;
  constexpr int kBoxBytes = T::kBoxBytes;
  constexpr int kXBoxes = T::kXBoxes;
  constexpr int kRows = 8 * kR;
  constexpr int kXBytes = T::x_bytes(kRows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* codes_s = align_1024(smem_raw);         // [kStages][kCodeBytes]
  uint8_t* x_s = codes_s + kStages * kCodeBytes;   // [kStages][kXBytes]
  __shared__ uint64_t full[kStages], empty[kStages];

  const int begin = split.begin(blockIdx.x);
  const int count = split.begin(blockIdx.x + 1) - begin;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    prefetch_map(&q_map);
    prefetch_map(&x_map);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer warp; lane 0 loads
    if (lane == 0) {
      int tile = begin / split.stages;
      int stage = begin % split.stages;
      for (int i = 0; i < count; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
        const int k0 = stage * kStageK;
        const int n0 = tile / m_tiles * kTileN;
        const int m0 = tile % m_tiles * kRows;
        // boxes only where they hold a column of q and a row of K: a box
        // past N is never read (its columns are never written)
        const int boxes = min(kBoxes, (N - n0 + kBoxN - 1) / kBoxN);
        const int x_boxes = min(kXBoxes, (K - k0 + kBoxK - 1) / kBoxK);
        mbar_expect_tx(&full[st], boxes * kBoxBytes
                                      + x_boxes * (kXBytes / kXBoxes));
        for (int j = 0; j < boxes; ++j) {
          tma_load_2d(codes_s + st * kCodeBytes + j * kBoxBytes, &q_map,
                      &full[st], n0 + j * kBoxN, k0);
        }
        for (int j = 0; j < x_boxes; ++j) {
          tma_load(x_s + st * kXBytes + j * (kXBytes / kXBoxes), &x_map,
                   &full[st], k0 + j * kBoxK, m0, 0);
        }
        if (++stage == split.stages) {
          stage = 0;
          ++tile;
        }
      }
    }
    return;
  }

  const int g = lane / 4;
  const int t = lane % 4;
  float acc[kBoxes][kR][4];
#pragma unroll
  for (int j = 0; j < kBoxes; ++j) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][r][e] = 0.f;
    }
  }

  // the tile's sums, rounded as the plain version rounds them
  const auto store = [&](const float (&v)[kBoxes][kR][4], int tile) {
#pragma unroll
    for (int j = 0; j < kBoxes; ++j) {
      const int col =
          tile / m_tiles * kTileN + j * kBoxN + 16 * warp + 2 * g;
      if (col >= N) continue;  // N % 16 == 0: the warp's 16 are all out
      const float s0 = s[col];
      const float s1 = s[col + 1];
      __nv_bfloat16* tag = nullptr;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int row = tile % m_tiles * kRows + 8 * r + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row + h < M) {
            __nv_bfloat162 o;
            o.x = epilogue(v[j][r][h], s0, tag);
            o.y = epilogue(v[j][r][2 + h], s1, tag);
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<long long>(row + h) * N + col) = o;
          }
        }
      }
    }
  };
  // this lane's sums in slot `slot` of block b's partial sums: a tile's
  // kRows x kTileN f32
  const auto slot_ptr = [&](int b, int slot) {
    return partial + static_cast<long long>(2 * b + slot) * kRows * kTileN
           + 2 * t * kTileN + 16 * warp + 2 * g;
  };

  // The last ticket of a cut tile adds the blocks' sums in block order
  // b0..b1 and writes the tile. Slot 0 holds a block's first tile, 1 its
  // last: the tile is the first of every block after b0, and of b0 where
  // it starts there. kBatch blocks' loads are in flight at once, from
  // addresses clamped to b1 so that no branch sits between them.
  const auto combine = [&](int tile, int b0, int b1) {
    const int slot0 = split.begin(b0) == tile * split.stages ? 0 : 1;
    constexpr int kBatch = 8 / (kR * kBoxes) > 1 ? 8 / (kR * kBoxes) : 2;
    float total[kBoxes][kR][4];
    for (int base = b0; base <= b1; base += kBatch) {
      float2 e[kBatch][kBoxes][kR], o[kBatch][kBoxes][kR];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int bi = min(base + i, b1);
        const float* p = slot_ptr(bi, bi == b0 ? slot0 : 0);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float* pr = p + 8 * r * kTileN + j * kBoxN;
            e[i][j][r] = __ldcg(reinterpret_cast<const float2*>(pr));
            o[i][j][r] =
                __ldcg(reinterpret_cast<const float2*>(pr + kTileN));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float v[4] = {e[i][j][r].x, o[i][j][r].x, e[i][j][r].y,
                                o[i][j][r].y};
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) {
              if (base + i == b0) {
                total[j][r][q4] = v[q4];
              } else if (base + i <= b1) {
                total[j][r][q4] += v[q4];
              }
            }
          }
        }
      }
    }
    store(total, tile);
  };

  const int first_tile = begin / split.stages;
  int tile = first_tile;
  int stage = begin % split.stages;
  for (int i = 0; i < count; ++i) {
    const int st = i % kStages;
    // rows of K that this stage holds; k-steps past them are skipped
    const int rows = min(kStageK, K - stage * kStageK);
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint8_t* codes = codes_s + st * kCodeBytes;
    const uint8_t* xs = x_s + st * kXBytes;
    // every load of the stage first, then the products: one wait for
    // shared memory a stage. Lane l gives code row kk + l of each box
    // (matrix j holds rows kk + 8j .. + 7) and x's row 8r + l % 8 at
    // columns kk + 8 (l / 8) .. + 7 (matrix j holds columns kk + 8j .. + 7).
    constexpr int kSteps = kStageK / 32;  // pairs of k-steps of 16
    uint32_t c[kSteps][kBoxes][4];
    uint32_t b[kSteps][kR][4];
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      const int kk = 32 * h;
      if (kk < rows) {
        const int row = kk + lane;
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          ldmatrix_x4_trans(c[h][j], codes + j * kBoxBytes + row * kBoxN
                                         + ((warp ^ (row & 7)) << 4));
        }
        const int kc = kk + 8 * (lane >> 3);
        const uint8_t* box = xs + (kc / kBoxK) * (kXBytes / kXBoxes);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int xr = 8 * r + (lane & 7);
          ldmatrix_x4(b[h][r], box + xr * 128
                                   + ((((kc % kBoxK) >> 3) ^ (xr & 7)) << 4));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      if (32 * h < rows) {
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
          uint32_t a0[4], a1[4];
          codes_to_a(c[h][j], 0, a0);
          codes_to_a(c[h][j], 1, a1);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            mma::mma_bf16(acc[j][r], a0, b[h][r][0], b[h][r][1]);
            mma::mma_bf16(acc[j][r], a1, b[h][r][2], b[h][r][3]);
          }
        }
      }
    }
    // the products have read their operands: the stage can be refilled
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);

    if (stage == split.stages - 1 || i == count - 1) {  // the tile's end
      const int first = tile * split.stages;
      const int b0 = split.block_of(first);
      const int b1 = split.block_of(first + split.stages - 1);
      if (b0 == b1) {
        store(acc, tile);
      } else {
        float* mine = slot_ptr(blockIdx.x, tile == first_tile ? 0 : 1);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            float* pr = mine + 8 * r * kTileN + j * kBoxN;
            *reinterpret_cast<float2*>(pr) =
                make_float2(acc[j][r][0], acc[j][r][2]);
            *reinterpret_cast<float2*>(pr + kTileN) =
                make_float2(acc[j][r][1], acc[j][r][3]);
          }
        }
        // the warp's sums, then a ticket: the warp's barrier orders its
        // lanes' stores before lane 0's release, and the last ticket's
        // acquire before every lane's loads (a fence beside the atomic's
        // release measured ~1 us slower a launch on the H100)
        __syncwarp();
        int ticket = 0;
        if (lane == 0) ticket = tickets::take(counters + b0 * kWarps + warp);
        ticket = __shfl_sync(0xffffffffu, ticket, 0);
        __syncwarp();
        if (ticket == b1 - b0) {
          combine(tile, b0, b1);
          if (lane == 0) counters[b0 * kWarps + warp] = 0;
        }
      }
#pragma unroll
      for (int j = 0; j < kBoxes; ++j) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][r][e] = 0.f;
        }
      }
    }
    if (++stage == split.stages) {
      stage = 0;
      ++tile;
    }
  }
}

template <int kR, int kBoxes>
cudaError_t launch_rows(const void* x, const void* q, const float* s,
                        void* out, float* partial, int* counters, int M,
                        int K, int N, int blocks, cudaStream_t stream) {
  using T = Tile<kBoxes>;
  constexpr int kRows = 8 * kR;
  CUtensorMap x_map, q_map;
  // a map cuTensorMapEncodeTiled refuses (a base not 16-byte aligned) is
  // an invalid value
  if (!encode_tile_map(&x_map, x, K, M, 1, kRows)
      || !wg::encode_codes_map(&q_map, q, K, N, T::kStageK)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = T::smem_bytes(kRows);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_streamk_kernel<kR, kBoxes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + kRows - 1) / kRows;
  const int stages = (K + T::kStageK - 1) / T::kStageK;
  const Split split{(N + T::kTileN - 1) / T::kTileN * m_tiles * stages,
                    stages, blocks};
  int8_matmul_streamk_kernel<kR, kBoxes><<<blocks, kThreads, smem, stream>>>(
      x_map, q_map, s, static_cast<__nv_bfloat16*>(out), partial, counters,
      M, K, N, m_tiles, split);
  return cudaGetLastError();
}

template <int kBoxes>
cudaError_t launch_boxes(const void* x, const void* q, const float* s,
                         void* out, float* partial, int* counters, int M,
                         int K, int N, int block_m, int blocks,
                         cudaStream_t stream) {
  switch (block_m) {
    case 8: return launch_rows<1, kBoxes>(x, q, s, out, partial, counters, M,
                                          K, N, blocks, stream);
    case 16: return launch_rows<2, kBoxes>(x, q, s, out, partial, counters,
                                           M, K, N, blocks, stream);
    default: return launch_rows<4, kBoxes>(x, q, s, out, partial, counters,
                                           M, K, N, blocks, stream);
  }
}

// block_m: 8, 16 or 32 rows of x a tile; block_n: 128 or 256 columns
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   float* partial, int* counters, int M, int K, int N,
                   int block_m, int block_n, int blocks, cudaStream_t stream) {
  return block_n == 128
             ? launch_boxes<1>(x, q, s, out, partial, counters, M, K, N,
                               block_m, blocks, stream)
             : launch_boxes<2>(x, q, s, out, partial, counters, M, K, N,
                               block_m, blocks, stream);
}

}  // namespace sk

// ---- kernel 3: f32 x, f32 FMAs on the CUDA cores

namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 6;                       // stages of the ring
constexpr int kChunkBytes = kChunkK * kBlockN;  // 8 KB of codes a stage
constexpr int kCols = 16;                      // codes a thread multiplies
constexpr int kColLanes = 8;                   // threads across a strip
constexpr int kGroups = kThreads / kColLanes;  // 32 thread groups
constexpr int kRowsPerGroup = kChunkK / kGroups;  // 2

struct NoSwizzle {
  __device__ __forceinline__ int operator()(int) const { return 0; }
};

__host__ __device__ constexpr int ring_bytes(int kM) {
  return kRing * (kChunkBytes + kM * kChunkK * 4);
}
// the ring, or the block's reduction buffer that reuses it after the loop
__host__ __device__ constexpr int smem_bytes(int kM) {
  return ring_bytes(kM) > kWarps * kM * kBlockN * 4
             ? ring_bytes(kM) : kWarps * kM * kBlockN * 4;
}

// One block: columns [blockIdx.x * 128, +128), rows of x [blockIdx.z * kM,
// +kM), rows of K [blockIdx.y * k_per_split, +k_per_split); see
// finish_tile for the split-K workspace and counters. Each thread
// multiplies 16 neighbouring columns by kM rows of x, for rows 2 g and
// 2 g + 1 of every 64-row stage (thread group g of 32).
template <int kM, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ s, float* __restrict__ out,
                       float* __restrict__ partial, int* __restrict__ counters,
                       int M, int K, int N, int k_per_split, bool x_vec) {
  extern __shared__ float4 smem[];  // 16-byte aligned
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(smem);  // [kRing][8 KB]
  float* xs_s = reinterpret_cast<float*>(codes_s + kRing * kChunkBytes);
  // [kRing][kM][64] of x; after the loop the ring is the block's
  // [kWarps][kM][128] f32 reduction buffer
  float* red = reinterpret_cast<float*>(smem);
  __shared__ int ticket;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_lane = tid % kColLanes;
  const int group = tid / kColLanes;
  const int n_base = blockIdx.x * kBlockN;
  const int m0 = blockIdx.z * kM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int chunks = (k_end - k_begin + kChunkK - 1) / kChunkK;

  float acc[kM][kCols];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;
  }

  auto stage = [&](int c) {
    stage_chunk<float, kChunkK, kM, kChunkK, kThreads, kAligned>(
        codes_s + (c % kRing) * kChunkBytes, xs_s + (c % kRing) * kM * kChunkK,
        x, q, k_begin + c * kChunkK, k_end, n_base, m0, M, K, N, x_vec,
        NoSwizzle());
  };
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (c + kRing - 1 < chunks) stage(c + kRing - 1);
    cp_async_commit();
    const uint8_t* codes = codes_s + (c % kRing) * kChunkBytes
                           + kRowsPerGroup * group * kBlockN
                           + col_lane * kCols;
    const float* xs = xs_s + (c % kRing) * kM * kChunkK
                      + kRowsPerGroup * group;
    float xv[2][kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float2 v = *reinterpret_cast<const float2*>(xs + m * kChunkK);
      xv[0][m] = v.x;
      xv[1][m] = v.y;
    }
#pragma unroll
    for (int h = 0; h < kRowsPerGroup; ++h) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(codes + h * kBlockN);
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[4];
        word_to_floats(w[i], f);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            acc[m][4 * i + b] = fmaf(xv[h][m], f[b], acc[m][4 * i + b]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes `red`

  // the warp's four thread groups (lanes 8 apart) by a fixed butterfly
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  if (lane < kColLanes) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < kCols; j += 4) {
        *reinterpret_cast<float4*>(red + (warp * kM + m) * kBlockN
                                   + lane * kCols + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                        acc[m][j + 3]);
      }
    }
  }
  __syncthreads();
  // then the warps in order, into warp 0's place
  for (int e = tid; e < kM * kBlockN; e += kThreads) {
    float v = red[e];
#pragma unroll
    for (int w2 = 1; w2 < kWarps; ++w2) v += red[w2 * kM * kBlockN + e];
    red[e] = v;
  }
  __syncthreads();
  finish_tile<float, kM, kThreads>(red, s, out, partial, counters, m0,
                                   n_base, M, N, &ticket);
}

// The rows of x a block takes; tpu_operator_libs_torch/kernels/
// int8_matmul.py::m_tile mirrors it for the plan.
int m_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

template <int kM, bool kAligned>
cudaError_t launch_tiles(const void* x, const void* q, const float* s,
                         void* out, float* partial, int* counters, int M,
                         int K, int N, int splits, int k_per_split,
                         bool x_vec, cudaStream_t stream) {
  constexpr int smem = smem_bytes(kM);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<kM, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (M + kM - 1) / kM);
  int8_matmul_kernel<kM, kAligned><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q), s,
      static_cast<float*>(out), partial, counters, M, K, N, k_per_split,
      x_vec);
  return cudaGetLastError();
}

template <int kM>
cudaError_t launch_m(const void* x, const void* q, const float* s, void* out,
                     float* partial, int* counters, int M, int K, int N,
                     int splits, int k_per_split, cudaStream_t stream) {
  const bool x_vec = K % 4 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return rows_aligned(q, N)
             ? launch_tiles<kM, true>(x, q, s, out, partial, counters, M, K,
                                      N, splits, k_per_split, x_vec, stream)
             : launch_tiles<kM, false>(x, q, s, out, partial, counters, M, K,
                                       N, splits, k_per_split, x_vec, stream);
}

cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   float* partial, int* counters, int M, int K, int N,
                   int splits, int k_per_split, cudaStream_t stream) {
  switch (m_tile(M)) {
    case 1: return launch_m<1>(x, q, s, out, partial, counters, M, K, N,
                               splits, k_per_split, stream);
    case 2: return launch_m<2>(x, q, s, out, partial, counters, M, K, N,
                               splits, k_per_split, stream);
    case 4: return launch_m<4>(x, q, s, out, partial, counters, M, K, N,
                               splits, k_per_split, stream);
    default: return launch_m<8>(x, q, s, out, partial, counters, M, K, N,
                                splits, k_per_split, stream);
  }
}

}  // namespace f32

}  // namespace

// x (M, K) of dtype 0 = float32 or 1 = bfloat16, q (K, N) int8, s (N,)
// float32, out (M, N) of x's dtype, all contiguous, and the plan
// (tpu_operator_libs_torch/kernels/int8_matmul.py::plan; block_n and
// blocks are read by designs 1 and 4):
// - design 1, wgmma: bfloat16, M >= 64, N % 16 == 0, K % 8 == 0, tiles of
//   block_m (64, 128 or 256) x block_n (128) rows and columns, splits 1,
//   `blocks` (the persistent grid) between 1 and the tiles, x, q and out
//   16-byte aligned;
// - design 4, stream-K: bfloat16, N % 16 == 0, K % 8 == 0, block_m 8, 16
//   or 32, block_n 128 or 256, splits 1, `blocks` (the grid) between 1
//   and the units (tiles x stages of 16384 / block_n rows of K), x and q
//   16-byte aligned; `partial` an f32 workspace of 2 * blocks * block_m *
//   block_n elements and `counters` at least 8 * blocks ints, all 0 (the
//   kernel leaves them 0);
// - design 2, mma.sync: bfloat16, block_m 8 or 32; design 3, CUDA cores:
//   float32, block_m == m_tile(M). Both: K cut into `splits` (1 to 16)
//   slices of `k_per_split` rows (a multiple of 64), the last possibly
//   shorter and none empty; with splits > 1, `partial` an f32 workspace
//   of (splits, M, N) elements and `counters` n_counters ints, at least
//   one a tile, all 0 (the kernel leaves them 0).
extern "C" int int8_matmul(const void* x, const void* q, const void* s,
                           void* out, void* partial, void* counters,
                           int n_counters, int M, int K, int N, int design,
                           int block_m, int block_n, int splits,
                           int k_per_split, int blocks, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  if (design == 1) {
    const long long tiles =
        static_cast<long long>((M + block_m - 1) / block_m)
        * ((N + block_n - 1) / block_n);
    if (dtype != 1 || M < 64 || N % 16 != 0 || K % 8 != 0 || splits != 1
        || block_n != wg::kCodeBox || blocks < 1 || blocks > tiles
        || tiles > 0x7fffffff) {
      return cudaErrorInvalidValue;
    }
    return wg::launch(x, q, sf, out, M, K, N, block_m, blocks, st);
  }
  if (design == 4) {
    const long long units =
        static_cast<long long>((N + block_n - 1) / block_n)
        * ((M + block_m - 1) / block_m)
        * ((K + sk::kCodeBytes / block_n - 1) / (sk::kCodeBytes / block_n));
    if (dtype != 1 || N % 16 != 0 || K % 8 != 0 || splits != 1
        || (block_m != 8 && block_m != 16 && block_m != 32)
        || (block_n != 128 && block_n != 256) || blocks < 1
        || blocks > units || units > 0x7fffffff || partial == nullptr
        || counters == nullptr
        || static_cast<long long>(sk::kWarps) * blocks > n_counters) {
      return cudaErrorInvalidValue;
    }
    return sk::launch(x, q, sf, out, static_cast<float*>(partial),
                      static_cast<int*>(counters), M, K, N, block_m, block_n,
                      blocks, st);
  }
  const bool ok_design = (design == 2 && dtype == 1
                          && (block_m == 8 || block_m == 32))
                         || (design == 3 && dtype == 0
                             && block_m == f32::m_tile(M));
  const long long tiles =
      static_cast<long long>((N + kBlockN - 1) / kBlockN)
      * ((M + block_m - 1) / block_m);
  if (!ok_design || splits < 1 || splits > kMaxSplits || k_per_split < 1
      || k_per_split % kChunkK != 0
      || static_cast<long long>(splits) * k_per_split < K
      || static_cast<long long>(splits - 1) * k_per_split >= K
      || (M + block_m - 1) / block_m > 65535
      || (splits > 1 && (partial == nullptr || counters == nullptr
                         || tiles > n_counters))) {
    return cudaErrorInvalidValue;
  }
  float* pt = splits > 1 ? static_cast<float*>(partial) : nullptr;
  int* ct = splits > 1 ? static_cast<int*>(counters) : nullptr;
  if (design == 2) {
    return mma::launch(x, q, sf, out, pt, ct, M, K, N, block_m, splits,
                       k_per_split, st);
  }
  return f32::launch(x, q, sf, out, pt, ct, M, K, N, splits, k_per_split,
                     st);
}

// The text of a cudaError_t that int8_matmul returned.
extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

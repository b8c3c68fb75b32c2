// The cached decode step's attention: the new queries of one step (or a
// prefill block) against one layer's KV cache, float or int8 with
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
// Bound: bytes. At decode each query row meets every visible key once, 4
// FLOPs a key element against 2 bytes (bf16) or 1 byte (int8) read: far
// below the card's 295 FLOPs a byte. So the kernel reads the cache once,
// in place, in its (B, S, n_kv, head_dim) layout, and only as far as the
// step's last visible key: no permuted and no widened copy.
//
// Design. A block of 128 threads takes one (batch row, kv head, tile of up
// to 16 query rows, key split), a row being one (t, g) pair of the kv
// head's group, so a kv head's keys serve all of its group's heads at once.
//   - Early stop. The block reads the position on the device and walks the
//     keys only up to the last key visible to its last row, start_pos +
//     t_last: a key past it has weight exactly 0 (exp(-1e30 - max) is 0 in
//     the reference, the kernel sets it to 0), so the tiles past it are
//     not read at all and no split is given keys past it (rows of the
//     last tile past it are zero-filled, not read). The cache past the
//     position is never read, so a NaN planted there does not reach the
//     output (the reference's 0 * NaN would carry it).
//   - Splits. The plan gives each (b, kv head, row tile) group `splits`
//     blocks, so that a call with few groups still covers the SMs; the
//     block reads the position and deals the group's visible key tiles to
//     the splits in equal runs of whole tiles (the grid never depends on
//     the position, the work of each split does), and a split left without
//     a tile (fewer visible tiles than splits) exits. Each split keeps
//     its rows' (max m, sum l, unnormalised sums acc) in float32 and writes
//     them to the workspace; it then takes a ticket on its group's counter
//     (an atomic add with release and acquire semantics after the block's
//     barrier, as csrc/int8_matmul.cu's split-K fixup orders its sums),
//     and the block that draws the last ticket combines the splits in split
//     order, m = max_i m_i, l = sum_i l_i e^(m_i - m), out = sum_i acc_i
//     e^(m_i - m) / l, rounds once and puts the counter back to 0. Where one
//     split holds every visible key it writes the output itself. No float
//     atomics, every sum in a fixed order: two launches, or a replayed
//     graph, give the same bits.
//   - A ring of `stages` key tiles in shared memory, filled by 16-byte
//     cp.async (element loads where a row's bytes are not a multiple of
//     16), so that stages - 1 tiles' copies are in flight while one is
//     computed.
//   - Tensor cores (bf16 q over a bf16 or int8 cache, head_dim a multiple
//     of 16): 64-key tiles, warp w taking keys 16w .. 16w + 15 of each.
//     Scores by mma.sync m16n8k16 (bf16 in, f32 sums) with the block's
//     query rows, padded to 16, as A (ldmatrix) and the staged keys as B;
//     int8 codes are converted to bf16 (exact: |code| <= 127) in one pass
//     over the staged tile. The scores stay in registers: times the scale
//     and the K scale, masked, an online softmax in float32 a warp (its own
//     m, l and acc per row; exp by the fast __expf, a few ulps off, far
//     inside bf16's limit), the weights times the V scale (the reference's
//     order, llama_decode.py:236-244) as the A operand of the value product
//     over the staged values (ldmatrix.trans). The weights ride as hi + lo
//     bf16 in two products, as the flash backward carries P: rounded once
//     to bf16, a row of few keys missed float32's limit by 35% (the CPU
//     emulation). The four warps' states are combined in warp order.
//   - CUDA cores (float32 q or a float32 cache, where TF32 would not hold
//     float32's limit, and head_dims that are not multiples of 16): the
//     block takes the whole tile: A. each thread takes (row, key) scores;
//     B. one warp a row, the online softmax; C. each thread takes (row,
//     16-byte column chunk) outputs and a share of the keys, added in
//     share order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;   // query rows a block
constexpr int kMaxSmem = 232448;
constexpr int kMaxSplits = 32;
constexpr int kMmaKeys = 64;   // the tensor-core route's key tile: 16 a warp

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

// Waits for the ring's oldest tile: all but the newest stages - 2 groups.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) {
    cp_async_wait<2>();
  } else if (stages == 3) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
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

// Four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each lane its column pairs.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b: m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16, rounded to nearest even, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four int8 codes (a word) as two bf16 pairs, exactly, without a
// conversion instruction: byte x becomes the float with bits 0x4B0000 |
// (x ^ 0x80), which is 2^23 + 128 + x, less 2^23 + 128; an integer of at
// most 8 significant bits has its float's upper half as its bf16.
__device__ __forceinline__ void codes_to_bf16(uint32_t word, uint32_t& lo,
                                              uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i))
        - 8388736.f);
  }
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// x0, x1 as bf16 pairs hi + lo: hi rounded, lo the rest rounded, so that
// hi + lo carries x to about 16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
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
  float* ws;               // the splits' (m, l, acc), splits > 1 only
  int* counters;           // a ticket counter per group, splits > 1 only
  int batch, t_new, heads, kv_heads, seq, dim;
  int q_dtype, out_dtype;  // 0 float32, 1 bfloat16
  int key_tile;            // keys a tile
  int row_stride;          // bytes between two keys' staged rows
  int stages;              // key tiles in the ring
  int splits;              // blocks that share a group's visible keys
  float scale;             // head_dim^-0.5
};

// Shared memory, in bytes (kernels/decode_attention.py::smem_bytes
// computes the same). Both routes start with the combine's rows (m, l and
// the weights of up to kWarps parts) and the offsets of the block's rows
// in q and the output.
__host__ __device__ constexpr long long small_bytes() {
  return (2LL + kWarps) * kMaxRows * 4 + kMaxRows * 8;
}

__host__ __device__ inline long long stage_bytes(int key_tile,
                                                 int row_stride) {
  return 2LL * key_tile * row_stride + 2LL * key_tile * 4;
}

// CUDA cores: the queries and output sums in float32, the scores, the
// key-share partial sums, the rows' running max, sum and rescale, the ring.
__host__ __device__ inline long long smem_bytes_cuda(int dim, int key_tile,
                                                     int row_stride,
                                                     int stages) {
  return small_bytes() + 2LL * kMaxRows * dim * 4 + kMaxRows * key_tile * 4
         + kThreads * 16 * 4 + 3 * kMaxRows * 4
         + stages * stage_bytes(key_tile, row_stride);
}

// Tensor cores: the queries in bf16, the warps' m and l, for an int8 cache
// the converted K and V tiles, the ring (after the loop, the warps' sums).
__host__ __device__ inline long long smem_bytes_mma(int dim, bool int8,
                                                    int row_stride,
                                                    int stages) {
  const long long bf16_stride = 2LL * dim + 16;
  return small_bytes() + kMaxRows * bf16_stride + 2 * kWarps * kMaxRows * 4
         + (int8 ? 2 * kMmaKeys * bf16_stride : 0)
         + stages * stage_bytes(kMmaKeys, row_stride);
}

// Elements tid, tid + kThreads, ... of a grid `cols` wide as (row j,
// column c), stepped without a division.
struct Walk {
  int j, c, dj, dc, cols;
  __device__ __forceinline__ explicit Walk(int cols_)
      : j(threadIdx.x / cols_), c(threadIdx.x % cols_), dj(kThreads / cols_),
        dc(kThreads % cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    j += dj;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++j;
    }
  }
};

// What a block takes: its group (b, kv head, row tile), its split and, of
// the group's visible keys, the run [k_begin, k_end) that the split takes.
struct Block {
  int b, kvh, group, row0, rows, split, tile;
  int nonempty;  // the splits that hold a visible key (at least 1)
  int k_begin, k_end, ntiles;
  long long pos;
};

__device__ __forceinline__ Block block_of(const Params& p) {
  Block k;
  k.b = blockIdx.z;
  k.kvh = blockIdx.y;
  const int row_tiles = gridDim.x / p.splits;
  const int row_tile = blockIdx.x / p.splits;
  k.split = blockIdx.x % p.splits;
  k.group = p.heads / p.kv_heads;
  k.row0 = row_tile * kMaxRows;
  k.rows = min(kMaxRows, p.t_new * k.group - k.row0);
  k.tile = (k.b * p.kv_heads + k.kvh) * row_tiles + row_tile;
  return k;
}

// The offset in q and the output of each of the block's rows, row r the
// (t, g) = divmod(row0 + r, group), into shared memory (threads 0-15).
__device__ __forceinline__ void row_offsets(const Params& p, const Block& blk,
                                            long long* row_off) {
  const int r = threadIdx.x;
  if (r < blk.rows) {
    const int qi = blk.row0 + r;
    row_off[r] =
        ((static_cast<long long>(blk.b) * p.t_new + qi / blk.group) * p.heads
         + blk.kvh * blk.group + qi % blk.group) * p.dim;
  }
}

// kPer of the block's query elements as floats, the walk's (row, column)
// and its next kPer - 1 steps (0 past the block's rows): every load is
// issued before any is used, so that they overlap each other.
template <int kPer>
__device__ __forceinline__ void load_queries(const Params& p, const Block& blk,
                                             const long long* row_off,
                                             Walk w, float (&x)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    x[j] = 0.f;
    if (w.j < blk.rows) {
      const long long off = row_off[w.j] + w.c;
      x[j] = p.q_dtype == 0
                 ? __ldg(static_cast<const float*>(p.q) + off)
                 : __bfloat162float(
                       __ldg(static_cast<const __nv_bfloat16*>(p.q) + off));
    }
    w.next();
  }
}

// The block's keys: the position, read on the device, and what the early
// stop leaves of the split.
__device__ __forceinline__ void find_keys(const Params& p, Block& k) {
  k.pos = p.pos != nullptr ? *p.pos : p.pos_value;
  // keys [0, vis_end) are visible to some row of the block
  const long long last = k.pos + (k.row0 + k.rows - 1) / k.group;
  const int vis_end = static_cast<int>(
      max(0LL, min(static_cast<long long>(p.seq), last + 1)));
  // the visible key tiles, dealt to the splits in equal runs of `per`
  const int tiles = (vis_end + p.key_tile - 1) / p.key_tile;
  const int per = max(1, (tiles + p.splits - 1) / p.splits);
  k.nonempty = max(1, (tiles + per - 1) / per);
  k.k_begin = k.split * per * p.key_tile;
  k.k_end = min(vis_end, k.k_begin + per * p.key_tile);
  k.ntiles = k.k_end > k.k_begin
                 ? (k.k_end - k.k_begin + p.key_tile - 1) / p.key_tile
                 : 0;
}

// Output element (row r, column d) of the block, at its row's offset.
__device__ __forceinline__ void store_out(const Params& p,
                                          const long long* row_off, int r,
                                          int d, float o) {
  if (p.out_dtype == 0) {
    static_cast<float*>(p.out)[row_off[r] + d] = o;
  } else {
    static_cast<__nv_bfloat16*>(p.out)[row_off[r] + d] =
        __float2bfloat16_rn(o);
  }
}

// The ticket of a split: an atomic add with release semantics for the
// split's state (which the block's barrier ordered before it) and acquire
// semantics for the other splits' states, at the card's scope.
__device__ __forceinline__ int take_ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// The last split of a group combines every split's state, from L2, in
// split order. For a few splits each output element reads its row's m and
// l of every split and its own sums in one round of loads, with no
// barrier and no shared memory between them (restrict: no store aliases
// them); for more, each row's weights are computed once into `scratch`
// (free shared memory) first.
__device__ __forceinline__ void combine_splits(const Params& p,
                                               const Block& blk,
                                               const float* __restrict__ all,
                                               long long chunk,
                                               const long long* row_off,
                                               float* __restrict__ scratch) {
  constexpr int kFew = 4;
  const int dim = p.dim;
  const int n = blk.nonempty;
  if (n <= kFew) {
    for (Walk w(dim); w.j < blk.rows; w.next()) {
      const float* at = all + w.j;
      const long long sums = 2 * kMaxRows + w.j * (dim - 1) + w.c;
      float ms[kFew];
      float ls[kFew];
      float as[kFew];
#pragma unroll
      for (int i = 0; i < kFew; ++i) {
        if (i < n) {
          ms[i] = __ldcg(at + i * chunk);
          ls[i] = __ldcg(at + i * chunk + kMaxRows);
          as[i] = __ldcg(at + i * chunk + sums);
        }
      }
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kFew; ++i) {
        if (i < n) m = fmaxf(m, ms[i]);
      }
      float l = 0.f;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kFew; ++i) {
        if (i < n) {
          const float wi = ms[i] == -INFINITY ? 0.f : expf(ms[i] - m);
          l += ls[i] * wi;
          a += as[i] * wi;
        }
      }
      store_out(p, row_off, w.j, w.c, __fdiv_rn(a, l));
    }
    return;
  }
  float* wts = scratch;  // [split][row]
  float* l_row = wts + kMaxSplits * kMaxRows;
  const int tid = threadIdx.x;
  if (tid < blk.rows) {
    float m = -INFINITY;
    for (int i = 0; i < n; ++i) m = fmaxf(m, __ldcg(all + i * chunk + tid));
    float l = 0.f;
    for (int i = 0; i < n; ++i) {
      const float mi = __ldcg(all + i * chunk + tid);
      const float wi = mi == -INFINITY ? 0.f : expf(mi - m);
      wts[i * kMaxRows + tid] = wi;
      l += __ldcg(all + i * chunk + kMaxRows + tid) * wi;
    }
    l_row[tid] = l;
  }
  __syncthreads();
  for (Walk w(dim); w.j < blk.rows; w.next()) {
    float a = 0.f;
    for (int i = 0; i < n; ++i) {
      a += __ldcg(all + i * chunk + 2 * kMaxRows + w.j * dim + w.c)
           * wts[i * kMaxRows + w.j];
    }
    store_out(p, row_off, w.j, w.c, __fdiv_rn(a, l_row[w.j]));
  }
}

// The block's `parts` states (the warps', or the block's one), part i's
// row r at part_m[16 i + r], part_l[16 i + r], part_acc[(16 i + r) stride
// + d], combined in part order into the split's state; then the output, or
// the split's state to the workspace and, in the block that draws the last
// ticket, the splits combined in split order and the output (`scratch`:
// shared memory free by then, (kMaxSplits + 1) x 16 floats). Divides by
// the softmax's sum once and rounds once.
__device__ __forceinline__ void finish(const Params& p, const Block& blk,
                                       const float* part_m,
                                       const float* part_l,
                                       const float* part_acc, int stride,
                                       int parts, float* small,
                                       const long long* row_off,
                                       float* scratch) {
  __shared__ int ticket;
  float* m_blk = small;
  float* l_blk = small + kMaxRows;
  float* wts = small + 2 * kMaxRows;  // [part][row]
  const int tid = threadIdx.x;
  const int dim = p.dim;
  const int rows = blk.rows;
  if (tid < rows) {
    float m = -INFINITY;
    for (int i = 0; i < parts; ++i) m = fmaxf(m, part_m[i * kMaxRows + tid]);
    float l = 0.f;
    for (int i = 0; i < parts; ++i) {
      const float mi = part_m[i * kMaxRows + tid];
      const float w = mi == -INFINITY ? 0.f : expf(mi - m);
      wts[i * kMaxRows + tid] = w;
      l += part_l[i * kMaxRows + tid] * w;
    }
    m_blk[tid] = m;
    l_blk[tid] = l;
  }
  __syncthreads();
  // the split's state: [m x 16][l x 16][acc 16 x dim] a (group, split)
  const long long chunk = 2 * kMaxRows + static_cast<long long>(kMaxRows)
                                             * dim;
  float* mine = p.ws + (static_cast<long long>(blk.tile) * p.splits
                        + blk.split) * chunk;
  const bool alone = blk.nonempty == 1;  // this split holds every key
  if (!alone && tid < rows) {
    mine[tid] = m_blk[tid];
    mine[kMaxRows + tid] = l_blk[tid];
  }
  for (Walk w(dim); w.j < rows; w.next()) {
    float a = 0.f;
    for (int i = 0; i < parts; ++i) {
      a += part_acc[(i * kMaxRows + w.j) * stride + w.c]
           * wts[i * kMaxRows + w.j];
    }
    if (alone) {
      store_out(p, row_off, w.j, w.c, __fdiv_rn(a, l_blk[w.j]));
    } else {
      mine[2 * kMaxRows + w.j * dim + w.c] = a;
    }
  }
  if (alone) return;
  __syncthreads();
  if (tid == 0) ticket = take_ticket(&p.counters[blk.tile]);
  __syncthreads();
  if (ticket != blk.nonempty - 1) return;
  combine_splits(p, blk,
                 p.ws + static_cast<long long>(blk.tile) * p.splits * chunk,
                 chunk, row_off, scratch);
  if (tid == 0) p.counters[blk.tile] = 0;
}

// ---- CUDA cores: float32 q or a float32 cache, or head_dim % 16 != 0

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Block blk = block_of(p);
  find_keys(p, blk);
  if (blk.split >= blk.nonempty) return;  // every key past the position
  constexpr int kN = kVec ? Chunk<T>::kN : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dim = p.dim;
  const int kt = p.key_tile;
  const int group = blk.group;
  const int rows = blk.rows;
  const int chunks = dim / kN;  // chunks of a key's row
  const bool quant = p.k_scale != nullptr;

  float* small = reinterpret_cast<float*>(smem);
  long long* row_off = reinterpret_cast<long long*>(
      small + (2 + kWarps) * kMaxRows);
  float* q_s = small + small_bytes() / 4;          // rows x dim
  float* acc_s = q_s + kMaxRows * dim;             // rows x dim
  float* sc_s = acc_s + kMaxRows * dim;            // rows x key_tile
  float* part_s = sc_s + kMaxRows * kt;            // kThreads x 16
  float* m_s = part_s + kThreads * 16;             // running max
  float* l_s = m_s + kMaxRows;                     // running sum
  float* corr_s = l_s + kMaxRows;                  // this tile's rescale
  unsigned char* ring = reinterpret_cast<unsigned char*>(corr_s + kMaxRows);
  const long long stage = stage_bytes(kt, p.row_stride);

  // cache elements between two positions, and this (b, kv head)'s first
  const long long pos_elems = static_cast<long long>(p.kv_heads) * dim;
  const long long base =
      (static_cast<long long>(blk.b) * p.seq * p.kv_heads + blk.kvh) * dim;
  const T* k_g = static_cast<const T*>(p.k) + base;
  const T* v_g = static_cast<const T*>(p.v) + base;
  const long long sbase =
      static_cast<long long>(blk.b) * p.seq * p.kv_heads + blk.kvh;

  // the block's tile i into ring stage s: its keys up to k_end only
  auto load_tile = [&](int i, int s) {
    const int s0 = blk.k_begin + i * kt;
    const int n = min(kt, blk.k_end - s0);
    unsigned char* kd = ring + s * stage;
    unsigned char* vd = kd + kt * p.row_stride;
    float* ksc = reinterpret_cast<float*>(vd + kt * p.row_stride);
    if constexpr (kVec) {
      for (Walk w(chunks); w.j < n; w.next()) {
        const long long g = (s0 + w.j) * pos_elems + w.c * kN;
        cp_async16(kd + w.j * p.row_stride + 16 * w.c, k_g + g);
        cp_async16(vd + w.j * p.row_stride + 16 * w.c, v_g + g);
      }
    } else {
      for (Walk w(dim); w.j < n; w.next()) {
        const long long g = (s0 + w.j) * pos_elems + w.c;
        reinterpret_cast<T*>(kd + w.j * p.row_stride)[w.c] = k_g[g];
        reinterpret_cast<T*>(vd + w.j * p.row_stride)[w.c] = v_g[g];
      }
    }
    if (quant) {
      for (int j = tid; j < n; j += kThreads) {
        const long long g =
            sbase + (s0 + j) * static_cast<long long>(p.kv_heads);
        cp_async4(ksc + j, p.k_scale + g);
        cp_async4(ksc + kt + j, p.v_scale + g);
      }
    }
  };

  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < blk.ntiles) load_tile(i, i);
    cp_async_commit();
  }
  // the block's query rows in f32 while the first tiles are in flight,
  // eight loads in flight a thread
  row_offsets(p, blk, row_off);
  __syncthreads();
  for (Walk w(dim); w.j < rows;) {
    float qx[8];
    load_queries(p, blk, row_off, w, qx);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (w.j < rows) {
        q_s[w.j * dim + w.c] = qx[j];
        acc_s[w.j * dim + w.c] = 0.f;
      }
      w.next();
    }
  }
  if (tid < kMaxRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  for (int it = 0; it < blk.ntiles; ++it) {
    cp_async_wait_ring(p.stages);
    __syncthreads();  // tile it is in; every thread is done with it - 1
    if (it + p.stages - 1 < blk.ntiles) {
      load_tile(it + p.stages - 1, (it + p.stages - 1) % p.stages);
    }
    cp_async_commit();
    const int s0 = blk.k_begin + it * kt;
    const int n = min(kt, blk.k_end - s0);
    const unsigned char* kst = ring + (it % p.stages) * stage;
    const unsigned char* vst = kst + kt * p.row_stride;
    const float* ksc = reinterpret_cast<const float*>(vst + kt * p.row_stride);
    const float* vsc = ksc + kt;

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
      const long long last = blk.pos + (blk.row0 + r) / group;
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
    const int shares = max(1, min(n, kThreads / outs));
    if (shares == 1) {
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
      if (tid < outs * shares) {
        const int o = tid % outs;
        const int share = tid / outs;
        const int r = o / chunks;
        const int c = o % chunks;
        float a[kN];
#pragma unroll
        for (int e = 0; e < kN; ++e) a[e] = 0.f;
        for (int j = share; j < n; j += shares) {
          const float w = sc_s[r * kt + j];
          float f[kN];
          load_values<T, kVec>(vst + j * p.row_stride, c, f);
#pragma unroll
          for (int e = 0; e < kN; ++e) a[e] = fmaf(w, f[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          part_s[(share * outs + o) * kN + e] = a[e];
        }
      }
      __syncthreads();
      for (int i = tid; i < outs * kN; i += kThreads) {
        float total = 0.f;
        for (int share = 0; share < shares; ++share) {
          total += part_s[share * outs * kN + i];
        }
        acc_s[i] = fmaf(acc_s[i], corr_s[i / kN / chunks], total);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  finish(p, blk, m_s, l_s, acc_s, dim, 1, small, row_off,
         reinterpret_cast<float*>(ring));
}

// ---- tensor cores: bf16 q over a bf16 or int8 cache, head_dim % 16 == 0
//
// kDimMax (16, 32, 64, 128 or 256) bounds head_dim: a warp's output sums
// are kDimMax / 8 mma tiles of registers, those past head_dim left idle.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of every
// 16 x 8 tile: scores of keys 8j + 2t, + 1 (j = 0, 1: the warp's 16 keys),
// which are also the A fragment of the value product over those keys.

template <typename T, int kDimMax>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int kt = kMmaKeys;
  constexpr int kTiles = kDimMax / 8;  // output column tiles a row
  constexpr int kSteps = kDimMax / 16;  // k steps of a score
  constexpr int kQPer = kMaxRows * kDimMax / kThreads;
  // the queries' A fragments stay in registers up to head_dim 128
  constexpr bool kQInRegs = kDimMax <= 128;
  Block blk = block_of(p);
  float* small = reinterpret_cast<float*>(smem);
  long long* row_off = reinterpret_cast<long long*>(
      small + (2 + kWarps) * kMaxRows);
  row_offsets(p, blk, row_off);
  find_keys(p, blk);  // the position's read overlaps the barrier
  __syncthreads();
  float qx[kQPer];
  load_queries(p, blk, row_off, Walk(p.dim), qx);
  if (blk.split >= blk.nonempty) return;  // every key past the position
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int dim = p.dim;
  const int group = blk.group;
  const int bst = 2 * dim + 16;  // bytes between bf16 rows in shared memory

  unsigned char* q_s = smem + small_bytes();         // 16 rows x bst, bf16
  float* m_w = reinterpret_cast<float*>(q_s + kMaxRows * bst);  // [warp][row]
  float* l_w = m_w + kWarps * kMaxRows;
  unsigned char* cvt =
      reinterpret_cast<unsigned char*>(l_w + kWarps * kMaxRows);
  unsigned char* ring = cvt + (kInt8 ? 2 * kt * bst : 0);
  const long long stage = stage_bytes(kt, p.row_stride);

  const long long pos_elems = static_cast<long long>(p.kv_heads) * dim;
  const long long base =
      (static_cast<long long>(blk.b) * p.seq * p.kv_heads + blk.kvh) * dim;
  const T* k_g = static_cast<const T*>(p.k) + base;
  const T* v_g = static_cast<const T*>(p.v) + base;
  const long long sbase =
      static_cast<long long>(blk.b) * p.seq * p.kv_heads + blk.kvh;
  constexpr int kN = 16 / sizeof(T);
  const int chunks = dim / kN;

  // the block's tile i into ring stage s: keys past k_end are not read,
  // their rows (and scales) filled with zeros
  auto load_tile = [&](int i, int s) {
    const int s0 = blk.k_begin + i * kt;
    const int n = min(kt, blk.k_end - s0);
    unsigned char* kd = ring + s * stage;
    unsigned char* vd = kd + kt * p.row_stride;
    if (kThreads % chunks == 0) {  // a thread keeps its column: no carry
      const int dj = kThreads / chunks;
      const long long step = dj * pos_elems;
      const long long at = (s0 + tid / chunks) * pos_elems + tid % chunks * kN;
      const T* kp = k_g + at;
      const T* vp = v_g + at;
      unsigned char* dst =
          kd + tid / chunks * p.row_stride + tid % chunks * 16;
#pragma unroll 4
      for (int j = tid / chunks; j < kt; j += dj) {
        const bool in = j < n;
        cp_async16(dst, in ? kp : k_g, in);
        cp_async16(dst + kt * p.row_stride, in ? vp : v_g, in);
        kp += step;
        vp += step;
        dst += dj * p.row_stride;
      }
    } else {
      for (Walk w(chunks); w.j < kt; w.next()) {
        const bool in = w.j < n;
        const long long at = in ? (s0 + w.j) * pos_elems + w.c * kN : 0;
        cp_async16(kd + w.j * p.row_stride + 16 * w.c, k_g + at, in);
        cp_async16(vd + w.j * p.row_stride + 16 * w.c, v_g + at, in);
      }
    }
    if constexpr (kInt8) {
      float* ksc = reinterpret_cast<float*>(vd + kt * p.row_stride);
      for (int j = tid; j < kt; j += kThreads) {
        const bool in = j < n;
        const long long at =
            sbase + (in ? (s0 + j) * static_cast<long long>(p.kv_heads) : 0);
        cp_async4(ksc + j, p.k_scale + at, in);
        cp_async4(ksc + kt + j, p.v_scale + at, in);
      }
    }
  };

  float acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float l_r[2] = {0.f, 0.f};
  // each row's last visible key, within the keys the block read
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lim[h] = static_cast<int>(min(
        blk.pos + (blk.row0 + g + 8 * h) / group,
        static_cast<long long>(blk.k_end - 1)));
  }
  const int w0 = 16 * warp;  // the warp's first key in a tile

  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < blk.ntiles) load_tile(i, i);
    cp_async_commit();
  }
  // the block's query rows in bf16 (exact: q is bf16), the rows past
  // `rows` zero, while the first tiles are in flight
  {
    Walk w(dim);
#pragma unroll
    for (int j = 0; j < kQPer; ++j) {
      if (w.j < kMaxRows) {
        reinterpret_cast<__nv_bfloat16*>(q_s + w.j * bst)[w.c] =
            __float2bfloat16_rn(qx[j]);
      }
      w.next();
    }
  }
  // the A fragment of k step ks: rows 0-7 and 8-15 of columns 16 ks .. + 7
  // and + 8 .. + 15
  auto q_fragment = [&](uint32_t (&a)[4], int ks) {
    ldmatrix_x4(a, q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * bst
                       + (16 * ks + (lane >> 4) * 8) * 2);
  };
  uint32_t qa[kQInRegs ? kSteps : 1][4];
  if constexpr (kQInRegs) {
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (16 * ks < dim) q_fragment(qa[ks], ks);
    }
  }
  for (int it = 0; it < blk.ntiles; ++it) {
    cp_async_wait_ring(p.stages);
    __syncthreads();  // tile it is in; every warp is done with it - 1
    if (it + p.stages - 1 < blk.ntiles) {
      load_tile(it + p.stages - 1, (it + p.stages - 1) % p.stages);
    }
    cp_async_commit();
    const int s0 = blk.k_begin + it * kt;
    const unsigned char* kst = ring + (it % p.stages) * stage;
    const float* ksc =
        reinterpret_cast<const float*>(kst + 2 * kt * p.row_stride);
    const float* vsc = ksc + kt;
    const unsigned char* kb = kst;  // the tile's keys and values as bf16
    const unsigned char* vb = kst + kt * p.row_stride;
    if constexpr (kInt8) {
      // the codes to bf16, 16 at a time (exact: |code| <= 127)
      for (Walk w(chunks); w.j < 2 * kt; w.next()) {  // K's rows, then V's
        const int row = w.j;
        const int c = w.c;
        const uint4 u =
            *reinterpret_cast<const uint4*>(kst + row * p.row_stride + 16 * c);
        uint32_t h[8];
        codes_to_bf16(u.x, h[0], h[1]);
        codes_to_bf16(u.y, h[2], h[3]);
        codes_to_bf16(u.z, h[4], h[5]);
        codes_to_bf16(u.w, h[6], h[7]);
        uint4* dst = reinterpret_cast<uint4*>(cvt + row * bst + 32 * c);
        dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
        dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
      kb = cvt;
      vb = cvt + kt * bst;
    }
    const int kst_b = kInt8 ? bst : p.row_stride;
    if (s0 + w0 >= blk.k_end) continue;  // the warp's keys are all past

    // scores of the block's 16 rows against the warp's 16 keys, the even
    // and the odd k steps in two chains of products
    float s[2][4];
    float s_odd[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        s_odd[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (16 * ks < dim) {
        uint32_t a[4];
        uint32_t b[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[x] = qa[ks][x];
        } else {
          q_fragment(a, ks);
        }
        ldmatrix_x4(b, kb + (w0 + (lane & 7) + (lane >> 4) * 8) * kst_b
                           + (16 * ks + ((lane >> 3) & 1) * 8) * 2);
        float (&d)[2][4] = ks % 2 == 0 ? s : s_odd;
        mma_bf16(d[0], a, b[0], b[1]);
        mma_bf16(d[1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_odd[j][e];
    }

    // the online softmax of rows g and g + 8 over the warp's keys; a
    // row's 16 keys lie in the quad of lanes 4g .. 4g + 3
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = w0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * p.scale;
        if constexpr (kInt8) x *= ksc[kj];
        s[j][e] = s0 + kj <= lim[e >> 1] ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = m_new == -INFINITY ? 1.f : __expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float w =
            s[j][e] == -INFINITY ? 0.f : __expf(s[j][e] - m_r[h]);
        sum[h] += w;
        // the V scale folds into the weight, not into the softmax's sum
        if constexpr (kInt8) {
          s[j][e] = w * vsc[w0 + 8 * j + 2 * t4 + (e & 1)];
        } else {
          s[j][e] = w;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = l_r[h] * corr[h] + sum[h];
    }

    // acc = acc * corr + weights x values, the weights as hi + lo bf16
    uint32_t a[4];
    uint32_t a_lo[4];
    split_bf16(s[0][0], s[0][1], a[0], a_lo[0]);
    split_bf16(s[0][2], s[0][3], a[1], a_lo[1]);
    split_bf16(s[1][0], s[1][1], a[2], a_lo[2]);
    split_bf16(s[1][2], s[1][3], a[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < kTiles; j += 2) {
      if (8 * j < dim) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (w0 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                      * kst_b
                                 + (8 * j + (lane >> 4) * 8) * 2);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j], a_lo, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
        mma_bf16(acc[j + 1], a_lo, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' sums

  // [warp][row][dim + 4]: the pad spreads rows g = 0..7 over the banks
  float* acc_w = reinterpret_cast<float*>(ring);
  const int acc_stride = dim + 4;
  if (t4 == 0) {
    m_w[warp * kMaxRows + g] = m_r[0];
    m_w[warp * kMaxRows + g + 8] = m_r[1];
    l_w[warp * kMaxRows + g] = l_r[0];
    l_w[warp * kMaxRows + g + 8] = l_r[1];
  }
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int c = 8 * j + 2 * t4;
    if (c < dim) {
      float* r0 = acc_w + (warp * kMaxRows + g) * acc_stride + c;
      float* r8 = r0 + 8 * acc_stride;
      r0[0] = acc[j][0];
      r0[1] = acc[j][1];
      r8[0] = acc[j][2];
      r8[1] = acc[j][3];
    }
  }
  __syncthreads();
  // the split's combine reuses the ring once the warps' sums are read
  finish(p, blk, m_w, l_w, acc_w, acc_stride, kWarps, small, row_off,
         acc_w);
}

using KernelFn = void (*)(Params);

// The instance that runs a launch: the route, the cache's dtype, the
// loads and, on the tensor cores, the head_dim bound.
template <typename T>
KernelFn mma_instance(int dim) {
  if (dim <= 16) return decode_attention_mma_kernel<T, 16>;
  if (dim <= 32) return decode_attention_mma_kernel<T, 32>;
  if (dim <= 64) return decode_attention_mma_kernel<T, 64>;
  if (dim <= 128) return decode_attention_mma_kernel<T, 128>;
  return decode_attention_mma_kernel<T, 256>;
}

KernelFn instance(int route, int cache_dtype, bool vec, int dim) {
  if (route == 1) {
    return cache_dtype == 1 ? mma_instance<__nv_bfloat16>(dim)
                            : mma_instance<int8_t>(dim);
  }
  if (cache_dtype == 0) {
    return vec ? decode_attention_kernel<float, true>
               : decode_attention_kernel<float, false>;
  }
  if (cache_dtype == 1) {
    return vec ? decode_attention_kernel<__nv_bfloat16, true>
               : decode_attention_kernel<__nv_bfloat16, false>;
  }
  return vec ? decode_attention_kernel<int8_t, true>
             : decode_attention_kernel<int8_t, false>;
}

}  // namespace

// q (B, T, heads, dim) of q_dtype (0 float32, 1 bfloat16); k, v (B, S,
// kv_heads, dim) of cache_dtype (0 float32, 1 bfloat16, 2 int8) with, for
// int8, k_scale and v_scale (B, S, kv_heads) float32; out (B, T, heads,
// dim) of out_dtype (0, 1); all contiguous. The position is *pos (int64 on
// the device) or, when pos is null, pos_value. The launch
// (kernels/decode_attention.py::plan): route (0 CUDA cores, 1 tensor
// cores: bf16 q, a bf16 or int8 cache, dim % 16 == 0, 64-key tiles, rows
// staged with a 16-byte pad for bf16 and none for int8), vec (16-byte
// loads: rows of a multiple of 16 bytes, k and v 16-byte aligned),
// key_tile keys a tile (8 to 64, even),
// row_stride bytes between staged rows (a multiple of 16 holding a row),
// stages tiles in the ring (2 to 4), within the card's shared memory; and
// splits blocks (at most the key tiles of seq) that share each group's
// visible keys, with, when splits > 1, the workspace ws of B * kv_heads *
// row_tiles * splits * (32 + 16 * dim) floats and n_counters >= B *
// kv_heads * row_tiles ints, all 0, which every launch leaves 0.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* pos, long long pos_value,
    void* ws, void* counters, int n_counters, int batch, int t_new,
    int heads, int kv_heads, int seq, int dim, int q_dtype, int cache_dtype,
    int out_dtype, int route, int vec, int key_tile, int row_stride,
    int stages, int splits, float scale, void* stream) {
  if (batch < 1 || t_new < 1 || heads < 1 || kv_heads < 1 || seq < 1
      || dim < 2 || dim % 2 || heads % kv_heads || batch > 65535
      || kv_heads > 65535 || q_dtype < 0 || q_dtype > 1 || out_dtype < 0
      || out_dtype > 1 || cache_dtype < 0 || cache_dtype > 2
      || key_tile < 8 || key_tile > 64 || key_tile % 2
      || row_stride % 16 || stages < 2 || stages > 4 || route < 0
      || route > 1 || splits < 1 || splits > kMaxSplits
      || splits > (seq + key_tile - 1) / key_tile) {
    return cudaErrorInvalidValue;
  }
  const int esize = cache_dtype == 0 ? 4 : cache_dtype == 1 ? 2 : 1;
  const int row_bytes = dim * esize;
  const long long row_tiles =
      (static_cast<long long>(t_new) * (heads / kv_heads) + kMaxRows - 1)
      / kMaxRows;
  const long long smem =
      route == 1 ? smem_bytes_mma(dim, cache_dtype == 2, row_stride, stages)
                 : smem_bytes_cuda(dim, key_tile, row_stride, stages);
  if (row_stride < row_bytes || smem > kMaxSmem
      || row_tiles * splits > 0x7fffffffLL
      || (cache_dtype == 2) != (k_scale != nullptr && v_scale != nullptr)
      || (vec && (row_bytes % 16 != 0
                  || reinterpret_cast<uintptr_t>(k) % 16 != 0
                  || reinterpret_cast<uintptr_t>(v) % 16 != 0))
      || (route == 1
          && (q_dtype != 1 || cache_dtype == 0 || dim % 16 || dim > 256
              || !vec || key_tile != kMmaKeys
              || row_stride != row_bytes + (cache_dtype == 1 ? 16 : 0)))
      || (splits > 1
          && (ws == nullptr || counters == nullptr
              || static_cast<long long>(batch) * kv_heads * row_tiles
                     > n_counters))) {
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
           static_cast<float*>(ws),
           static_cast<int*>(counters),
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
           stages,
           splits,
           scale};
  const KernelFn kernel = instance(route, cache_dtype, vec != 0, dim);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(row_tiles * splits), kv_heads, batch);
  kernel<<<grid, kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The text of a cudaError_t that decode_attention returned.
extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

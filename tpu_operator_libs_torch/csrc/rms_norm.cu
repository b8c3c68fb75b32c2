// RMSNorm with the residual add folded in, forward and backward.
//
// rms_norm_fwd: s = h + delta (rounded to the residual stream's dtype),
// then
//   rstd = 1 / sqrt(mean(s^2) + eps),   y = round(round(s * rstd) * w)
// writing s, y and, when a gradient is wanted, rstd (float32, one a row).
// Replaces tpu_operator_libs/examples/llama.py::_rms_norm (:108-114) and
// the residual adds before it (llama.py:307, 312; llama_decode.py:247,
// 253), which XLA fuses on the TPU (no Pallas source). Without delta it
// is the norm alone (s = h, not written).
//
// rms_norm_bwd: from dy, the normalised input x (= s), w, rstd and the
// incoming gradient of the residual output ds (when the add was fused):
//   g = dy * w,   c = sum_j g_j x_j,
//   dx = rstd * (g - x * (rstd^2 * c / dim)) + ds,
//   dw_j = sum over rows of dy_j * round(x_j * rstd).
// dw sums every row (16,384 at the train shape) in a fixed order, with no
// float atomics, so two launches, or a replayed graph, give the same bits:
// each thread adds dy * round(x * rstd) of its columns over the rows it
// takes, in row order; a block adds its groups' sums in group order (one
// exchange through shared memory, after the last row) into its partial;
// then a two-level ticket combine: the blocks fall into combine groups of
// blocks_per_group consecutive blocks, and the block that draws the last
// ticket of its group adds the group's partials in block order; where
// there are several groups, the group combiner that draws the last ticket
// of the second level adds the groups' sums in group order and writes dw.
// Every counter is back at 0 when the launch ends.
//
// Rounding follows the reference: the sum is rounded to the residual
// stream's dtype before it is normalised; the variance is the float32
// mean of squares (summed in a fixed order: a thread's elements in order,
// the warp by a butterfly, the warps in order); rstd takes IEEE sqrt and
// reciprocal (__fsqrt_rn, __frcp_rn), as torch.sqrt and torch.reciprocal;
// s * rstd is rounded to the dtype before the weight multiply, which is
// rounded again. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction) except the row sums, whose order differs
// from PyTorch's anyway.
//
// Forward design: bytes-bound (a row of 2,048 is read and written once,
// tiny compute), and at the decode step's 8 rows bound by its chain of
// latencies. A group of `threads_per_row` threads (a multiple of 32, at
// most 256) takes a row, each thread kVec neighbouring elements a load (8
// or 4 with vector loads, 1 when the width or an address does not allow
// them); `rows_per_block` groups share a block, and the blocks stride over
// the groups of rows (the plan sizes the grid: the SMs times the resident
// blocks, or with the add a block for every group). On the register path
// each thread holds kLoads vectors of the row (vector c = t + i *
// threads_per_row): every load of a row (h, then delta) is issued before
// any arithmetic, the row stays in registers from the sum to the scaling
// (as packed bfloat16 where every tensor is bfloat16, which halves the
// registers it holds), and the thread's columns of w are loaded once,
// first, for every row it takes. The sum takes one barrier a row (the
// warps' sums double-buffered by the row's parity), none where one warp
// holds the row. On the H100, 256 threads a row with one vector each were
// fastest while the rows fit one wave at a row a block (the decode step,
// the prefill block), 128 threads with two (two rows a block) past that
// (the train step), and one warp a row with eight slower at each
// (kernels/rms_norm.py plan). Rows wider than kMaxLoads vectors a thread
// take the two-pass loop (kLoads 0): the row read twice, the second time
// from L1 or L2.
//
// Backward design: bytes-bound as well (dy, x and ds read once, dx
// written once), and the train step's shape is its main use. It keeps the
// forward's layout: a group of threads_per_row threads a row, kLoads
// vectors a thread on the register path, rows_per_block groups a block
// (up to 512 threads), and a grid of the SMs times the resident blocks,
// each group taking rows row0, row0 + stride, ... (stride = blocks *
// rows_per_block). A thread
// loads its columns of w once, first; each row's dy, x, ds (when given)
// and rstd are loaded before any of its arithmetic and held in registers
// (packed bfloat16 where every tensor is bfloat16) from the row sum to the
// store of dx; the next row's loads are issued before the current row's
// sum and arithmetic (two rows held, double-buffered in registers), so
// each group keeps a row in flight while it computes another. The row sum
// takes the group's own named barrier (none for a warp a row), never a
// block-wide one. dw's column sums stay in registers (kLoads * kVec a
// thread) over every row a thread takes. Rows wider than kMaxLoads vectors
// a thread take the two-pass loop (kLoads 0, a row a block): the sum, then
// dx from the row read again, dw's sums in shared memory. On the H100, at
// the train shape, 128 threads a row with two vectors each and four rows
// a block (one block an SM) measured fastest of 256 x 1, 128 x 2, 64 x 4
// and one warp x 8, and the two-level combine faster than one level; the
// combine is a chain of dependent memory round trips after the grid's
// last row (a fence, a ticket, the partials' loads, twice). No programmatic
// dependent launch: the backward follows a cuBLAS product, which never
// triggers its dependents (the forward measured the attribute a loss
// there).
//
// Launched with programmatic dependent launch (dependent_launch.cuh):
// before the wait only the offsets (w may be written by the kernel just
// before, an optimizer step or a cast, so it is not read before the wait;
// an L2 prefetch of its lines there measured no gain after the product and
// a loss at the prefill and train shapes); every store after it. Dtypes
// are run-time codes: h, delta and w may each be float32 or bfloat16, the
// outputs take PyTorch's promoted dtypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dependent_launch.cuh"
#include "ticket.cuh"
#include "vector_io.cuh"

namespace {

using dependent_launch::launch_dependents;
using dependent_launch::wait_for_prerequisites;
using vector_io::load;
using vector_io::round_to;
using vector_io::store;

// a forward block's threads at most, and the vectors of a row a thread
// holds at most on the register path: rows up to 4 x 256 vectors (8,192
// elements at 8 a load, 4,096 at 4, 1,024 at 1)
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kMaxLoads = 4;
// a backward block's threads at most: 512 where a thread holds at most 8
// registers of each array of a row (loads * vec elements, two to a
// register where packed), which keeps an instance within 128 registers,
// else 256; and the combine's groups of blocks at most (a stream's
// counters: one a group and one for the second level)
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int backward_threads(int vec, int loads, bool packed) {
  return loads * vec > (packed ? 16 : 8) ? 256 : kBwdThreads;
}
constexpr int kMaxCombineGroups = 64;

struct FwdParams {
  const void* h;      // (rows, dim) of h_dtype
  const void* delta;  // (rows, dim) of delta_dtype, or null
  const void* w;      // (dim,) of w_dtype
  void* s;            // (rows, dim) of s_dtype, h + delta; null without
  void* y;            // (rows, dim) of y_dtype
  float* rstd;        // (rows,), or null
  int rows, dim, threads_per_row, rows_per_block;
  float eps;
  int h_dtype, delta_dtype, w_dtype, s_dtype, y_dtype;  // 0 f32, 1 bf16
};

struct BwdParams {
  const void* dy;    // (rows, dim) of dy_dtype
  const void* x;     // (rows, dim) of x_dtype, the normalised input
  const void* w;     // (dim,) of w_dtype
  const float* rstd;  // (rows,)
  const void* ds;    // (rows, dim) of ds_dtype, or null
  void* dx;          // (rows, dim) of x_dtype
  void* dw;          // (dim,) of w_dtype
  float* ws;         // (blocks + groups, dim): the blocks' partial dw,
                     // then the combine groups' sums
  int* counters;     // groups + 1 ticket counters, 0 between launches
  int rows, dim, threads_per_row, rows_per_block, blocks_per_group;
  int dy_dtype, x_dtype, w_dtype, ds_dtype;
};

// The row's sum of v over its group of `warps` warps in a fixed order: a
// butterfly within each warp (every lane gets the same bits), then the
// group's warps in order through `sums[parity]`. One barrier, the
// group's own (a named barrier of its warps, so the block's other rows
// do not wait on it), which every thread of the group reaches; a row of
// one warp takes none. The slots alternate with the row's parity, so a
// row's writes never meet the previous row's reads.
template <int kSlots>
__device__ __forceinline__ float row_sum(float v, int warps, int group,
                                         int parity,
                                         float (*sums)[kSlots]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) sums[parity][threadIdx.x >> 5] = v;
  // barrier 0 is __syncthreads'; a group's is 1 + group (at most 8)
  asm volatile("bar.sync %0, %1;\n" : : "r"(group + 1), "r"(warps * 32)
               : "memory");
  float total = 0.f;
  for (int i = 0; i < warps; ++i) {
    total = __fadd_rn(total, sums[parity][group * warps + i]);
  }
  return total;
}

// 1 / sqrt(mean + eps) with IEEE division, sqrt and reciprocal
__device__ __forceinline__ float inverse_rms(float total, int dim,
                                             float eps) {
  const float var = __fdiv_rn(total, static_cast<float>(dim));
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// A vector of kVec elements as a thread holds it between its load and
// its arithmetic: any dtype, converted to float32 as it is loaded
template <int kVec>
struct FloatVec {
  float v[kVec];

  __device__ __forceinline__ void load(const void* p, long long i,
                                       int dtype) {
    vector_io::load<kVec>(p, i, dtype, v);
  }
  __device__ __forceinline__ float at(int e) const { return v[e]; }
  // x exactly representable in the dtype the vector was loaded as
  __device__ __forceinline__ void set(int e, float x) { v[e] = x; }
};

// 8 bfloat16 as one 16-byte load brought them, two to a register: a
// bfloat16 is the high half of the float32 with the same bits
struct Bf16x8 {
  uint32_t w[4];

  __device__ __forceinline__ void load(const void* p, long long i, int) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
  __device__ __forceinline__ float at(int e) const {
    return __uint_as_float(e % 2 == 0 ? w[e / 2] << 16
                                      : w[e / 2] & 0xffff0000u);
  }
  // x a bfloat16 value (its low 16 bits zero)
  __device__ __forceinline__ void set(int e, float x) {
    const uint32_t bits = __float_as_uint(x);
    w[e / 2] = e % 2 == 0 ? (w[e / 2] & 0xffff0000u) | (bits >> 16)
                          : (w[e / 2] & 0xffffu) | bits;
  }
};

// The vectors of the register path: packed bfloat16 where every tensor
// is bfloat16 at 8 a load (the model's own dtype), float32 otherwise
template <int kVec, bool kBf16>
using Vec = typename std::conditional<kBf16, Bf16x8, FloatVec<kVec>>::type;

// One row of the register path as loaded: h (then h + delta) and delta,
// kLoads vectors a thread (vector c = t + i * threads_per_row)
template <int kVec, int kLoads, bool kBf16>
struct HeldRow {
  Vec<kVec, kBf16> x[kLoads];
  Vec<kVec, kBf16> d[kLoads];
};

// Issues every load of `row` into r, h then delta (nothing past the
// last row).
template <int kVec, int kLoads, bool kBf16>
__device__ __forceinline__ void load_row(const FwdParams& p, int row, int t,
                                         int chunks,
                                         HeldRow<kVec, kLoads, kBf16>& r) {
  if (row >= p.rows) return;
  const long long off = static_cast<long long>(row) * p.dim;
  const int tpr = p.threads_per_row;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) r.x[i].load(p.h, off + c * kVec, p.h_dtype);
  }
  if (p.delta == nullptr) return;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) r.d[i].load(p.delta, off + c * kVec, p.delta_dtype);
  }
}

// The add, the sum (one barrier, which every thread of the row's group
// reaches, live or not), the scaling and every store of `row` from r.
template <int kVec, int kLoads, bool kBf16>
__device__ __forceinline__ void finish_row(
    const FwdParams& p, int row, int t, int chunks, int group, int parity,
    float (*sums)[kFwdWarps], HeldRow<kVec, kLoads, kBf16>& r,
    const Vec<kVec, kBf16> (&w)[kLoads]) {
  const int tpr = p.threads_per_row;
  const bool live = row < p.rows;
  const long long off = static_cast<long long>(row) * p.dim;
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = t + i * tpr;
      if (c >= chunks) continue;
      if (p.delta != nullptr) {
        float s[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s[e] = round_to(__fadd_rn(r.x[i].at(e), r.d[i].at(e)), p.s_dtype);
          r.x[i].set(e, s[e]);
        }
        store<kVec>(p.s, off + c * kVec, p.s_dtype, s);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ss = __fmaf_rn(r.x[i].at(e), r.x[i].at(e), ss);
      }
    }
  }
  const float total = row_sum(ss, tpr >> 5, group, parity, sums);
  if (!live) return;
  const float rs = inverse_rms(total, p.dim, p.eps);
  if (p.rstd != nullptr && t == 0) p.rstd[row] = rs;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = t + i * tpr;
    if (c >= chunks) continue;
    float y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      y[e] = __fmul_rn(round_to(__fmul_rn(r.x[i].at(e), rs), p.s_dtype),
                       w[i].at(e));
    }
    store<kVec>(p.y, off + c * kVec, p.y_dtype, y);
  }
}

// kLoads > 0: the register path (kLoads vectors a thread, packed where
// kBf16); kLoads == 0: the two-pass loop for wider rows.
template <int kVec, int kLoads, bool kBf16>
__global__ void __launch_bounds__(kFwdThreads)
    rms_norm_fwd_kernel(const FwdParams p) {
  __shared__ float sums[2][kFwdWarps];
  const int tpr = p.threads_per_row;
  const int group = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const int chunks = p.dim / kVec;
  const int tiles = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  const int rpb = p.rows_per_block;
  // nothing is read before the wait: h and delta are the products just
  // before, and w may be written by the kernel before (an optimizer
  // step, a cast)
  wait_for_prerequisites();
  if constexpr (kLoads > 0) {
    // the thread's columns of w, first: every row it takes scales by them
    Vec<kVec, kBf16> w[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = t + i * tpr;
      if (c < chunks) w[i].load(p.w, c * kVec, p.w_dtype);
    }
    HeldRow<kVec, kLoads, kBf16> r;
    int parity = 0;
    for (int tile = blockIdx.x; tile < tiles;
         tile += gridDim.x, parity ^= 1) {
      load_row(p, tile * rpb + group, t, chunks, r);
      if (tile + static_cast<int>(gridDim.x) >= tiles) launch_dependents();
      finish_row(p, tile * rpb + group, t, chunks, group, parity, sums, r,
                 w);
    }
  } else {
    // two passes: the sum (writing s), then the scaling from s or h
    // again; the grid triggers its dependents as it exits
    const bool add = p.delta != nullptr;
    int parity = 0;
    for (int tile = blockIdx.x; tile < tiles;
         tile += gridDim.x, parity ^= 1) {
      const int row = tile * p.rows_per_block + group;
      const bool live = row < p.rows;
      const long long off = static_cast<long long>(row) * p.dim;
      float ss = 0.f;
      if (live) {
        for (int c = t; c < chunks; c += tpr) {
          float x[kVec];
          load<kVec>(p.h, off + c * kVec, p.h_dtype, x);
          if (add) {
            float d[kVec];
            load<kVec>(p.delta, off + c * kVec, p.delta_dtype, d);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              x[e] = round_to(__fadd_rn(x[e], d[e]), p.s_dtype);
            }
            store<kVec>(p.s, off + c * kVec, p.s_dtype, x);
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e) ss = __fmaf_rn(x[e], x[e], ss);
        }
      }
      const float total = row_sum(ss, tpr >> 5, group, parity, sums);
      if (!live) continue;
      const float r = inverse_rms(total, p.dim, p.eps);
      if (p.rstd != nullptr && t == 0) p.rstd[row] = r;
      // the sum this thread wrote above, or h again
      const void* src = add ? p.s : p.h;
      for (int c = t; c < chunks; c += tpr) {
        float x[kVec], w[kVec];
        load<kVec>(src, off + c * kVec, p.s_dtype, x);
        load<kVec>(p.w, c * kVec, p.w_dtype, w);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          x[e] = __fmul_rn(round_to(__fmul_rn(x[e], r), p.s_dtype), w[e]);
        }
        store<kVec>(p.y, off + c * kVec, p.y_dtype, x);
      }
    }
  }
}

// One row of the backward's register path as loaded: dy, x and ds (kDs),
// kLoads vectors a thread (vector c = t + i * threads_per_row), and rstd
template <int kVec, int kLoads, bool kBf16, bool kDs>
struct BwdRow {
  Vec<kVec, kBf16> dy[kLoads];
  Vec<kVec, kBf16> x[kLoads];
  Vec<kVec, kBf16> ds[kDs ? kLoads : 1];
  float rstd;
};

// Issues every load of `row` into r (nothing past the last row).
template <int kVec, int kLoads, bool kBf16, bool kDs>
__device__ __forceinline__ void load_bwd_row(
    const BwdParams& p, int row, int t, int chunks,
    BwdRow<kVec, kLoads, kBf16, kDs>& r) {
  if (row >= p.rows) return;
  const long long off = static_cast<long long>(row) * p.dim;
  const int tpr = p.threads_per_row;
  r.rstd = p.rstd[row];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) r.dy[i].load(p.dy, off + c * kVec, p.dy_dtype);
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) r.x[i].load(p.x, off + c * kVec, p.x_dtype);
  }
  if constexpr (kDs) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = t + i * tpr;
      if (c < chunks) r.ds[i].load(p.ds, off + c * kVec, p.ds_dtype);
    }
  }
}

// The row sum (the group's barrier, which every thread of the group
// reaches: a group's row is live for all its threads or none), dx's store
// and the thread's dw sums of a live `row` from r.
template <int kVec, int kLoads, bool kBf16, bool kDs>
__device__ __forceinline__ void finish_bwd_row(
    const BwdParams& p, int row, int t, int chunks, int group, int parity,
    float (*sums)[kBwdWarps], const BwdRow<kVec, kLoads, kBf16, kDs>& r,
    const Vec<kVec, kBf16> (&w)[kLoads], float (&acc)[kLoads][kVec]) {
  const int tpr = p.threads_per_row;
  const long long off = static_cast<long long>(row) * p.dim;
  float cs = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    if (t + i * tpr >= chunks) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      cs = __fmaf_rn(__fmul_rn(r.dy[i].at(e), w[i].at(e)), r.x[i].at(e), cs);
    }
  }
  const float total = row_sum(cs, tpr >> 5, group, parity, sums);
  const float rs = r.rstd;
  const float k = __fdiv_rn(__fmul_rn(__fmul_rn(rs, rs), total),
                            static_cast<float>(p.dim));
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = t + i * tpr;
    if (c >= chunks) continue;
    float dx[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float dy = r.dy[i].at(e), x = r.x[i].at(e);
      const float g = __fmul_rn(dy, w[i].at(e));
      const float v = __fmul_rn(rs, __fsub_rn(g, __fmul_rn(x, k)));
      if constexpr (kDs) {
        dx[e] = __fadd_rn(v, r.ds[i].at(e));
      } else {
        dx[e] = v;
      }
      const float n = round_to(__fmul_rn(x, rs), p.x_dtype);
      acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(dy, n));
    }
    store<kVec>(p.dx, off + c * kVec, p.x_dtype, dx);
  }
}

// The sum of n rows of dim floats from L2 (written by other blocks of
// this launch), in row order from 0, into out, or rounded into dw. A
// thread takes four neighbouring columns at a time (one where dim is not
// a multiple of 4) and issues the loads of up to kRowsInFlight rows
// before their sums: the combine is a chain of L2 round trips after the
// grid's last row, so it is bound by their latency, not by bytes.
constexpr int kRowsInFlight = 16;

__device__ __forceinline__ void put(const BwdParams& p, float* out, int j,
                                    float v) {
  if (out != nullptr) {
    out[j] = v;
  } else {
    float one[1] = {v};
    store<1>(p.dw, j, p.w_dtype, one);
  }
}

__device__ __forceinline__ void sum_partials(const float* rows, int n,
                                             int dim, float* out,
                                             const BwdParams& p) {
  const bool quads = dim % 4 == 0;
  const int width = quads ? 4 : 1;
  for (int j = threadIdx.x * width; j < dim;
       j += static_cast<int>(blockDim.x) * width) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b0 = 0; b0 < n; b0 += kRowsInFlight) {
      float4 part[kRowsInFlight];
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const float* at = rows + static_cast<long long>(b0 + i) * dim + j;
        if (b0 + i < n) {
          part[i] = quads ? __ldcg(reinterpret_cast<const float4*>(at))
                          : make_float4(__ldcg(at), 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        if (b0 + i < n) {
          v.x = __fadd_rn(v.x, part[i].x);
          v.y = __fadd_rn(v.y, part[i].y);
          v.z = __fadd_rn(v.z, part[i].z);
          v.w = __fadd_rn(v.w, part[i].w);
        }
      }
    }
    put(p, out, j, v.x);
    if (quads) {
      put(p, out, j + 1, v.y);
      put(p, out, j + 2, v.z);
      put(p, out, j + 3, v.w);
    }
  }
}

// The two-level combine of the blocks' partials (written before) into dw,
// each level in a fixed order; every counter it takes is left at 0.
__device__ __forceinline__ void combine(const BwdParams& p, int* ticket) {
  const int blocks = gridDim.x;
  const int per = p.blocks_per_group;
  const int groups = (blocks + per - 1) / per;
  const int g = blockIdx.x / per;
  const int first = g * per;
  const int n = min(per, blocks - first);
  if (!tickets::last(p.counters + g, n, ticket)) return;
  // the group's partials in block order: dw itself for a single group
  sum_partials(p.ws + static_cast<long long>(first) * p.dim, n, p.dim,
               groups == 1 ? nullptr
                           : p.ws + static_cast<long long>(blocks + g) * p.dim,
               p);
  if (threadIdx.x == 0) p.counters[g] = 0;
  if (groups == 1) return;
  if (!tickets::last(p.counters + groups, groups, ticket)) return;
  // the groups' sums in group order
  sum_partials(p.ws + static_cast<long long>(blocks) * p.dim, groups, p.dim,
               nullptr, p);
  if (threadIdx.x == 0) p.counters[groups] = 0;
}

// kLoads > 0: the register path (kLoads vectors a thread, packed where
// kBf16); kLoads == 0: the two-pass loop for wider rows (a row a block).
// kDs: ds is given and added into dx.
template <int kVec, int kLoads, bool kBf16, bool kDs>
__global__ void __launch_bounds__(backward_threads(kVec, kLoads, kBf16))
    rms_norm_bwd_kernel(const BwdParams p) {
  // dim floats: the groups' exchange of dw (register path), or the
  // block's dw sums (two passes)
  extern __shared__ float buf[];
  __shared__ float sums[2][kBwdWarps];
  __shared__ int ticket;
  const int tpr = p.threads_per_row;
  const int group = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const int chunks = p.dim / kVec;
  const int stride = static_cast<int>(gridDim.x) * p.rows_per_block;
  float* partial = p.ws + static_cast<long long>(blockIdx.x) * p.dim;
  int row = blockIdx.x * p.rows_per_block + group;
  int parity = 0;
  if constexpr (kLoads > 0) {
    // the thread's columns of w, first: every row it takes needs them
    Vec<kVec, kBf16> w[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = t + i * tpr;
      if (c < chunks) w[i].load(p.w, c * kVec, p.w_dtype);
    }
    float acc[kLoads][kVec];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
    }
    // two rows held: the next one's loads go out before this one's sum
    BwdRow<kVec, kLoads, kBf16, kDs> a, b;
    load_bwd_row(p, row, t, chunks, a);
    while (row < p.rows) {
      load_bwd_row(p, row + stride, t, chunks, b);
      finish_bwd_row(p, row, t, chunks, group, parity, sums, a, w, acc);
      row += stride;
      parity ^= 1;
      if (row >= p.rows) break;
      load_bwd_row(p, row + stride, t, chunks, a);
      finish_bwd_row(p, row, t, chunks, group, parity, sums, b, w, acc);
      row += stride;
      parity ^= 1;
    }
    // the block's partial: its groups' sums in group order, the last
    // group's added straight into the partial
    for (int turn = 0; turn < p.rows_per_block; ++turn) {
      if (group == turn) {
        const bool last = turn == p.rows_per_block - 1;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int c = t + i * tpr;
          if (c >= chunks) continue;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int j = c * kVec + e;
            const float v =
                turn == 0 ? acc[i][e] : __fadd_rn(buf[j], acc[i][e]);
            if (last) {
              partial[j] = v;
            } else {
              buf[j] = v;
            }
          }
        }
      }
      if (turn + 1 < p.rows_per_block) __syncthreads();
    }
  } else {
    // two passes (rows_per_block 1): the sum, then dx from the row read
    // again (from L1 or L2); the thread's dw sums in buf, its own columns
    for (int c = t; c < chunks; c += tpr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) buf[c * kVec + e] = 0.f;
    }
    for (; row < p.rows; row += stride, parity ^= 1) {
      const long long off = static_cast<long long>(row) * p.dim;
      float cs = 0.f;
      for (int c = t; c < chunks; c += tpr) {
        float dy[kVec], x[kVec], w[kVec];
        load<kVec>(p.dy, off + c * kVec, p.dy_dtype, dy);
        load<kVec>(p.x, off + c * kVec, p.x_dtype, x);
        load<kVec>(p.w, c * kVec, p.w_dtype, w);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          cs = __fmaf_rn(__fmul_rn(dy[e], w[e]), x[e], cs);
        }
      }
      const float total = row_sum(cs, tpr >> 5, group, parity, sums);
      const float r = p.rstd[row];
      const float k = __fdiv_rn(__fmul_rn(__fmul_rn(r, r), total),
                                static_cast<float>(p.dim));
      for (int c = t; c < chunks; c += tpr) {
        float dy[kVec], x[kVec], w[kVec], dx[kVec];
        load<kVec>(p.dy, off + c * kVec, p.dy_dtype, dy);
        load<kVec>(p.x, off + c * kVec, p.x_dtype, x);
        load<kVec>(p.w, c * kVec, p.w_dtype, w);
        if constexpr (kDs) load<kVec>(p.ds, off + c * kVec, p.ds_dtype, dx);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float g = __fmul_rn(dy[e], w[e]);
          const float v = __fmul_rn(r, __fsub_rn(g, __fmul_rn(x[e], k)));
          if constexpr (kDs) {
            dx[e] = __fadd_rn(v, dx[e]);
          } else {
            dx[e] = v;
          }
          const float n = round_to(__fmul_rn(x[e], r), p.x_dtype);
          float* a = buf + c * kVec + e;
          *a = __fadd_rn(*a, __fmul_rn(dy[e], n));
        }
        store<kVec>(p.dx, off + c * kVec, p.x_dtype, dx);
      }
    }
    for (int c = t; c < chunks; c += tpr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        partial[c * kVec + e] = buf[c * kVec + e];
      }
    }
  }
  combine(p, &ticket);
}

bool dtype_ok(int dtype) { return dtype == 0 || dtype == 1; }

// PyTorch's promotion of two of the codes: float32 if either is
int promoted(int a, int b) { return a == 0 || b == 0 ? 0 : 1; }

bool layout_ok(int rows, int dim, int vec, int threads_per_row,
               int rows_per_block, int max_threads) {
  return rows >= 1 && dim >= 1 && (vec == 1 || vec == 4 || vec == 8)
         && dim % vec == 0 && threads_per_row >= 32
         && threads_per_row % 32 == 0 && threads_per_row <= 256
         && rows_per_block >= 1
         && threads_per_row * rows_per_block <= max_threads;
}

template <typename Kernel>
int launch(Kernel kernel, unsigned blocks, int threads, size_t smem,
           void* stream, const void* params) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  void* args[] = {const_cast<void*>(params)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), blocks,
                          threads, args, smem,
                          static_cast<cudaStream_t>(stream));
}

// The forward instance for vec elements a load and `loads` vectors a
// thread (0: the two-pass loop), packed bfloat16 or not, or null
using FwdKernel = void (*)(FwdParams);

template <int kVec, bool kBf16>
FwdKernel forward_instance(int loads) {
  if (kBf16 && loads == 0) return nullptr;  // the two passes hold nothing
  switch (loads) {
    case 0: return rms_norm_fwd_kernel<kVec, 0, false>;
    case 1: return rms_norm_fwd_kernel<kVec, 1, kBf16>;
    case 2: return rms_norm_fwd_kernel<kVec, 2, kBf16>;
    case kMaxLoads: return rms_norm_fwd_kernel<kVec, kMaxLoads, kBf16>;
    default: return nullptr;
  }
}

// Whether the register path holds its vectors packed: every tensor
// bfloat16 (so are s and y) at 8 a load
bool packs(int vec, int loads, int h_dtype, int delta_dtype, int w_dtype) {
  return vec == 8 && loads > 0 && h_dtype == 1 && delta_dtype == 1
         && w_dtype == 1;
}

FwdKernel forward_kernel(int vec, int loads, bool bf16) {
  if (vec == 8) {
    return bf16 ? forward_instance<8, true>(loads)
                : forward_instance<8, false>(loads);
  }
  if (bf16) return nullptr;
  if (vec == 4) return forward_instance<4, false>(loads);
  if (vec == 1) return forward_instance<1, false>(loads);
  return nullptr;
}

// The backward instance for vec, loads (0: the two-pass loop), packed
// bfloat16 or not, with ds or without, or null
using BwdKernel = void (*)(BwdParams);

template <int kVec, bool kBf16, bool kDs>
BwdKernel backward_instance(int loads) {
  if (kBf16 && loads == 0) return nullptr;  // the two passes hold nothing
  switch (loads) {
    case 0: return rms_norm_bwd_kernel<kVec, 0, false, kDs>;
    case 1: return rms_norm_bwd_kernel<kVec, 1, kBf16, kDs>;
    case 2: return rms_norm_bwd_kernel<kVec, 2, kBf16, kDs>;
    case kMaxLoads: return rms_norm_bwd_kernel<kVec, kMaxLoads, kBf16, kDs>;
    default: return nullptr;
  }
}

template <bool kDs>
BwdKernel backward_kernel(int vec, int loads, bool bf16) {
  if (vec == 8) {
    return bf16 ? backward_instance<8, true, kDs>(loads)
                : backward_instance<8, false, kDs>(loads);
  }
  if (bf16) return nullptr;
  if (vec == 4) return backward_instance<4, false, kDs>(loads);
  if (vec == 1) return backward_instance<1, false, kDs>(loads);
  return nullptr;
}

// Whether the backward's register path holds its vectors packed: every
// tensor bfloat16 (ds_dtype -1: no ds) at 8 a load
bool backward_packs(int vec, int loads, int dy_dtype, int x_dtype,
                    int w_dtype, int ds_dtype) {
  return packs(vec, loads, dy_dtype, x_dtype, w_dtype) && ds_dtype != 0;
}

BwdKernel backward_kernel(int vec, int loads, bool packed, int ds_dtype) {
  return ds_dtype < 0 ? backward_kernel<false>(vec, loads, packed)
                      : backward_kernel<true>(vec, loads, packed);
}

// the backward's dynamic shared memory: dim floats
size_t backward_smem(int dim) {
  return sizeof(float) * static_cast<size_t>(dim);
}

// the shared memory a block may take at most on an H100
constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace

// h, delta (or null) (rows, dim) of h_dtype, delta_dtype; w (dim,) of
// w_dtype; s (rows, dim) of promoted(h, delta) (null without delta), y
// (rows, dim) of promoted(s, w); rstd (rows,) float32 or null; all
// contiguous. vec: elements a load (dim % vec == 0, every buffer aligned
// to vec elements, at most 16 bytes); threads_per_row a multiple of 32 up
// to 256, rows_per_block of them at most 256 threads; loads: vectors a
// thread holds, 1, 2 or 4 with loads * threads_per_row * vec >= dim,
// or 0 (two passes); blocks: the grid, at most one for each group of
// rows_per_block rows. Launched with programmatic dependent launch.
extern "C" int rms_norm_fwd(const void* h, const void* delta, const void* w,
                            void* s, void* y, float* rstd, int rows, int dim,
                            float eps, int h_dtype, int delta_dtype,
                            int w_dtype, int vec, int threads_per_row,
                            int rows_per_block, int loads, int blocks,
                            void* stream) {
  const int s_dtype =
      delta != nullptr ? promoted(h_dtype, delta_dtype) : h_dtype;
  const FwdParams p{h, delta, w, s, y, rstd, rows, dim, threads_per_row,
                    rows_per_block, eps, h_dtype,
                    delta != nullptr ? delta_dtype : h_dtype, w_dtype,
                    s_dtype, promoted(s_dtype, w_dtype)};
  using vector_io::aligned;
  const FwdKernel kernel = forward_kernel(
      vec, loads, packs(vec, loads, h_dtype, p.delta_dtype, w_dtype));
  const int threads = threads_per_row * rows_per_block;
  const long long groups = (rows + static_cast<long long>(rows_per_block)
                            - 1) / rows_per_block;
  if (kernel == nullptr || h == nullptr || w == nullptr || y == nullptr
      || (delta == nullptr) != (s == nullptr) || !dtype_ok(h_dtype)
      || !dtype_ok(p.delta_dtype) || !dtype_ok(w_dtype)
      || !layout_ok(rows, dim, vec, threads_per_row, rows_per_block,
                    kFwdThreads)
      || (loads > 0 && static_cast<long long>(loads) * threads_per_row * vec
                           < dim)
      || blocks < 1 || blocks > groups
      || !(eps >= 0.f) || !aligned(h, vec, h_dtype)
      || !aligned(delta, vec, p.delta_dtype) || !aligned(w, vec, w_dtype)
      || !aligned(s, vec, p.s_dtype) || !aligned(y, vec, p.y_dtype)) {
    return cudaErrorInvalidValue;
  }
  return dependent_launch::launch_dependent(
      kernel, static_cast<unsigned>(blocks), threads, stream, p);
}

// Blocks of `threads` threads of the forward instance that rms_norm_fwd
// launches for (vec, loads) and these dtypes (delta_dtype h_dtype
// without delta) that fit on one SM of the current device, or -1 for an
// instance that does not exist or a failed query.
extern "C" int rms_norm_fwd_resident(int vec, int loads, int threads,
                                     int h_dtype, int delta_dtype,
                                     int w_dtype) {
  const FwdKernel kernel = forward_kernel(
      vec, loads, packs(vec, loads, h_dtype, delta_dtype, w_dtype));
  if (kernel == nullptr || threads < 32 || threads > kFwdThreads) return -1;
  return dependent_launch::resident_blocks(kernel, threads);
}

// dy (rows, dim) of dy_dtype; x (rows, dim) of x_dtype, the normalised
// input; w (dim,) of w_dtype; rstd (rows,) float32; ds (rows, dim) of
// ds_dtype or null; dx (rows, dim) of x_dtype; dw (dim,) of w_dtype; all
// contiguous. ws (blocks + groups, dim) float32, where groups = ceil(blocks
// / blocks_per_group) is at most kMaxCombineGroups; counters groups + 1
// ints, 0 (every launch leaves them 0). Group g of block b takes rows b *
// rows_per_block + g + k * blocks * rows_per_block; blocks is at most one
// for each group of rows_per_block rows. vec, threads_per_row and loads
// as rms_norm_fwd, rows_per_block 1 for loads 0, a block's threads at most
// backward_threads; dim floats of shared memory a block.
extern "C" int rms_norm_bwd(const void* dy, const void* x, const void* w,
                            const float* rstd, const void* ds, void* dx,
                            void* dw, float* ws, int* counters, int rows,
                            int dim, int dy_dtype, int x_dtype, int w_dtype,
                            int ds_dtype, int vec, int threads_per_row,
                            int rows_per_block, int loads, int blocks,
                            int blocks_per_group, void* stream) {
  const BwdParams p{dy, x, w, rstd, ds, dx, dw, ws, counters, rows, dim,
                    threads_per_row, rows_per_block, blocks_per_group,
                    dy_dtype, x_dtype, w_dtype,
                    ds != nullptr ? ds_dtype : x_dtype};
  using vector_io::aligned;
  const int ds_code = ds != nullptr ? p.ds_dtype : -1;
  const bool packed =
      backward_packs(vec, loads, dy_dtype, x_dtype, w_dtype, ds_code);
  const BwdKernel kernel = backward_kernel(vec, loads, packed, ds_code);
  const long long groups = (rows + static_cast<long long>(rows_per_block)
                            - 1) / rows_per_block;
  const size_t smem = backward_smem(dim);
  if (kernel == nullptr || dy == nullptr || x == nullptr || w == nullptr
      || rstd == nullptr || dx == nullptr || dw == nullptr || ws == nullptr
      || counters == nullptr || !dtype_ok(dy_dtype) || !dtype_ok(x_dtype)
      || !dtype_ok(w_dtype) || !dtype_ok(p.ds_dtype)
      || !layout_ok(rows, dim, vec, threads_per_row, rows_per_block,
                    backward_threads(vec, loads, packed))
      || (loads > 0 && static_cast<long long>(loads) * threads_per_row * vec
                           < dim)
      || (loads == 0 && rows_per_block != 1)
      || blocks < 1 || blocks > groups || blocks_per_group < 1
      || (blocks + blocks_per_group - 1) / blocks_per_group
             > kMaxCombineGroups
      || smem > kMaxSmem || !aligned(dy, vec, dy_dtype)
      || !aligned(x, vec, x_dtype) || !aligned(w, vec, w_dtype)
      || !aligned(ds, vec, p.ds_dtype) || !aligned(dx, vec, x_dtype)) {
    return cudaErrorInvalidValue;
  }
  return launch(kernel, static_cast<unsigned>(blocks),
                threads_per_row * rows_per_block, smem, stream, &p);
}

// Blocks of `threads` threads of the backward instance that rms_norm_bwd
// launches for (vec, loads), a row of dim and these dtypes (ds_dtype -1
// without ds) that fit on one SM of the current device, or -1 for an
// instance that does not exist or a failed query.
extern "C" int rms_norm_bwd_resident(int vec, int loads, int threads,
                                     int dim, int dy_dtype, int x_dtype,
                                     int w_dtype, int ds_dtype) {
  const bool packed =
      backward_packs(vec, loads, dy_dtype, x_dtype, w_dtype, ds_dtype);
  const BwdKernel kernel = backward_kernel(vec, loads, packed, ds_dtype);
  const size_t smem = backward_smem(dim);
  if (kernel == nullptr || threads < 32
      || threads > backward_threads(vec, loads, packed) || smem > kMaxSmem) {
    return -1;
  }
  if (smem > 48 * 1024
      && cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem)) != cudaSuccess) {
    return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, reinterpret_cast<const void*>(kernel), threads, smem)
      != cudaSuccess) {
    return -1;
  }
  return blocks < 1 ? 1 : blocks;
}

// The text of a cudaError_t that rms_norm_fwd or rms_norm_bwd returned.
extern "C" const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

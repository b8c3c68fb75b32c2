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
// dw sums every row (16,384 at the train shape): each block sums a fixed
// range of rows into shared memory, writes its partial to a workspace and
// takes a ticket; the block that draws the last ticket adds the partials
// in block order and writes dw. No float atomics, every sum in a fixed
// order: two launches, or a replayed graph, give the same bits.
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
#include "vector_io.cuh"

namespace {

using dependent_launch::launch_dependents;
using dependent_launch::wait_for_prerequisites;
using vector_io::load;
using vector_io::round_to;
using vector_io::store;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// a forward block's threads at most, and the vectors of a row a thread
// holds at most on the register path: rows up to 4 x 256 vectors (8,192
// elements at 8 a load, 4,096 at 4, 1,024 at 1)
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kMaxLoads = 4;

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
  float* ws;         // (blocks, dim) the blocks' partial dw
  int* counter;      // the ticket counter, 0 between launches
  int rows, dim, threads_per_row, rows_per_block, rows_per_split;
  int dy_dtype, x_dtype, w_dtype, ds_dtype;
};

// The sum of v over a group of `threads` threads (a multiple of 32) in a
// fixed order: a butterfly within each warp, then the group's warps in
// order. Every thread of the block calls it (it holds block barriers);
// `sums` has a slot for each warp of the block.
__device__ __forceinline__ float group_sum(float v, int threads,
                                           float* sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) sums[warp] = v;
  __syncthreads();
  const int warps = threads >> 5;
  const int first = warp / warps * warps;
  float total = 0.f;
  for (int i = 0; i < warps; ++i) total = __fadd_rn(total, sums[first + i]);
  __syncthreads();  // the slots are free for the next sum
  return total;
}

// The ticket of a block: an atomic add with release semantics for the
// block's partial (which its fence and barrier ordered before it) and
// acquire semantics for the other blocks' partials, at the card's scope.
__device__ __forceinline__ int take_ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// The row's sum of v over its group of `warps` warps in a fixed order: a
// butterfly within each warp (every lane gets the same bits), then the
// group's warps in order through `sums[parity]`. One barrier, the
// group's own (a named barrier of its warps, so the block's other rows
// do not wait on it), which every thread of the group reaches; a row of
// one warp takes none. The slots alternate with the row's parity, so a
// row's writes never meet the previous row's reads.
__device__ __forceinline__ float row_sum(float v, int warps, int group,
                                         int parity,
                                         float (*sums)[kFwdWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) sums[parity][threadIdx.x >> 5] = v;
  // barrier 0 is __syncthreads'; a group's is 1 + group (at most 4)
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

template <int kVec>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_bwd_kernel(const BwdParams p) {
  // the groups' partial dw, rows_per_block x dim
  extern __shared__ float acc[];
  __shared__ float sums[kMaxWarps];
  __shared__ int ticket;
  const int group = threadIdx.x / p.threads_per_row;
  const int t = threadIdx.x % p.threads_per_row;
  const int chunks = p.dim / kVec;
  float* mine = acc + static_cast<long long>(group) * p.dim;
  for (int c = t; c < chunks; c += p.threads_per_row) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) mine[c * kVec + e] = 0.f;
  }
  const int first = blockIdx.x * p.rows_per_split;
  const int end = min(p.rows, first + p.rows_per_split);
  for (int base = first; base < end; base += p.rows_per_block) {
    const int row = base + group;
    const bool live = row < end;
    const long long off = static_cast<long long>(row) * p.dim;
    float cs = 0.f;
    if (live) {
      for (int c = t; c < chunks; c += p.threads_per_row) {
        float dy[kVec], x[kVec], w[kVec];
        load<kVec>(p.dy, off + c * kVec, p.dy_dtype, dy);
        load<kVec>(p.x, off + c * kVec, p.x_dtype, x);
        load<kVec>(p.w, c * kVec, p.w_dtype, w);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          cs = __fmaf_rn(__fmul_rn(dy[e], w[e]), x[e], cs);
        }
      }
    }
    const float total = group_sum(cs, p.threads_per_row, sums);
    if (!live) continue;
    const float r = p.rstd[row];
    const float k = __fdiv_rn(__fmul_rn(__fmul_rn(r, r), total),
                              static_cast<float>(p.dim));
    for (int c = t; c < chunks; c += p.threads_per_row) {
      float dy[kVec], x[kVec], w[kVec], dx[kVec];
      load<kVec>(p.dy, off + c * kVec, p.dy_dtype, dy);
      load<kVec>(p.x, off + c * kVec, p.x_dtype, x);
      load<kVec>(p.w, c * kVec, p.w_dtype, w);
      if (p.ds != nullptr) {
        load<kVec>(p.ds, off + c * kVec, p.ds_dtype, dx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float g = __fmul_rn(dy[e], w[e]);
        const float v = __fmul_rn(r, __fsub_rn(g, __fmul_rn(x[e], k)));
        dx[e] = p.ds != nullptr ? __fadd_rn(v, dx[e]) : v;
        const float n = round_to(__fmul_rn(x[e], r), p.x_dtype);
        float* a = mine + c * kVec + e;
        *a = __fadd_rn(*a, __fmul_rn(dy[e], n));
      }
      store<kVec>(p.dx, off + c * kVec, p.x_dtype, dx);
    }
  }
  __syncthreads();
  // the block's partial: its groups' sums in group order
  float* partial = p.ws + static_cast<long long>(blockIdx.x) * p.dim;
  for (int j = threadIdx.x; j < p.dim; j += blockDim.x) {
    float v = 0.f;
    for (int g = 0; g < p.rows_per_block; ++g) {
      v = __fadd_rn(v, acc[static_cast<long long>(g) * p.dim + j]);
    }
    partial[j] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = take_ticket(p.counter);
  __syncthreads();
  if (ticket != static_cast<int>(gridDim.x) - 1) return;
  __threadfence();
  // the last block: every partial in block order, read from L2
  for (int j = threadIdx.x; j < p.dim; j += blockDim.x) {
    float v = 0.f;
#pragma unroll 8
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      v = __fadd_rn(v, __ldcg(p.ws + static_cast<long long>(b) * p.dim + j));
    }
    float out[1] = {v};
    store<1>(p.dw, j, p.w_dtype, out);
  }
  if (threadIdx.x == 0) *p.counter = 0;
}

bool dtype_ok(int dtype) { return dtype == 0 || dtype == 1; }

// PyTorch's promotion of two of the codes: float32 if either is
int promoted(int a, int b) { return a == 0 || b == 0 ? 0 : 1; }

bool layout_ok(int rows, int dim, int vec, int threads_per_row,
               int rows_per_block) {
  return rows >= 1 && dim >= 1 && (vec == 1 || vec == 4 || vec == 8)
         && dim % vec == 0 && threads_per_row >= 32
         && threads_per_row % 32 == 0 && threads_per_row <= 256
         && rows_per_block >= 1
         && threads_per_row * rows_per_block <= kMaxThreads;
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
      || !layout_ok(rows, dim, vec, threads_per_row, rows_per_block)
      || threads > kFwdThreads
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
// ds_dtype or null; dx (rows, dim) of x_dtype; dw (dim,) of w_dtype; ws
// (splits, dim) float32; counter one int, 0 (every launch leaves it 0).
// Block b takes rows [b * rows_per_split, (b + 1) * rows_per_split),
// rows_per_block at a time; splits * rows_per_split >= rows and every
// block has a row. vec, threads_per_row, rows_per_block as rms_norm_fwd.
extern "C" int rms_norm_bwd(const void* dy, const void* x, const void* w,
                            const float* rstd, const void* ds, void* dx,
                            void* dw, float* ws, int* counter, int rows,
                            int dim, int splits, int rows_per_split,
                            int dy_dtype, int x_dtype, int w_dtype,
                            int ds_dtype, int vec, int threads_per_row,
                            int rows_per_block, void* stream) {
  const BwdParams p{dy, x, w, rstd, ds, dx, dw, ws, counter, rows, dim,
                    threads_per_row, rows_per_block, rows_per_split,
                    dy_dtype, x_dtype, w_dtype,
                    ds != nullptr ? ds_dtype : x_dtype};
  using vector_io::aligned;
  const size_t smem = sizeof(float) * static_cast<size_t>(rows_per_block)
                      * static_cast<size_t>(dim);
  if (dy == nullptr || x == nullptr || w == nullptr || rstd == nullptr
      || dx == nullptr || dw == nullptr || ws == nullptr
      || counter == nullptr || !dtype_ok(dy_dtype) || !dtype_ok(x_dtype)
      || !dtype_ok(w_dtype) || !dtype_ok(p.ds_dtype)
      || !layout_ok(rows, dim, vec, threads_per_row, rows_per_block)
      || splits < 1 || rows_per_split < 1
      || static_cast<long long>(splits - 1) * rows_per_split >= rows
      || static_cast<long long>(splits) * rows_per_split < rows
      || smem > 227 * 1024 || !aligned(dy, vec, dy_dtype)
      || !aligned(x, vec, x_dtype) || !aligned(w, vec, w_dtype)
      || !aligned(ds, vec, p.ds_dtype) || !aligned(dx, vec, x_dtype)) {
    return cudaErrorInvalidValue;
  }
  const int threads = threads_per_row * rows_per_block;
  if (vec == 8) return launch(rms_norm_bwd_kernel<8>, splits, threads, smem,
                              stream, &p);
  if (vec == 4) return launch(rms_norm_bwd_kernel<4>, splits, threads, smem,
                              stream, &p);
  return launch(rms_norm_bwd_kernel<1>, splits, threads, smem, stream, &p);
}

// The text of a cudaError_t that rms_norm_fwd or rms_norm_bwd returned.
extern "C" const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

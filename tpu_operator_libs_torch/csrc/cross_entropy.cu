// The next-token loss, forward and backward, over the whole (B, S, V)
// logits of the batch forward.
//
// cross_entropy_fwd: for each of the B x used positions (b, s), s < used,
// with its target t (targets (B, used): used = S - 1 for the next-token
// loss, whose last position has no target; S for a ring block, whose last
// target is the next block's first token),
//   m = max_j x_j,   ls = log(sum_j exp(x_j - m)),   picked = (x_t - m) - ls,
// writing (m, ls) a row (float32, kept for the backward: m + ls is the
// row's log-sum-exp), then loss = -(sum of picked) / (B x used).
// cross_entropy_bwd: from the loss's 0-d float32 gradient g, read where
// it lies, gp = -g * (1 / (B x used)), and for every position of the
// logits
//   dx_j = R(fma(-exp((x_j - m) - ls), gp, j == t ? gp : 0))   (s < used)
//   dx_j = 0                                                  (s >= used)
// with R the rounding to the logits' dtype.
//
// Replaces tpu_operator_libs/examples/llama.py::next_token_loss (:331-341:
// log_softmax of the float32 logits, take_along_axis, the mean) and its
// gradient under jax.grad, which XLA fuses on the TPU (no Pallas source).
// The port's plain version, kernels/cross_entropy.py::
// next_token_loss_reference, slices off the last position, writes a
// float32 copy, its log-softmax (kept for the backward), a gather and a
// mean; its backward (autograd) writes zeros and a scatter, runs the
// log-softmax's backward through float32, casts, and pads the sliced-off
// position back with a zero-filled (B, S, V) copy: ~1.4 GB a step at
// llama-277M's (16, 1024, 2048) bfloat16 logits, in about ten launches.
//
// Bound: bytes. The forward reads the logits once (67 MB), the backward
// reads them again and writes dlogits once (134 MB): 0.020 and 0.040 ms at
// 3.35 TB/s; an exp an element (33.5M) takes ~0.01 ms of the SMs' special
// function units. The design keeps a row's intermediates out of device
// memory. Rows of up to kRowElems = 2,048 elements are held in registers,
// a warp a row (64 floats a lane, 16-byte loads all issued before the
// first use): the max and the sum of exps are two passes over registers
// and two butterflies of shuffles; wider rows take a block a row, each
// thread keeping an online (max, sum) over its strided vectors, combined
// over the block in warp order. The mean is deterministic: each block
// adds its rows' picked log-probabilities in row order into its partial,
// and the block that draws the last ticket (ticket.cuh) adds the partials
// in a fixed order, with no float atomics. The backward recomputes log p
// from the kept (m, ls) in the plain version's order of operations (its
// grid: a warp for each row and each 2,048 columns), so no float32 (B, S,
// V) tensor is ever written.
//
// Against the plain version: m is exact, ls takes its sum in another
// order (its value within a few float32 ulps), so the loss agrees within
// 1e-5 relative and bfloat16 dlogits within one bfloat16 ulp. exp and log
// are the accurate expf and logf that PyTorch's kernels call; gp is taken
// as PyTorch takes it on the card (a division by a Python number is a
// product with its float32 reciprocal), and the last step is one fused
// multiply-add, as the log-softmax backward's a - b * c contracts. A
// target outside [0, V) makes its row's picked log-probability, and so
// the loss, NaN (the card cannot raise without a readback).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ticket.cuh"
#include "vector_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the widest row a warp holds in registers, and the columns a warp of the
// backward takes: 64 floats a lane
constexpr int kRowElems = 2048;
// vectors a thread loads before it folds them, in the wide rows' loop
constexpr int kWideUnroll = 4;

struct FwdParams {
  const void* logits;         // (B, S, V) of dtype
  const long long* targets;   // (B, used)
  float* stats;               // (B x used, 2): m and ls a row
  float* partials;            // a float a block
  float* loss;                // 0-d
  int* counter;               // one ticket counter, 0 between launches
  long long rows;             // B x used
  int seq, used, vocab, dtype;
};

struct BwdParams {
  const void* logits;         // (B, S, V) of dtype
  const long long* targets;   // (B, used)
  const float* stats;         // (B x used, 2)
  const float* grad;          // 0-d: the loss's gradient
  void* dlogits;              // (B, S, V) of dtype
  long long rows_all;         // B x S
  long long rows;             // B x used: the mean's count
  int seq, used, vocab, dtype;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// x over the block's warps in warp order; thread 0 holds the result.
// `scratch` holds a float a warp; it may be reused after the next barrier.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;
}

// The logits' offset of row r (position (b, s), s < used)
__device__ __forceinline__ long long row_base(const FwdParams& p,
                                              long long r) {
  const long long b = r / p.used;
  return (b * p.seq + (r - b * p.used)) * p.vocab;
}

// Row r's target logit x_t, loaded before the row so that its two
// dependent loads (the target, then the logit) overlap the row's; NaN
// for a target outside the vocabulary, which makes the loss NaN
__device__ __forceinline__ float target_logit(const FwdParams& p,
                                              long long r, long long base) {
  const long long t = p.targets[r];
  float xt[1] = {__int_as_float(0x7fffffff)};
  if (t >= 0 && t < p.vocab) {
    vector_io::load<1>(p.logits, base + t, p.dtype, xt);
  }
  return xt[0];
}

// Thread 0's `partial` (the block's rows' picked, in row order) into the
// loss: the last block to take its ticket adds every block's partial, a
// thread over strided blocks, then the block in warp order.
__device__ __forceinline__ void finish(const FwdParams& p, float partial,
                                       float* scratch, int* ticket) {
  if (threadIdx.x == 0) p.partials[blockIdx.x] = partial;
  if (!tickets::last(p.counter, gridDim.x, ticket)) return;
  float sum = 0.0f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    sum += p.partials[b];
  }
  sum = block_sum(sum, scratch);
  if (threadIdx.x == 0) {
    *p.loss = -__fdiv_rn(sum, static_cast<float>(p.rows));
    *p.counter = 0;
  }
}

// Rows of up to kRowElems: a warp a row, the row in registers.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    cross_entropy_fwd_kernel(const FwdParams p) {
  constexpr int kLoads = kRowElems / 32 / kVec;
  __shared__ float scratch[kWarps];
  __shared__ int ticket;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  float picked = 0.0f;
  if (r < p.rows) {
    const long long base = row_base(p, r);
    const float xt = lane == 0 ? target_logit(p, r, base) : 0.0f;
    float x[kLoads][kVec];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int c = (l * 32 + lane) * kVec;
      if (c < p.vocab) {
        vector_io::load<kVec>(p.logits, base + c, p.dtype, x[l]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[l][e] = -INFINITY;
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) m = fmaxf(m, x[l][e]);
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      if ((l * 32 + lane) * kVec < p.vocab) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += expf(__fsub_rn(x[l][e], m));
      }
    }
    sum = warp_sum(sum);
    const float ls = logf(sum);
    if (lane == 0) {
      p.stats[2 * r] = m;
      p.stats[2 * r + 1] = ls;
      picked = __fsub_rn(__fsub_rn(xt, m), ls);
    }
  }
  if (lane == 0) scratch[warp] = picked;
  __syncthreads();
  float partial = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) partial += scratch[w];
  }
  finish(p, partial, scratch, &ticket);
}

// Wider rows: a block a row, an online (max, sum) a thread over its
// strided vectors, kWideUnroll vectors loaded at a time.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    cross_entropy_wide_kernel(const FwdParams p) {
  constexpr int kStride = kThreads * kVec;
  __shared__ float scratch[kWarps];
  __shared__ float row_max;
  __shared__ int ticket;
  const long long r = blockIdx.x;
  const long long base = row_base(p, r);
  const float xt = threadIdx.x == 0 ? target_logit(p, r, base) : 0.0f;
  float m = -INFINITY, sum = 0.0f;
  for (int c0 = threadIdx.x * kVec; c0 < p.vocab;
       c0 += kStride * kWideUnroll) {
    float x[kWideUnroll][kVec];
    float next = m;
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      const int c = c0 + u * kStride;
      if (c < p.vocab) {
        vector_io::load<kVec>(p.logits, base + c, p.dtype, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[u][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) next = fmaxf(next, x[u][e]);
    }
    if (next > m) {
      sum *= expf(__fsub_rn(m, next));  // 0 while m is -inf
      m = next;
    }
#pragma unroll
    for (int u = 0; u < kWideUnroll; ++u) {
      if (c0 + u * kStride < p.vocab) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += expf(__fsub_rn(x[u][e], m));
      }
    }
  }
  // the row's max, then every thread's sum at it
  const float wm = warp_max(m);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = wm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = scratch[0];
    for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, scratch[w]);
    row_max = bm;
  }
  __syncthreads();
  const float rm = row_max;
  const float scaled = m == -INFINITY ? 0.0f : sum * expf(__fsub_rn(m, rm));
  const float total = block_sum(scaled, scratch);
  float picked = 0.0f;
  if (threadIdx.x == 0) {
    const float ls = logf(total);
    p.stats[2 * r] = rm;
    p.stats[2 * r + 1] = ls;
    picked = __fsub_rn(__fsub_rn(xt, rm), ls);
  }
  finish(p, picked, scratch, &ticket);
}

// A warp a row and kRowElems columns (blockIdx.y the columns' slice).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    cross_entropy_bwd_kernel(const BwdParams p) {
  constexpr int kLoads = kRowElems / 32 / kVec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= p.rows_all) return;
  const long long b = row / p.seq, s = row - b * p.seq;
  const long long base = row * p.vocab;
  const int first = blockIdx.y * kRowElems;
  float x[kLoads][kVec];
  if (s >= p.used) {
    // a position without a target: its gradient is 0
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[l][e] = 0.0f;
      const int c = first + (l * 32 + lane) * kVec;
      if (c < p.vocab) {
        vector_io::store<kVec>(p.dlogits, base + c, p.dtype, x[l]);
      }
    }
    return;
  }
  const long long r = b * p.used + s;
  const long long t = p.targets[r];
  const float m = p.stats[2 * r], ls = p.stats[2 * r + 1];
  const float gp =
      __fmul_rn(-*p.grad, __frcp_rn(static_cast<float>(p.rows)));
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int c = first + (l * 32 + lane) * kVec;
    if (c < p.vocab) vector_io::load<kVec>(p.logits, base + c, p.dtype, x[l]);
  }
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int c = first + (l * 32 + lane) * kVec;
    if (c < p.vocab) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float logp = __fsub_rn(__fsub_rn(x[l][e], m), ls);
        x[l][e] = __fmaf_rn(-expf(logp), gp, c + e == t ? gp : 0.0f);
      }
      vector_io::store<kVec>(p.dlogits, base + c, p.dtype, x[l]);
    }
  }
}

// The shapes and vector width a launch takes: used in [1, seq], a vocab
// of at least 1 and a multiple of vec, vec 1 or 16 bytes' worth with the
// logits (and dlogits) 16-byte aligned
bool valid(const void* logits, const void* out, int batch, int seq,
           int used, int vocab, int dtype, int vec) {
  return logits != nullptr && batch >= 1 && used >= 1 && used <= seq
         && vocab >= 1 && dtype >= 0 && dtype <= 1
         && (vec == 1 || vec == 16 / (dtype == 0 ? 4 : 2))
         && vocab % vec == 0 && vector_io::aligned(logits, vec, dtype)
         && vector_io::aligned(out, vec, dtype);
}

}  // namespace

// The blocks the forward launches for rows = batch x used rows of vocab
// (the partials it needs): a block for every kWarps rows where a warp
// holds a row, else a block a row.
extern "C" long long cross_entropy_fwd_blocks(long long rows, int vocab) {
  return vocab <= kRowElems ? (rows + kWarps - 1) / kWarps : rows;
}

// The loss of logits (batch, seq, vocab) of dtype (0 float32, 1 bfloat16)
// at targets (batch, used), int64, into the 0-d float loss, and (m, ls) a
// row into stats (batch x used, 2). partials: n_partials floats of
// scratch, at least cross_entropy_fwd_blocks; counter: one int, 0, left
// 0. vec: 8 (bf16) or 4 (f32), or 1; see valid(). One launch.
extern "C" int cross_entropy_fwd(const void* logits, const long long* targets,
                                 float* stats, float* partials,
                                 long long n_partials, float* loss,
                                 int* counter, int batch, int seq, int used,
                                 int vocab, int dtype, int vec,
                                 void* stream) {
  if (!valid(logits, nullptr, batch, seq, used, vocab, dtype, vec)
      || targets == nullptr || stats == nullptr || partials == nullptr
      || loss == nullptr || counter == nullptr) {
    return cudaErrorInvalidValue;
  }
  FwdParams p{logits, targets, stats, partials, loss, counter,
              static_cast<long long>(batch) * used, seq, used, vocab, dtype};
  const long long blocks = cross_entropy_fwd_blocks(p.rows, vocab);
  if (blocks > n_partials || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vocab <= kRowElems) {
    if (vec == 8) {
      cross_entropy_fwd_kernel<8><<<grid, kThreads, 0, s>>>(p);
    } else if (vec == 4) {
      cross_entropy_fwd_kernel<4><<<grid, kThreads, 0, s>>>(p);
    } else {
      cross_entropy_fwd_kernel<1><<<grid, kThreads, 0, s>>>(p);
    }
  } else if (vec == 8) {
    cross_entropy_wide_kernel<8><<<grid, kThreads, 0, s>>>(p);
  } else if (vec == 4) {
    cross_entropy_wide_kernel<4><<<grid, kThreads, 0, s>>>(p);
  } else {
    cross_entropy_wide_kernel<1><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

// dlogits (batch, seq, vocab) of dtype from the logits, the targets and
// the stats of cross_entropy_fwd and the loss's 0-d float32 gradient
// grad. One launch.
extern "C" int cross_entropy_bwd(const void* logits,
                                 const long long* targets,
                                 const float* stats, const float* grad,
                                 void* dlogits, int batch, int seq, int used,
                                 int vocab, int dtype, int vec,
                                 void* stream) {
  if (!valid(logits, dlogits, batch, seq, used, vocab, dtype, vec)
      || targets == nullptr || stats == nullptr || grad == nullptr
      || dlogits == nullptr) {
    return cudaErrorInvalidValue;
  }
  BwdParams p{logits, targets, stats, grad, dlogits,
              static_cast<long long>(batch) * seq,
              static_cast<long long>(batch) * used, seq, used, vocab, dtype};
  const long long blocks = (p.rows_all + kWarps - 1) / kWarps;
  const int slices = (vocab + kRowElems - 1) / kRowElems;
  if (blocks > 0x7fffffffLL || slices > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), slices);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    cross_entropy_bwd_kernel<8><<<grid, kThreads, 0, s>>>(p);
  } else if (vec == 4) {
    cross_entropy_bwd_kernel<4><<<grid, kThreads, 0, s>>>(p);
  } else {
    cross_entropy_bwd_kernel<1><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

// The text of a cudaError_t that an entry above returned.
extern "C" const char* cross_entropy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

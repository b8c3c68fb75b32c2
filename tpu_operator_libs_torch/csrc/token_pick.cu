// The decode step's token pick: one launch a pick, every row of the
// (B, V) logits of the step's last position.
//
// Greedy (no noise): the first index of the row's maximum, a NaN winning,
// as torch.argmax and jnp.argmax take it. Sampled, with x the row as
// float32, inv_t the float32 reciprocal of the temperature and u the
// caller's (B, V) float32 uniforms:
//   top-k:  kth = the k-th largest x counted with multiplicity; x < kth
//           -> -inf (ties kept);
//   top-p:  p_j = expf(x_j * inv_t - m) / s over the top-k-masked row (m
//           its max, s its sum of exps), p* = the smallest p_j whose mass
//           strictly above it, S(> p_j), is below top_p; p_j < p* -> x_j =
//           -inf (ties kept);
//   draw:   argmax_j (x_j * inv_t - logf(-logf(max(u_j, FLT_MIN)))), the
//           first index on ties.
// Either way, on request, the chosen token's untempered, untruncated
// log-softmax (x_c - max x) - logf(sum expf(x - max x)).
//
// Replaces tpu_operator_libs/examples/llama_decode.py::_pick_next
// (:288-333: argmax, or sort for top-k, softmax, sort, flip, cumsum and a
// min for the nucleus, jax.random.categorical, log_softmax and a gather),
// which XLA fuses into the jitted decode loop on the TPU (no Pallas
// source). The port's plain version, kernels/token_pick.py::
// pick_reference, takes about 15 launches a sampled pick (17 with the
// logprob) on the card, two sorts among them.
//
// Bound: bytes, and at the decode shape the launch. A pick reads the
// logits and the noise once, (8, 2048) bf16 and f32 at the bench decode:
// 98 KB, 0.03 us at 3.35 TB/s. The design finds both thresholds without
// sorting: the k-th largest by bisection over the order-preserving
// integer keys of x (32 counting passes), the nucleus's p* by bisection
// over the float32 bit patterns of the probabilities (non-negative, so
// bit order is value order; 32 passes, each summing the mass above a
// candidate in a fixed order). The row is loaded once into shared memory
// as float32 and every pass runs from there: a row of up to kRowElems =
// 2,048 takes a block of kRowThreads (8 elements a thread, its loops
// unrolled; the noise loaded into registers beside the row), one barrier
// a pass; a wider row (a Llama-3 vocabulary of 128,256 is 256 KB in bf16,
// 501 KB as float32: more than an SM's shared memory) takes a cluster of
// kClusterBlocks blocks on as many SMs, each holding an eighth of it,
// each pass ending in one cluster barrier after which every thread reads
// the blocks' partials from their shared memory (distributed shared
// memory). Each thread reads and writes only its own elements of the
// slice, and the code is short loops, which a step's other kernels do not
// evict from the instruction caches for long: the first design's warp a
// row with its row in registers ran its fully unrolled passes 1.4-2.3x
// slower inside the decode step than alone. Every sum, in-thread and
// across lanes, warps and blocks, is taken in a fixed order and the
// argmax is a total order, so launches and graph replays give the same
// bits. The settings are launch parameters and nothing is read back to
// the host, so a CUDA graph captures the launch.
//
// Against the plain version: exp, log and the division are the accurate
// expf, logf and an IEEE quotient that PyTorch's kernels compute, each
// product and difference rounded alone (__fmul_rn, __fsub_rn: no FMA
// contraction) in the plain version's order, so greedy tokens and the
// draw's values are the plain version's bit for bit. The softmax's sum and
// the nucleus's masses are added in another order than PyTorch's
// softmax and cumsum, so a token whose mass above lies within float32
// rounding of top_p may be kept by one and masked by the other; the
// logprob's sum likewise (1e-5 relative plus 1e-6).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "vector_io.cuh"

namespace {

namespace cg = cooperative_groups;

// rows of up to kRowElems: a block of kRowThreads a row, kRowElems /
// kRowThreads elements a thread
constexpr int kRowElems = 2048;
constexpr int kRowThreads = 256;
// wider rows: a cluster of kClusterBlocks blocks of kWideThreads a row,
// each block holding a slice of up to kSliceElems float32 (224 KB of the
// 227 KB of shared memory a block may take), so rows of up to 458,752
constexpr int kClusterBlocks = 8;
constexpr int kSliceElems = 56 * 1024;
constexpr int kWideThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* logits;   // (rows, vocab) of dtype, rows `stride` apart
  const float* noise;   // (rows, vocab) float32, contiguous; null: greedy
  long long* tokens;    // (rows,)
  float* logprobs;      // (rows,), or null
  long long stride;     // elements from one row of the logits to the next
  int rows, vocab, dtype;
  float inv_t;          // the float32 reciprocal of the temperature
  int top_k;            // 0: none
  float top_p;
  int has_top_p;
};

// Whether (av, ai) comes before (bv, bi) in torch.argmax's order: a NaN
// first, then the larger value, then the lower index
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  if (isnan(av)) return !isnan(bv) || ai < bi;
  if (isnan(bv)) return false;
  return av == bv ? ai < bi : av > bv;
}

// x's key in an unsigned order that is float order (-0 just below +0),
// every NaN last, as torch.sort places it
__device__ __forceinline__ unsigned order_key(float x) {
  if (isnan(x)) return kFull;
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The draw's value of a (masked) logit x under the noise u
__device__ __forceinline__ float noisy(float x, float u, float inv_t) {
  return __fsub_rn(__fmul_rn(x, inv_t), logf(-logf(fmaxf(u, FLT_MIN))));
}

// A tempered probability, as PyTorch's softmax takes it
__device__ __forceinline__ float prob(float x, float inv_t, float m,
                                      float s) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(x, inv_t), m)), s);
}

// Reductions over a warp (each lane's result the same: every step adds
// or compares a pair in both lanes alike)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  }
  return x;
}

__device__ __forceinline__ int warp_count(int n) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) n += __shfl_xor_sync(kFull, n, o);
  return n;
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// A reduction's partial: a value and an index (a count, or a column)
struct Part {
  float v;
  int i;
};

// Reductions over the kCluster blocks of kWarps warps that hold a row
// (each thread's result the same): the warps' results through shared
// memory, folded in warp order by every thread; in a cluster, thread 0's
// fold goes to its block's slot and, after the cluster's barrier, every
// thread folds the blocks' slots in rank order. The slots alternate
// between two: a slot is written again only two reductions on, after
// every thread (of every block) has passed the barrier of the one
// between, so no write meets a read of the reduction before.
template <int kCluster, int kWarps>
class RowReduce {
 public:
  __device__ RowReduce(Part (*warps)[kWarps], Part* blocks)
      : warps_(warps), blocks_(blocks) {}

  __device__ float sum(float x) {
    return fold({warp_sum(x), 0},
                [](Part a, Part b) { return Part{a.v + b.v, 0}; }).v;
  }

  __device__ float max(float x) {
    return fold({warp_max(x), 0},
                [](Part a, Part b) { return Part{fmaxf(a.v, b.v), 0}; }).v;
  }

  __device__ int count(int n) {
    return fold({0.0f, warp_count(n)},
                [](Part a, Part b) { return Part{0.0f, a.i + b.i}; }).i;
  }

  __device__ int best(float v, int i) {
    warp_best(v, i);
    return fold({v, i}, [](Part a, Part b) {
             return better(b.v, b.i, a.v, a.i) ? b : a;
           }).i;
  }

 private:
  template <class F>
  __device__ Part fold(Part x, F f) {
    if (threadIdx.x % 32 == 0) warps_[slot_][threadIdx.x / 32] = x;
    __syncthreads();
    Part t = warps_[slot_][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = f(t, warps_[slot_][w]);
    if constexpr (kCluster > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) blocks_[slot_] = t;
      cluster.sync();
      t = *cluster.map_shared_rank(blocks_ + slot_, 0);
#pragma unroll
      for (int b = 1; b < kCluster; ++b) {
        t = f(t, *cluster.map_shared_rank(blocks_ + slot_, b));
      }
    }
    slot_ ^= 1;
    return t;
  }

  Part (*warps_)[kWarps];  // [2][kWarps]
  Part* blocks_;           // [2]
  int slot_ = 0;
};

// The elements of a row that each of `blocks` blocks holds: an equal
// share, rounded up to whole vectors
__host__ __device__ constexpr int slice_elems(int vocab, int vec,
                                              int blocks) {
  return (vocab + blocks * vec - 1) / (blocks * vec) * vec;
}

// f(k, j) for each of this thread's elements j = threadIdx.x + k *
// kThreads of an n-element slice: kPer, where it is not 0, bounds k at
// compile time and the loop is unrolled
template <int kThreads, int kPer, class F>
__device__ __forceinline__ void own(int n, F f) {
  if constexpr (kPer > 0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < n) f(k, j);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < n; j += kThreads) f(0, j);
  }
}

// The pick of row r, whose columns [lo, lo + n) this block holds in
// `slice` (float32, 16-byte aligned), among kCluster blocks of kThreads;
// kPer as in own(). Each thread reads and writes only its own elements
// of the slice after the load, so the passes take no barrier but their
// reductions'.
template <int kVec, bool kSample, int kCluster, int kThreads, int kPer>
__device__ __forceinline__ void pick_row(const Params& p, float* slice,
                                         int r, int rank) {
  constexpr int kWarps = kThreads / 32;
  __shared__ Part warps[2][kWarps];
  __shared__ Part blocks[2];
  RowReduce<kCluster, kWarps> red(warps, blocks);
  const int per = slice_elems(p.vocab, kVec, kCluster);
  const int lo = rank * per;
  const int n = max(0, min(per, p.vocab - lo));
  const long long base = r * p.stride + lo;
  const float* noise =
      kSample ? p.noise + static_cast<long long>(r) * p.vocab + lo : nullptr;
  // the noise in registers while the row loads, where a thread's share
  // is known (a greedy instance never reads it)
  float u[kPer > 0 ? kPer : 1];
  if constexpr (kSample && kPer > 0) {
    own<kThreads, kPer>(n, [&](int k, int j) { u[k] = noise[j]; });
  }
  for (int c = threadIdx.x * kVec; c < n; c += kThreads * kVec) {
    float x[kVec];
    vector_io::load<kVec>(p.logits, base + c, p.dtype, x);
    if constexpr (kVec % 4 == 0) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(slice + c + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) slice[c + e] = x[e];
    }
  }
  __syncthreads();
  // the logprob's max and sum of exps, over the untempered row
  float m0 = -INFINITY, s0 = 0.0f;
  if (p.logprobs != nullptr) {
    float m = -INFINITY;
    own<kThreads, kPer>(n, [&](int, int j) { m = fmaxf(m, slice[j]); });
    m0 = red.max(m);
    float s = 0.0f;
    own<kThreads, kPer>(n, [&](int, int j) {
      s += expf(__fsub_rn(slice[j], m0));
    });
    s0 = red.sum(s);
  }
  float bv = -INFINITY;
  int bi = INT_MAX;
  if constexpr (!kSample) {
    own<kThreads, kPer>(n, [&](int, int j) {
      if (better(slice[j], lo + j, bv, bi)) {
        bv = slice[j];
        bi = lo + j;
      }
    });
  } else {
    // top-k: the largest key t with at least k keys >= t is the k-th
    // largest's; the mask, a float comparison (-0 is not below +0),
    // written over the slice
    const bool top_k = p.top_k > 0 && p.top_k < p.vocab;
    float kth = -INFINITY;
    if (top_k) {
      unsigned t = 0;
#pragma unroll 1
      for (int bit = 31; bit >= 0; --bit) {
        const unsigned cand = t | (1u << bit);
        int c = 0;
        own<kThreads, kPer>(n, [&](int, int j) {
          c += order_key(slice[j]) >= cand;
        });
        if (red.count(c) >= p.top_k) t = cand;
      }
      kth = from_key(t);
      own<kThreads, kPer>(n, [&](int, int j) {
        if (slice[j] < kth) slice[j] = -INFINITY;
      });
    }
    // top-p: the probabilities written over the slice, then the largest
    // bit pattern T whose mass above is still >= top_p; p* is the next
    // one up (0 where even the mass above 0 is below top_p)
    unsigned t0 = 0;
    if (p.has_top_p) {
      float lm = -INFINITY;
      own<kThreads, kPer>(n, [&](int, int j) {
        lm = fmaxf(lm, __fmul_rn(slice[j], p.inv_t));
      });
      const float m = red.max(lm);
      float ls = 0.0f;
      own<kThreads, kPer>(n, [&](int, int j) {
        ls += expf(__fsub_rn(__fmul_rn(slice[j], p.inv_t), m));
      });
      const float s = red.sum(ls);
      own<kThreads, kPer>(n, [&](int, int j) {
        slice[j] = prob(slice[j], p.inv_t, m, s);
      });
      unsigned t = 0;
#pragma unroll 1
      for (int bit = 31; bit >= 0; --bit) {
        // bit 31 first tests t = 0 itself (the mass above 0): a
        // probability's sign bit is never set
        const unsigned cand = bit == 31 ? 0u : t | (1u << bit);
        float above = 0.0f;
        own<kThreads, kPer>(n, [&](int, int j) {
          above += __float_as_uint(slice[j]) > cand ? slice[j] : 0.0f;
        });
        const bool held = red.sum(above) >= p.top_p;
        if (bit == 31 && !held) break;
        if (held) t = cand;
        t0 = t + 1;
      }
    }
    // the draw; under top-p the row is read again (the slice holds the
    // probabilities) and masked by both thresholds
    own<kThreads, kPer>(n, [&](int k, int j) {
      float xv = slice[j];
      if (p.has_top_p) {
        float xr[1];
        vector_io::load<1>(p.logits, base + j, p.dtype, xr);
        xv = (top_k && xr[0] < kth) || __float_as_uint(slice[j]) < t0
                 ? -INFINITY : xr[0];
      }
      float uj;
      if constexpr (kPer > 0) {
        uj = u[k];
      } else {
        uj = noise[j];
      }
      const float v = noisy(xv, uj, p.inv_t);
      if (better(v, lo + j, bv, bi)) {
        bv = v;
        bi = lo + j;
      }
    });
  }
  bi = red.best(bv, bi);
  if (rank == 0 && threadIdx.x == 0) {
    // the token, and its logprob (the chosen logit read again)
    p.tokens[r] = bi;
    if (p.logprobs != nullptr) {
      float xc[1];
      vector_io::load<1>(p.logits, r * p.stride + bi, p.dtype, xc);
      p.logprobs[r] = __fsub_rn(__fsub_rn(xc[0], m0), logf(s0));
    }
  }
}

// Rows of up to kRowElems: a block a row
template <int kVec, bool kSample>
__global__ void __launch_bounds__(kRowThreads)
    token_pick_block_kernel(const Params p) {
  __shared__ __align__(16) float slice[kRowElems];
  pick_row<kVec, kSample, 1, kRowThreads, kRowElems / kRowThreads>(
      p, slice, blockIdx.x, 0);
}

// Wider rows: a cluster a row, each block its slice in shared memory
template <int kVec, bool kSample>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kWideThreads) token_pick_wide_kernel(const Params p) {
  extern __shared__ __align__(16) float slice[];
  cg::cluster_group cluster = cg::this_cluster();
  pick_row<kVec, kSample, kClusterBlocks, kWideThreads, 0>(
      p, slice, blockIdx.x / kClusterBlocks,
      static_cast<int>(cluster.block_rank()));
  // no block leaves while another may still read its slots
  cluster.sync();
}

template <int kVec, bool kSample>
cudaError_t launch_wide(const Params& p, cudaStream_t s) {
  const auto kernel = token_pick_wide_kernel<kVec, kSample>;
  const int bytes = slice_elems(p.vocab, kVec, kClusterBlocks)
                    * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.rows * kClusterBlocks, kWideThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const bool sample = p.noise != nullptr;
  if (p.vocab > kRowElems) {
    return sample ? launch_wide<kVec, true>(p, s)
                  : launch_wide<kVec, false>(p, s);
  }
  if (sample) {
    token_pick_block_kernel<kVec, true><<<p.rows, kRowThreads, 0, s>>>(p);
  } else {
    token_pick_block_kernel<kVec, false><<<p.rows, kRowThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace


// The pick of each of `rows` rows of logits (rows, vocab) of dtype (0
// float32, 1 bfloat16), rows `stride` elements apart, into tokens (rows,)
// int64 and, when logprobs is not null, the chosen tokens' log-softmax
// (rows,) float32. noise: (rows, vocab) float32 uniforms, contiguous, for
// a sampled pick at inv_t = 1 / temperature (> 0), with top_k (0 for
// none) and, when has_top_p, the nucleus top_p in (0, 1]; null for a
// greedy one (the settings unread). vec: 16 bytes' worth of dtype, with
// vocab and stride multiples of it and the logits and the noise 16-byte
// aligned, or 1. Rows wider than 2,048 take up to 458,752 columns. One
// launch.
extern "C" int token_pick(const void* logits, long long stride,
                          const float* noise, long long* tokens,
                          float* logprobs, int rows, int vocab, int dtype,
                          int vec, float inv_t, int top_k, float top_p,
                          int has_top_p, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  if (logits == nullptr || tokens == nullptr || rows < 1 || vocab < 1
      || dtype < 0 || dtype > 1 || (vec != 1 && vec != wide)
      || vocab % vec != 0 || stride % vec != 0
      || (rows > 1 && stride < vocab)
      || (vocab > kRowElems
          && slice_elems(vocab, vec, kClusterBlocks) > kSliceElems)
      || rows > INT_MAX / kClusterBlocks
      || !vector_io::aligned(logits, vec, dtype)
      || !vector_io::aligned(noise, vec, 0)) {
    return cudaErrorInvalidValue;
  }
  if (noise != nullptr
      && (!(inv_t > 0.0f && inv_t <= FLT_MAX) || top_k < 0
          || (has_top_p && !(top_p > 0.0f && top_p <= 1.0f)))) {
    return cudaErrorInvalidValue;
  }
  const Params p{logits, noise, tokens, logprobs, stride, rows, vocab,
                 dtype, inv_t, top_k, top_p, has_top_p};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) return launch<8>(p, s);
  if (vec == 4) return launch<4>(p, s);
  return launch<1>(p, s);
}

// The text of a cudaError_t that token_pick returned.
extern "C" const char* token_pick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

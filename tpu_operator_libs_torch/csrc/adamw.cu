// The training step's AdamW update over every parameter leaf in one
// launch (more than kMaxLeaves leaves take one launch for each kMaxLeaves).
//
// Replaces optax.adamw(lr) (b1 0.9, b2 0.999, eps 1e-8, weight decay
// 1e-4), optionally behind optax.clip_by_global_norm, as tpu_operator_libs/
// examples/llama.py::make_train_step builds it (:400-404) and applies it
// (:411-413), and optax.adam (weight decay 0) of examples/
// jax_training_job.py. XLA fuses it on the TPU (no Pallas source). The
// port's plain version is kernels/adamw.py::adamw_update_reference
// (optim.AdamW.update's body), about 16 elementwise kernels a leaf.
//
// Bound: bytes. Per element it reads p, g, m and v and writes new p, m
// and v, 14 bytes in bfloat16 (28 in float32), with ~15 float32
// operations: llama-277M's 277M elements move 3.9 GB in bfloat16, 1.16 ms
// at 3.35 TB/s. The design is a multi-tensor pass: the launch takes a
// table of the leaves' pointers and sizes in its parameters (48 leaves x
// 7 pointers fit the 4 KB parameter space; the table is read through
// __grid_constant__, so nothing is copied per thread), and its blocks take
// fixed chunks of the leaves' joint index space (kThreads x
// kVectorsPerThread vectors of 16 bytes): a block finds its leaf by a
// binary search of the chunk prefix sums, and every thread issues its
// four inputs' loads before the arithmetic. The update is functional: the
// outputs are new tensors, and the inputs stay as they were.
//
// Every operation is the plain version's, rounded to the leaf's dtype as
// PyTorch rounds it, with no FMA contraction, so the outputs equal the
// plain version's bit for bit:
//   g  = keep ? g : R(R(g / norm) * clip)            (clip only)
//   m' = R(R(c1 g) + R(b1 m))     v' = R(R(R(c2 g) g) + R(b2 v))
//   u  = R(R(m' / bias1) / R(R(sqrt(R(v' / bias2))) + eps))
//   u  = R(u + R(wd p))                              (wd != 0 only)
//   u  = R(u * -lr), or R(lr_t * u) for a schedule's 0-d tensor
//   p' = R(p + u)
// R rounds to the leaf's dtype; c1 = 1 - b1 and c2 = 1 - b2 are the
// float32 values of the Python doubles, as PyTorch takes a Python number;
// the 0-d tensors (bias1, bias2, norm: the dtype's; keep; lr_t = the
// dtype's -lr) are read through pointers, so no value comes back to the
// host; divisions are IEEE (PyTorch divides by a 0-d device tensor, not
// by a reciprocal) and the square root correctly rounded.
//
// global_norm: the clip's sums of squares, sum_i g_i^2 in float32 for
// every gradient leaf, and sqrt of their sum. Replaces optax.global_norm
// under optax.clip_by_global_norm (tpu_operator_libs/examples/llama.py:
// 400-404; XLA-fused, no Pallas source); the port's plain version,
// kernels/global_norm.py::sum_of_squares_reference, is
// torch.sum(g.float() ** 2) a leaf (three kernels a leaf through float32
// copies). Bound: bytes, each gradient read once (554 MB for llama-277M
// in bfloat16, 0.165 ms at 3.35 TB/s), two float32 operations an element.
// The launch takes the AdamW update's table (one pointer a leaf) and its
// blocks take chunks of kThreads x kNormVectors 16-byte vectors, every
// load issued before the sum; a chunk's squares (fused multiply-adds, in
// float32) add up a thread, then in a fixed order over the block into the
// chunk's partial. The block that draws the last ticket (ticket.cuh) adds
// each leaf's partials in a fixed order (a warp a leaf, its lanes over
// strided chunks, then a butterfly), then the leaves' sums in leaf order
// from 0, as the plain version's Python sum does, and takes the correctly
// rounded square root. No float atomics: launches and replays give the
// same bits. Against the plain version the sums take another order, so
// they agree within 1e-5 relative, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ticket.cuh"
#include "vector_io.cuh"

namespace {

constexpr int kMaxLeaves = 48;
constexpr int kThreads = 256;
constexpr int kVectorsPerThread = 4;

struct Leaf {
  const void* p;
  const void* g;
  const void* m;
  const void* v;
  void* p_out;
  void* m_out;
  void* v_out;
  long long n;
};

// The leaves of one launch (up to kMaxLeaves, their pointers in the
// launch's parameters) and the chunks of their joint index space: the
// AdamW update's and the global norm's
template <typename LeafT>
struct LeafTable {
  LeafT leaf[kMaxLeaves];
  // the first chunk of each leaf, and the chunks in all at [count]
  int first_chunk[kMaxLeaves + 1];
  int count;

  // The leaf of a block's chunk: the last leaf whose first chunk is at or
  // before it (a binary search of the prefix sums)
  __device__ __forceinline__ int leaf_of(int chunk) const {
    int lo = 0, hi = count;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (first_chunk[mid] <= chunk) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    return lo;
  }

  // first_chunk from the leaves' sizes in chunks of `chunk` elements (the
  // leaves set first); false if one is empty or the chunks overflow an int
  bool set_chunks(long long chunk) {
    long long chunks = 0;
    for (int i = 0; i < count; ++i) {
      if (leaf[i].n < 1) return false;
      first_chunk[i] = static_cast<int>(chunks);
      chunks += (leaf[i].n + chunk - 1) / chunk;
      if (chunks > 0x7fffffffLL) return false;
    }
    first_chunk[count] = static_cast<int>(chunks);
    return true;
  }
};

struct Table : LeafTable<Leaf> {
  int dtype;  // 0 float32, 1 bfloat16
  // 0-d tensors of dtype (keep: bool); lr_t and norm null when unused
  const void* bias1;
  const void* bias2;
  const void* lr_t;
  const void* norm;
  const bool* keep;
  float c1, b1, c2, b2, eps, weight_decay, clip, neg_lr;
};
static_assert(sizeof(Table) <= 4096, "the table must fit the parameters");

// The scalars of a launch as float32, read once a thread
struct Scalars {
  float c1, b1, c2, b2, eps, weight_decay, clip, neg_lr, bias1, bias2,
      lr_t, norm;
  bool use_lr_t, clipping, keep;
};

__device__ __forceinline__ float scalar(const void* p, int dtype) {
  float x[1];
  vector_io::load<1>(p, 0, dtype, x);
  return x[0];
}

// One element: the plain version's operations in its order
__device__ __forceinline__ void update(const Scalars& s, int dtype, float p,
                                       float g, float& m, float& v,
                                       float& p_out) {
  using vector_io::round_to;
  if (s.clipping && !s.keep) {
    g = round_to(__fmul_rn(round_to(__fdiv_rn(g, s.norm), dtype), s.clip),
                 dtype);
  }
  m = round_to(__fadd_rn(round_to(__fmul_rn(s.c1, g), dtype),
                         round_to(__fmul_rn(s.b1, m), dtype)),
               dtype);
  v = round_to(
      __fadd_rn(round_to(__fmul_rn(round_to(__fmul_rn(s.c2, g), dtype), g),
                         dtype),
                round_to(__fmul_rn(s.b2, v), dtype)),
      dtype);
  const float m_hat = round_to(__fdiv_rn(m, s.bias1), dtype);
  const float v_hat = round_to(__fdiv_rn(v, s.bias2), dtype);
  const float den =
      round_to(__fadd_rn(round_to(__fsqrt_rn(v_hat), dtype), s.eps), dtype);
  float u = round_to(__fdiv_rn(m_hat, den), dtype);
  if (s.weight_decay != 0.0f) {
    u = round_to(__fadd_rn(u, round_to(__fmul_rn(s.weight_decay, p), dtype)),
                 dtype);
  }
  u = round_to(s.use_lr_t ? __fmul_rn(s.lr_t, u) : __fmul_rn(u, s.neg_lr),
               dtype);
  p_out = round_to(__fadd_rn(p, u), dtype);
}

template <int kVec>
__device__ __forceinline__ void update_at(const Leaf& leaf, long long i,
                                          const Scalars& s, int dtype) {
  float p[kVec], g[kVec], m[kVec], v[kVec], p_out[kVec];
  vector_io::load<kVec>(leaf.p, i, dtype, p);
  vector_io::load<kVec>(leaf.g, i, dtype, g);
  vector_io::load<kVec>(leaf.m, i, dtype, m);
  vector_io::load<kVec>(leaf.v, i, dtype, v);
#pragma unroll
  for (int e = 0; e < kVec; ++e) update(s, dtype, p[e], g[e], m[e], v[e],
                                        p_out[e]);
  vector_io::store<kVec>(leaf.p_out, i, dtype, p_out);
  vector_io::store<kVec>(leaf.m_out, i, dtype, m);
  vector_io::store<kVec>(leaf.v_out, i, dtype, v);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ Table t) {
  constexpr long long kChunk = kThreads * kVectorsPerThread * kVec;
  const int chunk = blockIdx.x;
  const int lo = t.leaf_of(chunk);
  const Leaf& leaf = t.leaf[lo];
  const long long start = (chunk - t.first_chunk[lo]) * kChunk;
  const long long end = min(start + kChunk, leaf.n);
  const int dtype = t.dtype;
  Scalars s;
  s.c1 = t.c1;
  s.b1 = t.b1;
  s.c2 = t.c2;
  s.b2 = t.b2;
  s.eps = t.eps;
  s.weight_decay = t.weight_decay;
  s.clip = t.clip;
  s.neg_lr = t.neg_lr;
  s.bias1 = scalar(t.bias1, dtype);
  s.bias2 = scalar(t.bias2, dtype);
  s.use_lr_t = t.lr_t != nullptr;
  s.lr_t = s.use_lr_t ? scalar(t.lr_t, dtype) : 0.0f;
  s.clipping = t.norm != nullptr;
  s.norm = s.clipping ? scalar(t.norm, dtype) : 0.0f;
  s.keep = s.clipping && *t.keep;
#pragma unroll
  for (int r = 0; r < kVectorsPerThread; ++r) {
    const long long i =
        start + (static_cast<long long>(r) * kThreads + threadIdx.x) * kVec;
    if (i + kVec <= end) {
      update_at<kVec>(leaf, i, s, dtype);
    } else {
      // the leaf's last elements, past its last whole vector
      for (long long e = i; e < end; ++e) update_at<1>(leaf, e, s, dtype);
    }
  }
}

// The global norm's vectors a thread: a chunk is kThreads x kNormVectors
// vectors (16,384 bfloat16 or 8,192 float32 elements where vectors are 16
// bytes)
constexpr int kNormVectors = 8;
constexpr int kWarps = kThreads / 32;

struct NormLeaf {
  const void* g;
  long long n;
};

struct NormTable : LeafTable<NormLeaf> {
  int dtype;        // 0 float32, 1 bfloat16
  int first;        // the launch's first leaf among all the leaves
  float* partials;  // a float a chunk: the chunk's sum of squares
  float* sums;      // every leaf's sum of squares; this launch's from first
  float* norm;      // 0-d: sqrt of every leaf's sum (the last launch), or
                    // null
  int* counter;     // one ticket counter, 0 between launches
};
static_assert(sizeof(NormTable) <= 4096,
              "the table must fit the parameters");

// x summed over the warp in a fixed butterfly: every lane gets the same
// bits (each pair adds the same two values)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// x summed over the block, warps in order (thread 0's result is the
// block's; `scratch` holds a float a warp)
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

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    global_norm_kernel(const __grid_constant__ NormTable t) {
  constexpr long long kChunk = kThreads * kNormVectors * kVec;
  __shared__ float scratch[kMaxLeaves > kWarps ? kMaxLeaves : kWarps];
  __shared__ int ticket;
  const int chunk = blockIdx.x;
  const int lo = t.leaf_of(chunk);
  const NormLeaf& leaf = t.leaf[lo];
  const long long start = (chunk - t.first_chunk[lo]) * kChunk;
  const long long end = min(start + kChunk, leaf.n);
  const int dtype = t.dtype;
  float acc = 0.0f;
  if constexpr (kVec == 8) {
    // bfloat16 (the only dtype of 8-element vectors), kept packed until
    // its arithmetic: half the registers of the widened values, so more
    // blocks, and more loads, in flight on each SM
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(leaf.g);
    uint4 raw[kNormVectors];
#pragma unroll
    for (int r = 0; r < kNormVectors; ++r) {
      const long long i = start + (static_cast<long long>(r) * kThreads
                                   + threadIdx.x) * kVec;
      raw[r] = i + kVec <= end ? *reinterpret_cast<const uint4*>(g + i)
                               : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < kNormVectors; ++r) {
      const uint32_t w[4] = {raw[r].x, raw[r].y, raw[r].z, raw[r].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // a bfloat16 is the high half of the float32 with the same bits
        const float lo = __uint_as_float(w[c] << 16);
        const float hi = __uint_as_float(w[c] & 0xffff0000u);
        acc = __fmaf_rn(hi, hi, __fmaf_rn(lo, lo, acc));
      }
    }
    // the leaf's last elements, past its last whole vector
#pragma unroll
    for (int r = 0; r < kNormVectors; ++r) {
      const long long i = start + (static_cast<long long>(r) * kThreads
                                   + threadIdx.x) * kVec;
      for (long long e = i; e < end && i + kVec > end; ++e) {
        const float v = __bfloat162float(g[e]);
        acc = __fmaf_rn(v, v, acc);
      }
    }
  } else {
    float x[kNormVectors][kVec];
#pragma unroll
    for (int r = 0; r < kNormVectors; ++r) {
      const long long i = start + (static_cast<long long>(r) * kThreads
                                   + threadIdx.x) * kVec;
      if (i + kVec <= end) {
        vector_io::load<kVec>(leaf.g, i, dtype, x[r]);
      } else {
        // the leaf's last elements, past its last whole vector
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float one[1] = {0.0f};
          if (i + e < end) vector_io::load<1>(leaf.g, i + e, dtype, one);
          x[r][e] = one[0];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kNormVectors; ++r) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc = __fmaf_rn(x[r][e], x[r][e], acc);
    }
  }
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) t.partials[chunk] = acc;
  if (!tickets::last(t.counter, gridDim.x, &ticket)) return;
  // the last block: each leaf's partials, a warp a leaf
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = warp; l < t.count; l += kWarps) {
    float sum = 0.0f;
    for (int c = t.first_chunk[l] + lane; c < t.first_chunk[l + 1]; c += 32) {
      sum += t.partials[c];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      t.sums[t.first + l] = sum;
      scratch[l] = sum;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (t.norm != nullptr) {
      // the earlier launches' leaves (written before this launch began),
      // then this one's, in leaf order
      float total = 0.0f;
      for (int l = 0; l < t.first; ++l) total = __fadd_rn(total, t.sums[l]);
      for (int l = 0; l < t.count; ++l) total = __fadd_rn(total, scratch[l]);
      *t.norm = __fsqrt_rn(total);
    }
    *t.counter = 0;
  }
}

}  // namespace

// One AdamW update over n_leaves leaves: pointers holds, for each leaf,
// p, g, m, v (read) and p_out, m_out, v_out (written), sizes its elements
// (at least 1); every buffer contiguous, of dtype (0 float32, 1
// bfloat16). bias1, bias2 are 0-d tensors of dtype; lr_t a 0-d tensor of
// dtype holding -lr (a schedule's), or null to take neg_lr; norm a 0-d
// tensor of dtype and keep a 0-d bool (norm < clip), or both null without
// clipping. vec: 8 (bf16) or 4 (f32) with every buffer 16-byte aligned,
// else 1. Launches one kernel for each kMaxLeaves leaves; returns the
// first error.
extern "C" int adamw(const void* const* pointers, const long long* sizes,
                     int n_leaves, const void* bias1, const void* bias2,
                     const void* lr_t, const void* norm, const void* keep,
                     float c1, float b1, float c2, float b2, float eps,
                     float weight_decay, float clip, float neg_lr, int dtype,
                     int vec, void* stream) {
  if (n_leaves < 1 || dtype < 0 || dtype > 1 || bias1 == nullptr
      || bias2 == nullptr || (norm == nullptr) != (keep == nullptr)
      || (vec != 1 && vec != 16 / (dtype == 0 ? 4 : 2))) {
    return cudaErrorInvalidValue;
  }
  const long long chunk =
      static_cast<long long>(kThreads) * kVectorsPerThread * vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    Table t{};
    t.count = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    t.dtype = dtype;
    t.bias1 = bias1;
    t.bias2 = bias2;
    t.lr_t = lr_t;
    t.norm = norm;
    t.keep = static_cast<const bool*>(keep);
    t.c1 = c1;
    t.b1 = b1;
    t.c2 = c2;
    t.b2 = b2;
    t.eps = eps;
    t.weight_decay = weight_decay;
    t.clip = clip;
    t.neg_lr = neg_lr;
    for (int i = 0; i < t.count; ++i) {
      const void* const* ptr = pointers + 7LL * (first + i);
      for (int j = 0; j < 7; ++j) {
        if (ptr[j] == nullptr || !vector_io::aligned(ptr[j], vec, dtype)) {
          return cudaErrorInvalidValue;
        }
      }
      t.leaf[i] = Leaf{ptr[0],
                       ptr[1],
                       ptr[2],
                       ptr[3],
                       const_cast<void*>(ptr[4]),
                       const_cast<void*>(ptr[5]),
                       const_cast<void*>(ptr[6]),
                       sizes[first + i]};
    }
    if (!t.set_chunks(chunk)) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>(t.first_chunk[t.count]);
    if (vec == 8) {
      adamw_kernel<8><<<blocks, kThreads, 0, s>>>(t);
    } else if (vec == 4) {
      adamw_kernel<4><<<blocks, kThreads, 0, s>>>(t);
    } else {
      adamw_kernel<1><<<blocks, kThreads, 0, s>>>(t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The text of a cudaError_t that adamw returned.
extern "C" const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The sums of squares of n_leaves gradient leaves (g[i]: sizes[i] >= 1
// elements, contiguous, of dtype: 0 float32, 1 bfloat16) into sums
// (n_leaves floats), one launch for each kMaxLeaves leaves; with norm
// also sqrt of their sum in leaf order into the 0-d float norm, in the
// last launch. partials: n_partials floats of scratch, at least a
// launch's chunks of kThreads x kNormVectors x vec elements (the launches
// reuse it in stream order); counter: one int, 0, left 0. vec: 8 (bf16)
// or 4 (f32) with every leaf 16-byte aligned, else 1. Returns the first
// error.
extern "C" int global_norm(const void* const* g, const long long* sizes,
                           int n_leaves, float* partials,
                           long long n_partials, float* sums, float* norm,
                           int* counter, int dtype, int vec, void* stream) {
  if (n_leaves < 1 || dtype < 0 || dtype > 1 || partials == nullptr
      || sums == nullptr || counter == nullptr
      || (vec != 1 && vec != 16 / (dtype == 0 ? 4 : 2))) {
    return cudaErrorInvalidValue;
  }
  const long long chunk = static_cast<long long>(kThreads) * kNormVectors
                          * vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    NormTable t{};
    t.count = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    t.dtype = dtype;
    t.first = first;
    t.sums = sums;
    t.norm = first + t.count == n_leaves ? norm : nullptr;
    t.counter = counter;
    t.partials = partials;
    for (int i = 0; i < t.count; ++i) {
      const void* ptr = g[first + i];
      if (ptr == nullptr || !vector_io::aligned(ptr, vec, dtype)) {
        return cudaErrorInvalidValue;
      }
      t.leaf[i] = NormLeaf{ptr, sizes[first + i]};
    }
    if (!t.set_chunks(chunk) || t.first_chunk[t.count] > n_partials) {
      return cudaErrorInvalidValue;
    }
    const unsigned blocks = static_cast<unsigned>(t.first_chunk[t.count]);
    if (vec == 8) {
      global_norm_kernel<8><<<blocks, kThreads, 0, s>>>(t);
    } else if (vec == 4) {
      global_norm_kernel<4><<<blocks, kThreads, 0, s>>>(t);
    } else {
      global_norm_kernel<1><<<blocks, kThreads, 0, s>>>(t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

struct Table {
  Leaf leaf[kMaxLeaves];
  // the first chunk of each leaf, and the chunks in all at [count]
  int first_chunk[kMaxLeaves + 1];
  int count;
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
  // the last leaf whose first chunk is at or before this one
  int lo = 0, hi = t.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (t.first_chunk[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
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
    long long chunks = 0;
    for (int i = 0; i < t.count; ++i) {
      const void* const* ptr = pointers + 7LL * (first + i);
      const long long n = sizes[first + i];
      if (n < 1) return cudaErrorInvalidValue;
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
                       n};
      t.first_chunk[i] = static_cast<int>(chunks);
      chunks += (n + chunk - 1) / chunk;
      if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
    }
    t.first_chunk[t.count] = static_cast<int>(chunks);
    const unsigned blocks = static_cast<unsigned>(chunks);
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

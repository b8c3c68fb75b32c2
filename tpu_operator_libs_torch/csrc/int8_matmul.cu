// The int8-weight matmul (W8A16): out = (x @ q) * s with int8 codes q read
// as int8 from device memory and converted in registers.
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
// bf16 x bf16 product is exact in f32, so every FMA rounds only its sum.
//
// Bound: at decode (M = batch, 2 to 8) bytes. The weight's K*N int8 bytes
// dominate `K*N + 2*M*K + 2*M*N + 4*N`; at 3.35 TB/s a (2048, 8192)
// weight takes 5.0 us. At prefill (M = 512) the larger of that and
// 2*M*K*N FLOPs at 989 TFLOP/s (4.3 us for (2048, 2048)); this kernel
// runs its FMAs on the CUDA cores, not the tensor cores, so prefill is
// bound by its FMA rate instead (later work: mma/wgmma on the codes).
//
// Design for that bound. A block of 256 threads owns a strip of 128
// columns and up to 8 rows of x (kM); each thread loads 16 neighbouring
// codes of a row at once (one 16-byte load, eight threads on a row's
// 128 contiguous bytes) and 8 rows of K at a time, all in flight before
// their FMAs; the 32 thread groups of the block walk K 32 rows apart.
// The block's slice of x is staged in shared memory as f32, 256 rows of
// K at a time, while that chunk's codes are in flight. At M = 8 a (2048,
// 2048) weight has only 16 strips for 132 SMs, so K is split over blocks
// (split-K, at most 8 splits, chosen by the wrapper from the SM count to
// fill one wave). No float atomics: each block sums its 32 thread groups
// by a fixed butterfly and then in warp order, the splits' sums go to an
// f32 workspace (splits, M, N), and a second pass adds them in split
// order and applies the epilogue. Two launches on the same inputs are
// bit-equal, and so are the host-driven and the graph-replayed decode
// loops. (Measured on the H100: a cluster of the split blocks reducing
// over distributed shared memory ran the 128-block decode launches
// slower than this second pass, and prefetching the next chunk's codes
// gained nothing.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;                   // codes a thread loads at once
constexpr int kColLanes = 8;                // threads across a strip
constexpr int kBlockN = kColLanes * kCols;  // 128 columns a block
constexpr int kGroups = kThreads / kColLanes;  // 32 rows of K at once
constexpr int kChunkK = 256;                // rows of K staged per pass
constexpr int kRowsPerThread = kChunkK / kGroups;  // 8
constexpr int kMaxSplits = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// 16 codes of row `row` from column n0: one 16-byte load when every row
// is 16-byte aligned (kVec), else bytewise with the ragged edge masked.
// Masked codes are 0.
template <bool kVec>
__device__ __forceinline__ int4 load_codes(const int8_t* __restrict__ q,
                                           long long row, bool row_ok,
                                           int n0, int N) {
  if (kVec) {
    if (!row_ok || n0 >= N) return make_int4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const int4*>(q + row * N + n0));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (n0 + j < N) {
        w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         __ldg(q + row * N + n0 + j)))
                     << (8 * (j & 3));
      }
    }
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}

// The codes of rows [kc, kc + rows) of K that this thread multiplies.
template <bool kVec>
__device__ __forceinline__ void load_chunk(int4 (&codes)[kRowsPerThread],
                                           const int8_t* __restrict__ q,
                                           int kc, int rows, int group,
                                           int n0, int N) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = group + i * kGroups;
    codes[i] = load_codes<kVec>(q, static_cast<long long>(kc) + r, r < rows,
                                n0, N);
  }
}

// One block: columns [blockIdx.x * 128, +128), rows of x [blockIdx.z * kM,
// +kM), rows of K [blockIdx.y * k_per_split, +k_per_split). Writes the
// f32 sums to `partial` (split-K) or, with no split, the epilogue to out.
template <typename T, int kM, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ s, T* __restrict__ out,
                       float* __restrict__ partial, int M, int K, int N,
                       int k_per_split) {
  __shared__ __align__(16) float xs[kChunkK][kM];
  __shared__ __align__(16) float red[kWarps][kM][kBlockN];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_lane = tid % kColLanes;
  const int group = tid / kColLanes;
  const int n0 = blockIdx.x * kBlockN + col_lane * kCols;
  const int m0 = blockIdx.z * kM;
  const int split = blockIdx.y;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[kM][kCols];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;
  }

  for (int kc = k_begin; kc < k_end; kc += kChunkK) {
    const int rows = min(kChunkK, k_end - kc);
    // the codes first: x is staged while they are in flight
    int4 codes[kRowsPerThread];
    load_chunk<kVec>(codes, q, kc, rows, group, n0, N);
    // x[m0 + m, kc + r] -> xs[r][m], zero past M and past the chunk;
    // neighbouring threads read neighbouring r (a row of x)
    for (int i = tid; i < kChunkK * kM; i += kThreads) {
      const int m = i / kChunkK;
      const int r = i % kChunkK;
      xs[r][m] = (m0 + m < M && r < rows)
                     ? to_float(x[static_cast<long long>(m0 + m) * K + kc + r])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = group + i * kGroups;
      float xv[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) xv[m] = xs[r][m];
      const uint32_t w[4] = {static_cast<uint32_t>(codes[i].x),
                             static_cast<uint32_t>(codes[i].y),
                             static_cast<uint32_t>(codes[i].z),
                             static_cast<uint32_t>(codes[i].w)};
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float code = static_cast<float>(
            static_cast<int8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu));
#pragma unroll
        for (int m = 0; m < kM; ++m) acc[m][j] = fmaf(xv[m], code, acc[m][j]);
      }
    }
    __syncthreads();
  }

  // the warp's four row groups (lanes 8 apart) by a fixed butterfly
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
      for (int j = 0; j < kCols; ++j) red[warp][m][lane * kCols + j] = acc[m][j];
    }
  }
  __syncthreads();
  // then the warps in order
  for (int i = tid; i < kM * kBlockN; i += kThreads) {
    const int m = i / kBlockN;
    const int c = i % kBlockN;
    float sum = red[0][m][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w][m][c];
    const int row = m0 + m;
    const int n = blockIdx.x * kBlockN + c;
    if (row >= M || n >= N) continue;
    const long long at = static_cast<long long>(row) * N + n;
    if (partial != nullptr) {
      partial[static_cast<long long>(split) * M * N + at] = sum;
    } else {
      out[at] = epilogue(sum, s[n], static_cast<T*>(nullptr));
    }
  }
}

// The split-K pass: the splits' sums added in split order, then the
// epilogue. One thread an output element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_reduce_kernel(const float* __restrict__ partial,
                              const float* __restrict__ s,
                              T* __restrict__ out, int M, int N, int splits) {
  const long long elems = static_cast<long long>(M) * N;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= elems) return;
  float sum = partial[i];
  for (int p = 1; p < splits; ++p) sum += partial[p * elems + i];
  out[i] = epilogue(sum, s[i % N], static_cast<T*>(nullptr));
}

// The rows of x a block takes; tpu_operator_libs_torch/kernels/
// int8_matmul.py::m_tile mirrors it for the split plan.
int m_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

template <typename T, int kM>
void launch_tiles(const T* x, const int8_t* q, const float* s, T* out,
                  float* partial, int M, int K, int N, int splits,
                  int k_per_split, bool vec, cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits, (M + kM - 1) / kM);
  if (vec) {
    int8_matmul_kernel<T, kM, true><<<grid, kThreads, 0, stream>>>(
        x, q, s, out, partial, M, K, N, k_per_split);
  } else {
    int8_matmul_kernel<T, kM, false><<<grid, kThreads, 0, stream>>>(
        x, q, s, out, partial, M, K, N, k_per_split);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   void* partial, int M, int K, int N, int splits,
                   int k_per_split, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(s);
  T* ot = static_cast<T*>(out);
  float* pt = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const bool vec =
      N % kCols == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  switch (m_tile(M)) {
    case 1: launch_tiles<T, 1>(xt, qt, st, ot, pt, M, K, N, splits,
                               k_per_split, vec, stream); break;
    case 2: launch_tiles<T, 2>(xt, qt, st, ot, pt, M, K, N, splits,
                               k_per_split, vec, stream); break;
    case 4: launch_tiles<T, 4>(xt, qt, st, ot, pt, M, K, N, splits,
                               k_per_split, vec, stream); break;
    default: launch_tiles<T, 8>(xt, qt, st, ot, pt, M, K, N, splits,
                                k_per_split, vec, stream); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long elems = static_cast<long long>(M) * N;
  const long long blocks = (elems + kThreads - 1) / kThreads;
  int8_matmul_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(pt, st, ot, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) of dtype 0 = float32 or 1 = bfloat16, q (K, N) int8, s (N,)
// float32, out (M, N) of x's dtype, all contiguous. K is cut into
// `splits` (1 to 8) slices of `k_per_split` rows, the last possibly
// shorter and none empty; with splits > 1, `partial` is an f32 workspace
// of (splits, M, N) elements.
extern "C" int int8_matmul(const void* x, const void* q, const void* s,
                           void* out, void* partial, int M, int K, int N,
                           int splits, int k_per_split, int dtype,
                           void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || splits > kMaxSplits ||
      k_per_split < 1 ||
      static_cast<long long>(splits) * k_per_split < K ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      (splits > 1 && partial == nullptr) ||
      (M + m_tile(M) - 1) / m_tile(M) > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, q, s, out, partial, M, K, N, splits, k_per_split,
                         st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, q, s, out, partial, M, K, N, splits,
                                 k_per_split, st);
  }
  return cudaErrorInvalidValue;
}

// The text of a cudaError_t that int8_matmul returned.
extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

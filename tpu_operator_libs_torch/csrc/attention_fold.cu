// The ring-attention block fold: folds one block's flash-attention output
// into the running state of its query rows, in place.
//
// Replaces the state update of
// tpu_operator_libs/examples/ring_attention.py::_block_attention (:25-57),
// an f32 online-softmax update that XLA fuses on the TPU (it has no Pallas
// source). There the state is (m, l, acc); here it is (acc, lse), with
// lse = m + log l and acc already divided by l, because each block comes
// from the flash forward kernel as its normalised output and log-sum-exp
// (o_blk, lse_blk):
//
//   lse = logaddexp(lse_acc, lse_blk)
//   acc = exp(lse_acc - lse) * acc + exp(lse_blk - lse) * o_blk
//
// A row that has seen nothing has lse -inf. The reference's guard
// (:46-50) substitutes 0 for a -inf running max before the exponentials,
// so a row with nothing in the state or the block gets weights
// exp(-inf - 0) = 0 and stays at zero, never NaN; so does this kernel.
//
// Bound: bytes. A row of D elements reads acc (f32) and o_blk (bf16 or
// f32) and writes acc: 10 bytes an element in bf16 against 3 FLOPs. One
// warp a row: every lane reads the row's two lse values, computes the two
// weights and walks the row four elements at a time (16-byte f32 and
// 8-byte bf16 accesses, neighbouring lanes on neighbouring addresses);
// lane 0 writes the new lse once the whole warp has read the old one.
// The products and the sum are rounded one at a time (no FMA), in the
// order of the plain PyTorch version in kernels/attention_fold.py.
#include "flash_attention_common.cuh"

namespace {

constexpr int kFoldRows = 8;  // rows a block, one warp each

template <typename T>
__global__ void __launch_bounds__(kFoldRows * 32)
    attention_fold_kernel(float* __restrict__ acc,
                          float* __restrict__ lse_acc,
                          const T* __restrict__ o_blk,
                          const float* __restrict__ lse_blk, long long rows,
                          int dim) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kFoldRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float a = lse_acc[row];
  const float b = lse_blk[row];
  // logaddexp as PyTorch computes it, exact for a -inf operand
  const float lse = (isinf(a) && a == b)
                        ? a
                        : fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
  // the guard: a row with nothing anywhere keeps zero weight
  const float safe = isinf(lse) && lse < 0.f ? 0.f : lse;
  const float w_acc = expf(a - safe);
  const float w_blk = expf(b - safe);
  float* out = acc + row * dim;
  const T* blk = o_blk + row * dim;
  for (int j = 4 * lane; j < dim; j += 4 * 32) {
    const float4 x = load4(out + j);
    const float4 y = load4(blk + j);
    store4(out + j,
           make_float4(__fadd_rn(__fmul_rn(w_acc, x.x), __fmul_rn(w_blk, y.x)),
                       __fadd_rn(__fmul_rn(w_acc, x.y), __fmul_rn(w_blk, y.y)),
                       __fadd_rn(__fmul_rn(w_acc, x.z), __fmul_rn(w_blk, y.z)),
                       __fadd_rn(__fmul_rn(w_acc, x.w),
                                 __fmul_rn(w_blk, y.w))));
  }
  __syncwarp();
  if (lane == 0) lse_acc[row] = lse;
}

}  // namespace

// acc (rows, dim) f32 and lse_acc (rows,) f32, updated in place; o_blk
// (rows, dim) of dtype 0 = float32 or 1 = bfloat16 and lse_blk (rows,)
// f32. dim must be a multiple of 4 and every row 16-byte aligned (acc) or
// 8-byte aligned (o_blk): contiguous tensors from PyTorch's allocator are.
extern "C" int attention_fold(void* acc, void* lse_acc, const void* o_blk,
                              const void* lse_blk, long long rows, int dim,
                              int dtype, void* stream) {
  if (rows < 1 || dim < 4 || dim % 4) return cudaErrorInvalidValue;
  const long long blocks = (rows + kFoldRows - 1) / kFoldRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc_f = static_cast<float*>(acc);
  float* lse_f = static_cast<float*>(lse_acc);
  const float* lse_b = static_cast<const float*>(lse_blk);
  if (dtype == 0) {
    attention_fold_kernel<float><<<grid, kFoldRows * 32, 0, s>>>(
        acc_f, lse_f, static_cast<const float*>(o_blk), lse_b, rows, dim);
  } else if (dtype == 1) {
    attention_fold_kernel<__nv_bfloat16><<<grid, kFoldRows * 32, 0, s>>>(
        acc_f, lse_f, static_cast<const __nv_bfloat16*>(o_blk), lse_b, rows,
        dim);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

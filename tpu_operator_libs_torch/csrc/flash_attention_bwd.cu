// Causal flash-attention backward for Hopper (sm_90a): a dK/dV kernel and a
// dQ kernel behind a plain C interface loaded with ctypes
// (tpu_operator_libs_torch/kernels/_build.py).
//
// Replaces: the two Pallas TPU backward kernels that jax.grad of
// tpu_operator_libs/examples/llama.py::next_token_loss reaches with
// attention_impl="flash": jax/experimental/pallas/ops/tpu/flash_attention.py
// ::_flash_attention_bwd_dkv (pl.pallas_call, kernel
// _flash_attention_dkv_kernel) and ::_flash_attention_bwd_dq (pl.pallas_call,
// kernel _flash_attention_dq_kernel).
// Same function: with P = exp(Q K^T * sm_scale - lse) recomputed from the
// forward's per-row log-sum-exp (f32, natural log; the Pallas pair (l, m)
// carries the same information), dP = dO V^T, di = rowsum(O * dO) and
// dS = P * (dP - di):
//   dV = P^T dO,   dK = dS^T Q * sm_scale,   dQ = dS K * sm_scale,
// causal (query i sees keys <= i). di is computed by the caller.
//
// Bound on an H100 SXM, per call at the model's shapes (S >= 1024, D = 128):
// dK/dV does four products (Q K^T, dO V^T, P^T dO, dS^T Q) and dQ three
// (Q K^T, dO V^T, dS K) of 2*D FLOPs per visible (query, key) pair, at 989
// TFLOP/s for bf16 inputs (67 TFLOP/s f32), against Q, K, V, dO, lse and di
// read and the gradients written once at 3.35 TB/s: the FLOPs bound both.
//
// Design, simple first, on the forward's layout (flash_attention_common.cuh):
// 256 threads, four per row, each row's vectors split in float4 chunks over
// its four threads, dot products finished by an xor shuffle, f32 products on
// the CUDA cores.
// - dK/dV: one block per (64-key tile, KV head, batch). The block holds its
//   keys' K and V rows and the dK and dV accumulators in registers and walks
//   the query tiles from the diagonal down (tiles wholly above the diagonal
//   are never loaded), staging Q, dO, lse and di in shared memory as f32
//   (2 * 64 * D * 4 bytes, 64 KB at D = 128). It also walks the H / Hkv query
//   heads of its KV head's group, so GQA's sum over the group happens in
//   registers: no atomics, and K/V are read narrow (the Pallas call needs
//   them repeated to H heads and a sum afterwards). Blocks of the first key
//   tiles, which see the most queries, are scheduled first.
// - dQ: one block per (64-query tile, head, batch), the forward's grid. The
//   block holds its rows' Q, dO and dQ in registers, with lse and di, and
//   walks the K/V tiles up to the diagonal, staged in shared memory as f32.
// Every sum runs in a fixed order and nothing is accumulated across blocks,
// so two launches on the same inputs give bit-equal results.
// What it leaves on the table: as in the forward, the products run as scalar
// f32 FMAs, not on the tensor cores (mma.sync / wgmma would be ~15x the rate
// for bf16), tiles are loaded synchronously rather than by TMA or cp.async,
// and each Q / dO (dK/dV) or K / V (dQ) element is read from shared memory
// twice per pair, once for a dot product and once for an update.
#include <math.h>

#include "flash_attention_common.cuh"

namespace {

// q, dout: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); lse, di: (B, H, Sq) f32;
// dk, dv: (B, Hkv, Sk, D). scale_log2 = sm_scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                     int causal, float scale_log2, float sm_scale) {
  constexpr int kVecs = D / 4;                  // float4 per row
  constexpr int kChunks = kVecs / kRowThreads;  // float4 per thread
  extern __shared__ float4 smem[];
  float4* q_tile = smem;                        // [kBlockM][kVecs]
  float4* do_tile = smem + kBlockM * kVecs;     // [kBlockM][kVecs]
  __shared__ float lse_tile[kBlockM];           // lse * log2(e)
  __shared__ float di_tile[kBlockM];

  const int tile = blockIdx.x;  // the first key tiles see the most queries
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int row = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  const int kj = tile * kBlockN + row;
  const bool key_valid = kj < Sk;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk;

  float4 kr[kChunks], vr[kChunks], dk_acc[kChunks], dv_acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kRowThreads * i;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vx = kx;
    if (key_valid) {
      kx = load4(k + (kv_base + kj) * D + 4 * c);
      vx = load4(v + (kv_base + kj) * D + 4 * c);
    }
    kr[i] = scale4(kx, scale_log2);
    vr[i] = vx;
    dk_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[i] = dk_acc[i];
  }

  // Query i sees key j iff j <= i: the query tiles before the one holding
  // this tile's first key see none of its keys.
  const int q_first = causal ? (tile * kBlockN) / kBlockM : 0;
  const int n_qtiles = (Sq + kBlockM - 1) / kBlockM;

  for (int hh = 0; hh < group; ++hh) {
    const size_t q_base = (static_cast<size_t>(b) * H + hk * group + hh) * Sq;
    for (int t = q_first; t < n_qtiles; ++t) {
      const int q0 = t * kBlockM;
      __syncthreads();  // every thread is done with the previous tile
      for (int e = threadIdx.x; e < kBlockM * kVecs; e += kThreads) {
        const int r = e / kVecs;
        const int c = e % kVecs;
        float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dx = qx;
        if (q0 + r < Sq) {
          const size_t off = (q_base + q0 + r) * D + 4 * c;
          qx = load4(q + off);
          dx = load4(dout + off);
        }
        q_tile[e] = qx;
        do_tile[e] = dx;
      }
      if (threadIdx.x < kBlockM) {
        const int qi = q0 + threadIdx.x;
        lse_tile[threadIdx.x] = qi < Sq ? lse[q_base + qi] * kLog2e : 0.f;
        di_tile[threadIdx.x] = qi < Sq ? di[q_base + qi] : 0.f;
      }
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < kBlockM; ++i) {
        const float4* q_row = q_tile + i * kVecs + sub;
        const float4* do_row = do_tile + i * kVecs + sub;
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          s = dot4(kr[c], q_row[kRowThreads * c], s);
          dp = dot4(vr[c], do_row[kRowThreads * c], dp);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const int qi = q0 + i;
        const bool visible = key_valid && qi < Sq && (!causal || kj <= qi);
        const float p = visible ? exp2f(s - lse_tile[i]) : 0.f;
        const float ds = p * (dp - di_tile[i]);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          dv_acc[c] = axpy4(p, do_row[kRowThreads * c], dv_acc[c]);
          dk_acc[c] = axpy4(ds, q_row[kRowThreads * c], dk_acc[c]);
        }
      }
    }
  }

  if (!key_valid) return;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const size_t off = (kv_base + kj) * D + 4 * (sub + kRowThreads * i);
    store4(dk + off, scale4(dk_acc[i], sm_scale));
    store4(dv + off, dv_acc[i]);
  }
}

// dq: (B, H, Sq, D); the other arguments as for the dK/dV kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int Hkv, int Sq, int Sk, int causal, float scale_log2,
                    float sm_scale) {
  constexpr int kVecs = D / 4;
  constexpr int kChunks = kVecs / kRowThreads;
  extern __shared__ float4 smem[];
  float4* k_tile = smem;                        // [kBlockN][kVecs]
  float4* v_tile = smem + kBlockN * kVecs;      // [kBlockN][kVecs]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  const int qi = tile * kBlockM + row;
  const bool row_valid = qi < Sq;
  const size_t q_base = (static_cast<size_t>(b) * H + h) * Sq;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk;

  float4 qr[kChunks], dor[kChunks], acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = sub + kRowThreads * i;
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dx = qx;
    if (row_valid) {
      qx = load4(q + (q_base + qi) * D + 4 * c);
      dx = load4(dout + (q_base + qi) * D + 4 * c);
    }
    qr[i] = scale4(qx, scale_log2);
    dor[i] = dx;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse2 = row_valid ? lse[q_base + qi] * kLog2e : 0.f;
  const float di_row = row_valid ? di[q_base + qi] : 0.f;

  // Keys past the tile's last query row are masked for every row of it.
  const int kv_end = causal ? min(Sk, (tile + 1) * kBlockM) : Sk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();
    for (int e = threadIdx.x; e < kBlockN * kVecs; e += kThreads) {
      const int r = e / kVecs;
      const int c = e % kVecs;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Sk) {
        const size_t off = (kv_base + k0 + r) * D + 4 * c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      k_tile[e] = kx;
      v_tile[e] = vx;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBlockN; ++j) {
      const float4* k_row = k_tile + j * kVecs + sub;
      const float4* v_row = v_tile + j * kVecs + sub;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        s = dot4(qr[c], k_row[kRowThreads * c], s);
        dp = dot4(dor[c], v_row[kRowThreads * c], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int kj = k0 + j;
      const bool visible = row_valid && kj < Sk && (!causal || kj <= qi);
      const float p = visible ? exp2f(s - lse2) : 0.f;
      const float ds = p * (dp - di_row);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        acc[c] = axpy4(ds, k_row[kRowThreads * c], acc[c]);
      }
    }
  }

  if (!row_valid) return;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    store4(dq + (q_base + qi) * D + 4 * (sub + kRowThreads * i),
           scale4(acc[i], sm_scale));
  }
}

// Both kernels stage two 64-row tiles of f32 (64 KB at D = 128, above the
// 48 KB default, hence the attribute).
template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, int causal, float sm_scale,
                       cudaStream_t stream) {
  const int smem = 2 * kBlockM * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBlockN - 1) / kBlockN, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Sk, causal,
      sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Hkv, int Sq, int Sk,
                      int causal, float sm_scale, cudaStream_t stream) {
  const int smem = 2 * kBlockN * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), H, Hkv, Sq, Sk, causal, sm_scale * kLog2e,
      sm_scale);
  return cudaGetLastError();
}

bool valid_shape(int B, int H, int Hkv, int Sq, int Sk) {
  return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 1 && Sk >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 =
// launched).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv, int B, int H,
                                       int Hkv, int Sq, int Sk, int D,
                                       int dtype, int causal, float sm_scale,
                                       void* stream) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_dkv<T, decltype(dim)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(di), dk, dv, B, H, Hkv, Sq, Sk, causal,
        sm_scale, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, int B, int H, int Hkv,
                                      int Sq, int Sk, int D, int dtype,
                                      int causal, float sm_scale,
                                      void* stream) {
  if (!valid_shape(B, H, Hkv, Sq, Sk)) return cudaErrorInvalidValue;
  const cudaError_t err = dispatch(dtype, D, [&](auto tag, auto dim) {
    using T = typename decltype(tag)::type;
    return launch_dq<T, decltype(dim)::value>(
        q, k, v, dout, static_cast<const float*>(lse),
        static_cast<const float*>(di), dq, B, H, Hkv, Sq, Sk, causal,
        sm_scale, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

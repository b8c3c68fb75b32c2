"""The CUDA kernels (flash attention, the ring-attention fold, the
int8-weight matmul, the decode step's attention and cache write, the
norm with its residual add, the gate and the batch forward's RoPE,
forward and backward, the next-token loss, forward and backward, the
clip's global norm, the AdamW update and the token pick) against their
plain versions, on the card, the
ring's block chain against the whole-sequence kernels, the
graph-replayed decode loop against the host loop on one card and on
NCCL meshes of one and two ranks, and the serving pod over NCCL.

Run on a machine with an NVIDIA H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without CUDA every test here skips (decided in a fixture, not at import,
so that every pytest-xdist worker collects the same tests).
"""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_rank_workers as workers
import tf32_hopper
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.examples import llama_serving_job as serving
from tpu_operator_libs_torch.examples.ring_attention import (
    _block_attention,
    _block_backward,
    _schedule,
)
from tpu_operator_libs_torch.kernels import WRAPPERS
from tpu_operator_libs_torch.kernels import _build
from tpu_operator_libs_torch.kernels import adamw as amod
from tpu_operator_libs_torch.kernels import cross_entropy as lossmod
from tpu_operator_libs_torch.kernels import decode_attention as dmod
from tpu_operator_libs_torch.kernels import flash_attention as fmod
from tpu_operator_libs_torch.kernels import global_norm as nmod
from tpu_operator_libs_torch.kernels import int8_matmul as imod
from tpu_operator_libs_torch.kernels import kv_append as kmod
from tpu_operator_libs_torch.kernels import rms_norm as rmod
from tpu_operator_libs_torch.kernels import rope as ropemod
from tpu_operator_libs_torch.kernels import swiglu as smod
from tpu_operator_libs_torch.kernels import token_pick as pmod
from tpu_operator_libs_torch.kernels.attention_fold import (
    attention_fold,
    attention_fold_reference,
)
from tpu_operator_libs_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from tpu_operator_libs_torch.kernels.kv_append import (
    _rope,
    kv_append,
    kv_append_reference,
    rope_kv_append,
    rope_kv_append_reference,
)
from tpu_operator_libs_torch.kernels.int8_matmul import (
    int8_matmul,
    int8_matmul_reference,
)
from tpu_operator_libs_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_reference,
    flash_backward,
    flash_forward,
    kernel_design,
    launch_blocks,
)
from tpu_operator_libs_torch.parallel import run_ranks

pytestmark = pytest.mark.gpu

#: (rtol, atol): bf16 outputs may differ by one bf16 ulp (<= 2^-7 |out|)
#: since both sides accumulate in f32 and round once; f32 sums differ
#: only in order.
TOL = {torch.bfloat16: (2.0 ** -7, 1e-3), torch.float32: (1e-5, 2e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim,dtype,causal", [
    (8, 16, 16, 1024, 128, torch.bfloat16, True),   # llama-277M forward
    (2, 8, 2, 1000, 64, torch.float32, True),       # GQA and a ragged tile
    # GQA and a ragged tile through the bf16 (wgmma) design
    (2, 8, 2, 1000, 128, torch.bfloat16, True),
    (2, 8, 2, 1000, 64, torch.bfloat16, True),
    # the 3xTF32 design: phases 4 and 7's f32 per-layer call, GQA and a
    # ragged tile at the narrow head_dims, f32 and bf16, and (c) without
    # the mask
    (2, 16, 16, 1024, 128, torch.float32, True),
    (2, 8, 2, 1000, 16, torch.float32, True),
    (2, 8, 2, 1000, 32, torch.float32, True),
    (2, 8, 2, 1000, 16, torch.bfloat16, True),
    (2, 8, 2, 1000, 32, torch.bfloat16, True),
    (2, 8, 2, 1000, 64, torch.float32, False),
], ids=["a_full_width_bf16", "c_gqa_ragged_f32", "d_gqa_ragged_bf16",
        "d64_gqa_ragged_bf16", "f32_main", "d16_gqa_ragged_f32",
        "d32_gqa_ragged_f32", "d16_gqa_ragged_bf16", "d32_gqa_ragged_bf16",
        "c_non_causal_f32"])
def test_kernel_matches_plain_version(cuda, batch, heads, kv_heads, seq,
                                      dim, dtype, causal):
    """The forward against flash_attention_reference: bf16 at head_dim
    64 and 128 runs the wgmma design, every other instance both products
    on the tensor cores by mma.sync as three TF32 products; two launches
    give bit-equal out and lse, each counted under its design."""
    wgmma = dtype == torch.bfloat16 and dim in (64, 128)
    design = "sm90 wgmma" if wgmma else "3xTF32 mma.sync"
    assert kernel_design("flash_attention_fwd", dtype, dim)["design"] \
        == design
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((batch, h, seq, dim), generator=gen,
                           device=cuda).to(dtype)
               for h in (heads, kv_heads, kv_heads))
    kw = {"causal": causal, "sm_scale": dim ** -0.5}
    before = (flash_attention.launches,
              flash_attention.launches_by_design.get(design, 0))
    out, lse = flash_forward(q, k, v, **kw)
    out2, lse2 = flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches,
            flash_attention.launches_by_design.get(design, 0)) \
        == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim,dtype,causal", [
    (16, 16, 16, 1024, 128, torch.bfloat16, True),  # llama-277M train step
    (2, 8, 2, 1000, 64, torch.float32, True),       # GQA and a ragged tile
    # GQA and a ragged tile through the bf16 (wgmma) kernels
    (2, 8, 2, 1000, 128, torch.bfloat16, True),
    (2, 8, 2, 1000, 64, torch.bfloat16, True),
    # an odd length: ragged 64-query and 128-key tiles, lse and di rows
    # of 997 * 4 bytes
    (2, 8, 2, 997, 128, torch.bfloat16, True),
    (2, 8, 2, 1000, 128, torch.bfloat16, False),
    # a ring's past block: no mask
    (1, 16, 16, 2048, 128, torch.bfloat16, False),
    (2, 8, 2, 1000, 64, torch.float32, False),
    # the 3xTF32 design: phase 7's f32 per-layer call, GQA and a ragged
    # tile at the narrow head_dims, f32 and bf16
    (2, 16, 16, 1024, 128, torch.float32, True),
    (2, 8, 2, 1000, 16, torch.float32, True),
    (2, 8, 2, 1000, 32, torch.float32, True),
    (2, 8, 2, 1000, 16, torch.bfloat16, True),
    (2, 8, 2, 1000, 32, torch.bfloat16, True),
], ids=["main_train_step_bf16", "c_gqa_ragged_f32", "d_gqa_ragged_bf16",
        "d64_gqa_ragged_bf16", "odd_gqa_ragged_bf16",
        "d_non_causal_bf16", "ring_block_non_causal_bf16",
        "c_non_causal_f32", "f32_main", "d16_gqa_ragged_f32",
        "d32_gqa_ragged_f32", "d16_gqa_ragged_bf16", "d32_gqa_ragged_bf16"])
def test_backward_kernels_match_plain_version(cuda, batch, heads, kv_heads,
                                              seq, dim, dtype, causal):
    """dK/dV and dQ against flash_attention_backward_reference on the
    forward kernel's out and lse; two launches give bit-equal results
    (no atomics, a fixed order of every sum, the GQA partials added in
    head order with the ticket counters left at 0); bf16 at head_dim 64
    and 128 runs both on the tensor cores by wgmma, every other instance
    by mma.sync as three TF32 products, each launch counted under its
    design."""
    wgmma = dtype == torch.bfloat16 and dim in (64, 128)
    design = "sm90 wgmma" if wgmma else "3xTF32 mma.sync"
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert kernel_design(name, dtype, dim)["design"] == design
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((batch, h, seq, dim), generator=gen,
                               device=cuda).to(dtype)
                   for h in (heads, kv_heads, kv_heads, heads))
    kw = {"causal": causal, "sm_scale": dim ** -0.5}
    out, lse = flash_forward(q, k, v, **kw)
    wrappers = (flash_attention_bwd_dkv, flash_attention_bwd_dq)
    before = [(w.launches, w.launches_by_design.get(design, 0))
              for w in wrappers]
    got = flash_backward(q, k, v, out, lse, do, **kw)
    again = flash_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_by_design.get(design, 0))
            for w in wrappers] == [(n + 2, m + 2) for n, m in before]
    for store in fmod._counters.values():
        for counters in store.values():
            assert int(counters.abs().sum()) == 0
    want = flash_attention_backward_reference(q, k, v, out, lse, do, **kw)
    rtol, atol = TOL[dtype]
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)


def test_gqa_backward_graph_replay_equals_eager(cuda):
    """The 3xTF32 dK/dV's GQA combine draws tickets from counters kept per
    stream: after the stream's first (eager) call, a CUDA graph of the
    backward replays the eager gradients bit for bit, three times (each
    launch leaves its counters at 0), and a capture on a stream with no
    eager call raises before it launches."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn((2, h, 300, 64), generator=gen, device=cuda)
                   for h in (8, 2, 2, 8))
    kw = {"causal": True, "sm_scale": 0.125}
    out, lse = flash_forward(q, k, v, **kw)
    eager = flash_backward(q, k, v, out, lse, do, **kw)
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(fresh):
        with pytest.raises(RuntimeError, match="must not be captured"):
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
                flash_backward(q, k, v, out, lse, do, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_backward(q, k, v, out, lse, do, **kw)  # the eager call
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = flash_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for g, e in zip(got, eager):
            assert torch.equal(g, e)


@pytest.mark.parametrize("dtype,dim,dkv_blocks", [
    (torch.float32, 64, 256), (torch.bfloat16, 128, 32)])
def test_backward_grids_as_launched(cuda, dtype, dim, dkv_blocks):
    """At (2, 8 / 2, 1000) the grids the launchers report are the grids
    torch.profiler records launched (in a process of their own, as
    chip_smoke.py reads them); the 3xTF32 dK/dV spreads each KV head's
    4 query heads over blocks of their own (256 where a block a (64-key
    tile, KV head, batch) would be 64), the wgmma dK/dV takes a block a
    (128-key tile, KV head, batch)."""
    seen = chip_smoke.measure_backward_grids(
        [("c", 2, 8, 2, 1000, dim, dtype, True)])["c"]
    q = torch.empty((2, 8, 1000, dim), dtype=dtype, device=cuda)
    k = torch.empty((2, 2, 1000, dim), dtype=dtype, device=cuda)
    for which in ("dkv", "dq"):
        assert seen[which] == launch_blocks(f"flash_attention_bwd_{which}",
                                            q, k)
    assert seen["dkv"] == dkv_blocks


#: one warp a trial: d = a b + c by one mma.m16n8k8 tf32 (a 16 x 8
#: row-major, b 8 x 8 as [k][n], c and d 16 x 8 row-major), the fragments
#: as csrc/tf32_mma.cuh lays them out
MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void probe(const float* A, const float* B, const float* C,
                      float* D) {
  const float* a = A + blockIdx.x * 128;
  const float* b = B + blockIdx.x * 64;
  const float* c = C + blockIdx.x * 128;
  float* d = D + blockIdx.x * 128;
  const int g = threadIdx.x / 4, t = threadIdx.x % 4;
  const int r[4] = {g * 8 + 2 * t, g * 8 + 2 * t + 1, (g + 8) * 8 + 2 * t,
                    (g + 8) * 8 + 2 * t + 1};
  uint32_t ar[4] = {__float_as_uint(a[g * 8 + t]),
                    __float_as_uint(a[(g + 8) * 8 + t]),
                    __float_as_uint(a[g * 8 + t + 4]),
                    __float_as_uint(a[(g + 8) * 8 + t + 4])};
  uint32_t br[2] = {__float_as_uint(b[t * 8 + g]),
                    __float_as_uint(b[(t + 4) * 8 + g])};
  float acc[4] = {c[r[0]], c[r[1]], c[r[2]], c[r[3]]};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(ar[0]), "r"(ar[1]), "r"(ar[2]), "r"(ar[3]), "r"(br[0]),
        "r"(br[1]));
  for (int i = 0; i < 4; ++i) d[r[i]] = acc[i];
}
extern "C" int run(const float* A, const float* B, const float* C, float* D,
                   int trials) {
  probe<<<trials, 32>>>(A, B, C, D);
  return cudaDeviceSynchronize();
}
"""


@pytest.mark.parametrize("case", ["spread_4", "spread_12", "c_zero",
                                  "k_scaled", "raw_bits"])
def test_tf32_mma_accumulates_as_modelled(cuda, tmp_path, case):
    """One mma.sync m16n8k8 TF32 step on the card gives, bit for bit,
    what tests/tf32_hopper.py's model of it gives (operands cut to TF32,
    c and the products cut toward zero to 2^(e - 25), the sum rounded
    toward zero), on 2048 trials of random signs and exponents: spread
    over +-4 or +-12 octaves, c = 0, the products' sizes spread over 30
    octaves along k, or operands with all 23 mantissa bits set."""
    source = tmp_path / "mma_probe.cu"
    source.write_text(MMA_PROBE)
    lib_path = tmp_path / "mma_probe.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(source)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(7)
    trials = 2048

    def rand(shape, octaves, exact=True):
        x = torch.from_numpy((rng.uniform(1, 2, shape)
                              * np.exp2(rng.integers(-octaves, octaves + 1,
                                                     shape))
                              * rng.choice([-1, 1], shape))
                             .astype(np.float32))
        return tf32_hopper.tf32_hi(x) if exact else x

    a_shape, b_shape, c_shape = (trials, 16, 8), (trials, 8, 8), \
        (trials, 16, 8)
    if case in ("spread_4", "spread_12"):
        octaves = int(case.split("_")[1])
        a, b = rand(a_shape, octaves), rand(b_shape, octaves)
        c = rand(c_shape, octaves, exact=False)
    elif case == "c_zero":
        a, b, c = rand(a_shape, 6), rand(b_shape, 6), torch.zeros(c_shape)
    elif case == "k_scaled":
        a = rand(a_shape, 0) * torch.from_numpy(np.exp2(
            -rng.integers(0, 30, (trials, 1, 8))).astype(np.float32))
        b = rand(b_shape, 0).abs()
        c = torch.from_numpy(rng.uniform(-4, 4, c_shape).astype(np.float32))
    else:
        a, b = rand(a_shape, 3, False), rand(b_shape, 3, False)
        c = rand(c_shape, 3, False)
    on_card = [x.contiguous().to(cuda) for x in (a, b, c)]
    d = torch.empty_like(on_card[2])
    assert lib.run(*(ctypes.c_void_p(x.data_ptr())
                     for x in (*on_card, d)), trials) == 0
    want = tf32_hopper.mma(c, a, b)
    assert torch.equal(d.cpu().view(torch.int32), want.view(torch.int32))


def test_tf32_backward_reads_as_modelled(cuda):
    """The 3xTF32 kernels' dq, dk and dv on the first KV head's group of
    shape (c), batch 0 (1, 4 / 1, 1000, 64), numpy seed 1 as
    tests/test_torch_flash_attention.py draws it, against
    tests/tf32_hopper.py's emulation of their arithmetic on the same
    inputs, lse and di: within a tenth of the f32 limit of each other
    everywhere, and each as far from the plain backward as the other to
    within 0.05 of the limit."""
    rng = np.random.default_rng(1)
    shapes = ((2, 8, 1000, 64), (2, 2, 1000, 64), (2, 2, 1000, 64))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)) for shape in shapes)
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(
        q.shape).astype(np.float32))
    q, do = q[:1, :4].contiguous(), do[:1, :4].contiguous()
    k, v = k[:1, :1].contiguous(), v[:1, :1].contiguous()
    kw = {"causal": True, "sm_scale": 0.125}
    x = [t.to(cuda) for t in (q, k, v, do)]
    out, lse = flash_forward(*x[:3], **kw)
    di = (out * x[3]).sum(-1)
    dk, dv = flash_attention_bwd_dkv(*x, lse, di, **kw)
    dq = flash_attention_bwd_dq(*x, lse, di, **kw)
    want = flash_attention_backward_reference(*x[:3], out, lse, x[3], **kw)
    model = tf32_hopper.tf32_backward(q, k, v, do, lse.cpu(), di.cpu(),
                                      kw["sm_scale"])
    rtol, atol = TOL[torch.float32]
    for got, emulated, w in zip((dq, dk, dv), model, want):
        got, w = got.cpu(), w.cpu()
        assert chip_smoke.limit_use((got - emulated).abs(), emulated, rtol,
                                    atol) <= 0.1
        uses = [chip_smoke.limit_use((y - w).abs(), w, rtol, atol)
                for y in (got, emulated)]
        assert uses[0] <= 1 and abs(uses[0] - uses[1]) <= 0.05, uses


def test_tf32_forward_reads_as_modelled(cuda):
    """The 3xTF32 forward's out and lse on the first KV head's group of
    shape (c), batch 0 (1, 4 / 1, 1000, 64), numpy seed 1 as
    tests/test_torch_flash_attention.py draws it, against
    tests/tf32_hopper.py's emulation of its arithmetic on the same
    inputs: out within a tenth of the f32 limit of each other everywhere
    and each as far from the plain version as the other to within 0.05
    of the limit; both lse within 1e-4 of the plain version's."""
    rng = np.random.default_rng(1)
    shapes = ((2, 8, 1000, 64), (2, 2, 1000, 64), (2, 2, 1000, 64))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)) for shape in shapes)
    q = q[:1, :4].contiguous()
    k, v = k[:1, :1].contiguous(), v[:1, :1].contiguous()
    kw = {"causal": True, "sm_scale": 0.125}
    out, lse = flash_forward(*(t.to(cuda) for t in (q, k, v)), **kw)
    want, want_lse = flash_attention_reference(q, k, v, **kw)
    model, model_lse = tf32_hopper.tf32_forward(q, k, v, kw["sm_scale"])
    out, lse = out.cpu(), lse.cpu()
    rtol, atol = TOL[torch.float32]
    assert chip_smoke.limit_use((out - model).abs(), model, rtol,
                                atol) <= 0.1
    uses = [chip_smoke.limit_use((y - want).abs(), want, rtol, atol)
            for y in (out, model)]
    assert uses[0] <= 1 and abs(uses[0] - uses[1]) <= 0.05, uses
    for x in (lse, model_lse):
        assert (x - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("operand", ["q", "k", "do"])
def test_tf32_backward_refuses_unaligned_rows(cuda, operand):
    """The 3xTF32 kernels stage rows by 16-byte cp.async: a contiguous
    f32 view whose first element is 4 bytes off a 16-byte boundary is
    refused with an error (the launch never runs), not read misaligned,
    by the backward kernels and, for q and k, by the forward."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    shapes = {"q": (1, 2, 64, 16), "k": (1, 1, 64, 16), "do": (1, 2, 64, 16)}
    x = {name: torch.randn(shape, generator=gen, device=cuda)
         for name, shape in shapes.items()}
    x["v"] = torch.randn(shapes["k"], generator=gen, device=cuda)
    kw = {"causal": True, "sm_scale": 0.25}
    out, lse = flash_forward(x["q"], x["k"], x["v"], **kw)
    di = (out * x["do"]).sum(-1)
    flat = torch.empty(x[operand].numel() + 1, device=cuda)
    shifted = flat[1:].view(shapes[operand])
    shifted.copy_(x[operand])
    x[operand] = shifted
    args = (x["q"], x["k"], x["v"], x["do"], lse, di)
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention_bwd_dkv(*args, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention_bwd_dq(*args, **kw)
    if operand != "do":
        with pytest.raises(RuntimeError, match="launch failed"):
            flash_forward(x["q"], x["k"], x["v"], **kw)


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim,dtype", [
    (1, 16, 16, 2048, 128, torch.bfloat16),   # a ring's past block
    (2, 8, 2, 1000, 64, torch.float32),
    (2, 8, 2, 1000, 128, torch.bfloat16),
], ids=["ring_block_bf16", "c_gqa_ragged_f32", "d_gqa_ragged_bf16"])
def test_non_causal_forward_matches_plain_version(cuda, batch, heads,
                                                  kv_heads, seq, dim, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((batch, h, seq, dim), generator=gen,
                           device=cuda).to(dtype)
               for h in (heads, kv_heads, kv_heads))
    kw = {"causal": False, "sm_scale": dim ** -0.5}
    out, lse = flash_forward(q, k, v, **kw)
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fold_kernel_matches_plain_version(cuda, dtype):
    """One launch against the plain version on the same state and
    block, rows 0-63 of head 0 having seen nothing in the state or the
    block: they keep zero weight (the guard), never NaN."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 16, 2048, 128)
    acc = torch.randn(shape, generator=gen, device=cuda)
    o_blk = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    lse = torch.randn(shape[:3], generator=gen, device=cuda) * 4
    lse_blk = torch.randn(shape[:3], generator=gen, device=cuda) * 4
    acc[:, 0, :64], lse[:, 0, :64], lse_blk[:, 0, :64] = (
        0.0, float("-inf"), float("-inf"))
    before = attention_fold.launches
    got_acc, got_lse = attention_fold(acc.clone(), lse.clone(), o_blk,
                                      lse_blk)
    torch.cuda.synchronize()
    assert attention_fold.launches == before + 1
    want_acc, want_lse = attention_fold_reference(acc.clone(), lse.clone(),
                                                  o_blk, lse_blk)
    assert torch.isfinite(got_acc).all()
    assert (got_acc[:, 0, :64] == 0).all()
    assert torch.isneginf(got_lse[:, 0, :64]).all()
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(got_acc, want_acc, rtol=rtol, atol=atol)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=1e-5)


def test_ring_chain_matches_the_whole_sequence(cuda):
    """The ring's schedule on one card over 4 blocks of a bf16 sequence:
    each query block's chain of flash forwards folded by the fold kernel
    against the whole-sequence forward, and the backward's blocks with
    the whole sequence's lse and di against the whole-sequence backward.
    The limit adds to the bf16 one a bf16 ulp of the sum of the blocks'
    magnitudes: each block's result is rounded to bf16 once before the
    f32 sum."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    batch, heads, kv_heads, seq, dim, n = 1, 8, 4, 4096, 128, 4
    width, scale = seq // n, dim ** -0.5
    q, do = (torch.randn((batch, heads, seq, dim), generator=gen,
                         device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn((batch, kv_heads, seq, dim), generator=gen,
                        device=cuda).bfloat16() for _ in range(2))

    def block(x, j):
        return x[:, :, j * width:(j + 1) * width].contiguous()

    out, lse = flash_forward(q, k, v, causal=True, sm_scale=scale)
    grads = flash_backward(q, k, v, out, lse, do, causal=True,
                           sm_scale=scale)
    rtol, atol = TOL[torch.bfloat16]
    sums = {name: [torch.zeros(block(x, j).shape, device=cuda)
                   for j in range(n)]
            for name, x in (("dq", q), ("dk", k), ("dv", v))}
    mags = {name: [torch.zeros_like(t) for t in ts]
            for name, ts in sums.items()}
    for me in range(n):
        acc = torch.zeros(block(q, me).shape, device=cuda)
        state_lse = torch.full(acc.shape[:3], float("-inf"), device=cuda)
        di = (block(out, me).float() * block(do, me).float()).sum(-1)
        mag = torch.zeros_like(acc)
        for _, src, causal in _schedule(me, n, True):
            if causal is None:
                continue
            qm, ks, vs = block(q, me), block(k, src), block(v, src)
            _block_attention(qm, ks, vs, acc, state_lse, causal, scale)
            part, _ = flash_forward(qm, ks, vs, causal=causal,
                                    sm_scale=scale)
            mag += part.float().abs()
            parts = _block_backward(qm, ks, vs, block(out, me),
                                    block(lse, me), block(do, me), di,
                                    causal, scale)
            for name, index, p in zip(("dq", "dk", "dv"), (me, src, src),
                                      parts):
                sums[name][index] += p.float()
                mags[name][index] += p.float().abs()
        want = block(out, me).float()
        limit = atol + rtol * (want.abs() + mag)
        assert ((acc.bfloat16().float() - want).abs() <= limit).all()
        torch.testing.assert_close(state_lse, block(lse, me), rtol=0,
                                   atol=1e-4)
    for name, whole in zip(("dq", "dk", "dv"), grads):
        for j in range(n):
            want = block(whole, j).float()
            got = sums[name][j].bfloat16().float()
            limit = atol + rtol * (want.abs() + mags[name][j])
            assert ((got - want).abs() <= limit).all(), name


def int8_operands(cuda, m, k, n, dtype):
    """x, and a weight at the model's init scale quantized as
    ``quantize_params_int8`` does: (x, q int8, s f32) on the card."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.02
    s = torch.clamp_min(w.abs().amax(dim=0), 1e-8) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return x, q, s


@pytest.mark.parametrize("m,k,n,dtype", [
    (8, 2048, 2048, torch.bfloat16),    # decode at the bench shape
    (8, 2048, 8192, torch.bfloat16),
    (8, 8192, 2048, torch.bfloat16),
    (2, 2048, 2048, torch.bfloat16),    # the decode contract's batch
    (512, 2048, 2048, torch.bfloat16),  # prefill, 8 x 64
    (512, 2048, 8192, torch.bfloat16),
    (512, 8192, 2048, torch.bfloat16),
    (4, 2048, 1024, torch.bfloat16),    # tp = 2 shards, 4 rows a rank
    (4, 1024, 2048, torch.bfloat16),
    (3, 2000, 1000, torch.bfloat16),    # ragged: bytewise code loads
    (8, 2048, 2048, torch.float32),
    (64, 2048, 8192, torch.bfloat16),   # at the wgmma design's threshold
    (63, 2048, 8192, torch.bfloat16),   # just below it: mma.sync
    (129, 2048, 2048, torch.bfloat16),  # at it for N 2048
    (128, 2048, 2048, torch.bfloat16),  # just below it
    (64, 2048, 2048, torch.bfloat16),   # ragged prefill rows
    (100, 2048, 2048, torch.bfloat16),
    (500, 2048, 2048, torch.bfloat16),
    (512, 2048, 1000, torch.bfloat16),  # N that TMA cannot take
    (512, 2040, 2048, torch.bfloat16),  # wgmma, K % 64 != 0: TMA zero-fills
    (512, 2048, 1040, torch.bfloat16),  # wgmma, N % 128 != 0: the last
                                        # code box partial, columns masked
    (3, 200, 101, torch.bfloat16),      # odd N: bytewise code loads
    (3, 200, 101, torch.float32),
], ids=["decode_qkvo", "decode_gate_up", "decode_down", "contract_qkvo",
        "prefill_qkvo", "prefill_gate_up", "prefill_down", "tp2_column",
        "tp2_row", "ragged", "decode_f32", "threshold_m64",
        "below_threshold_m63", "threshold_m129", "below_threshold_m128",
        "prefill_m64", "prefill_m100", "prefill_m500",
        "prefill_unaligned_n", "prefill_k_ragged_tile",
        "prefill_n_ragged_tile", "odd_n", "odd_n_f32"])
def test_int8_matmul_matches_plain_version(cuda, m, k, n, dtype):
    """The kernel against ``(x @ q.to(x.dtype)) * s.to(x.dtype)`` on the
    same inputs; two launches bit-equal (split-K sums in a fixed order).
    Both sides round the f32 sum and then its product with the rounded
    scale, so the limit takes the dtype's rtol once for each rounding
    (``chip_smoke.int8_limit``)."""
    x, q, s = int8_operands(cuda, m, k, n, dtype)
    before = int8_matmul.launches
    got = int8_matmul(x, q, s)
    again = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = int8_matmul_reference(x, q, s)
    pre_scale = (x @ q.to(dtype)).float().abs() * s.to(dtype).float()
    rtol, atol = TOL[dtype]
    limit = atol + rtol * (want.float().abs() + pre_scale)
    assert ((got.float() - want.float()).abs() <= limit).all()


@pytest.mark.parametrize("m,k,n,dtype", [
    (8, 2048, 2048, torch.bfloat16),    # split-K with the in-kernel fixup
    (4, 2048, 1024, torch.bfloat16),    # 16 splits
    (8, 2048, 8192, torch.bfloat16),
    (8, 2048, 2048, torch.float32),
    (512, 2048, 2048, torch.bfloat16),  # the tensor cores
    (512, 2040, 1040, torch.bfloat16),  # their ragged K and N tiles
], ids=["decode_qkvo", "tp2_column", "decode_gate_up", "decode_f32",
        "prefill_qkvo", "prefill_ragged_tiles"])
def test_int8_matmul_graph_replay_equals_eager(cuda, m, k, n, dtype):
    """A launch captured in a CUDA graph and replayed (three times, so the
    split-K counters must be back at 0 after each) returns the eager
    launch's output bit for bit."""
    x, q, s = int8_operands(cuda, m, k, n, dtype)
    eager = int8_matmul(x, q, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        int8_matmul(x, q, s)  # the stream's first call is eager
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = int8_matmul(x, q, s)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(int8_matmul(x, q, s), eager)


#: (K, N) of the served DeepSeek-7B's decode products (the benchmark's
#: chat cell): q, k, v and o; gate and up; down; the head
CHAT_PRODUCTS = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 102400)]


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 32, 63])
@pytest.mark.parametrize("k,n", CHAT_PRODUCTS,
                         ids=["qkvo", "gate_up", "down", "head"])
def test_int8_matmul_stream_k_at_the_chat_products(cuda, m, k, n):
    """The stream-K design at the chat cell's products and rows around
    its 16 (each row tile of 8, 16 and 32, and two of 32): within the
    plain version's limit, two launches bit-equal, a graph's replays
    bit-equal to the eager launch (the cut tiles' counters back at 0
    after each), and every launch counted under its design."""
    x, q, s = int8_operands(cuda, m, k, n, torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert imod.plan(m, k, n, torch.bfloat16, sms).design == "stream_k"
    before = int8_matmul.launches_by_design.get("stream_k", 0)
    got = int8_matmul(x, q, s)
    again = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches_by_design["stream_k"] == before + 2
    assert torch.equal(got, again)
    want = int8_matmul_reference(x, q, s)
    pre_scale = (x @ q.to(torch.bfloat16)).float().abs() \
        * s.to(torch.bfloat16).float()
    rtol, atol = TOL[torch.bfloat16]
    limit = atol + rtol * (want.float().abs() + pre_scale)
    assert ((got.float() - want.float()).abs() <= limit).all()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        int8_matmul(x, q, s)  # the stream's first call is eager
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = int8_matmul(x, q, s)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)
    assert all(int(c.abs().sum()) == 0 for c in imod._counters.values())


@pytest.mark.parametrize("m,k,n", [
    (m, k, n) for m in (1024, 4096) for k, n in CHAT_PRODUCTS] + [
    (100, 4096, 4096),     # ragged M: a partial row tile
    (1000, 4096, 4096),
    (1000, 4040, 4112),    # ragged K (a partial stage) and N (a partial
    (4096, 4040, 11024)],  # code box and output box)
    ids=[f"m{m}_{name}" for m in (1024, 4096)
         for name in ("qkvo", "gate_up", "down", "head")]
    + ["m100", "m1000", "m1000_ragged_k_n", "m4096_ragged_k_n"])
def test_int8_matmul_wgmma_at_the_chat_prefill(cuda, m, k, n):
    """The wgmma design at the chat cell's prefill products (16 rows of
    64 and of 256 tokens) and at ragged rows, K and N: within the plain
    version's limit (one bf16 ulp for each of its two roundings), two
    launches bit-equal, a graph's replays bit-equal to the eager launch,
    and every launch counted under its design."""
    x, q, s = int8_operands(cuda, m, k, n, torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = imod.plan(m, k, n, torch.bfloat16, sms)
    assert p.design == "wgmma"
    before = int8_matmul.launches_by_design.get("wgmma", 0)
    got = int8_matmul(x, q, s)
    again = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches_by_design["wgmma"] == before + 2
    assert torch.equal(got, again)
    want = int8_matmul_reference(x, q, s)
    pre_scale = (x @ q.to(torch.bfloat16)).float().abs() \
        * s.to(torch.bfloat16).float()
    rtol, atol = TOL[torch.bfloat16]
    limit = atol + rtol * (want.float().abs() + pre_scale)
    assert ((got.float() - want.float()).abs() <= limit).all()
    del want, pre_scale, limit
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        int8_matmul(x, q, s)  # the stream's first call is eager
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = int8_matmul(x, q, s)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


def test_int8_matmul_unaligned_views_take_the_cp_async_design(cuda):
    """TMA takes 16-byte aligned bases: codes viewed from an odd offset
    run the cp.async design of the same shape, within the limit."""
    x, q, s = int8_operands(cuda, 16, 4097, 4096, torch.bfloat16)
    x = x[:, :4096].contiguous()
    q_view = torch.as_strided(q.view(-1)[1:], (4096, 4096), (4096, 1))
    assert q_view.data_ptr() % 16 and q_view.is_contiguous()
    before = int8_matmul.launches_by_design.get("mma_sync", 0)
    got = int8_matmul(x, q_view, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches_by_design["mma_sync"] == before + 1
    want = int8_matmul_reference(x, q_view, s)
    pre_scale = (x @ q_view.to(torch.bfloat16)).float().abs() \
        * s.to(torch.bfloat16).float()
    rtol, atol = TOL[torch.bfloat16]
    limit = atol + rtol * (want.float().abs() + pre_scale)
    assert ((got.float() - want.float()).abs() <= limit).all()


#: (B, T, n_heads, n_kv_heads, S, start_pos, head_dim, q dtype, cache
#: dtype) of the decode kernels: chip_smoke.py phase 3e's dtype pairs and
#: shapes at B 2: decode at the last and a middle position, a prefill
#: block, the tp shard, GQA in f32, bf16 q over an f32 cache, head_dims
#: 64, 16 and 8, a ragged S; and an int8 cache under f32 q
DECODE_CASES = [
    (2, 1, 16, 16, 1024, 1023, 128, torch.bfloat16, torch.bfloat16),
    (2, 1, 16, 16, 1024, 1023, 128, torch.bfloat16, torch.int8),
    (2, 1, 16, 16, 1024, 544, 128, torch.bfloat16, torch.bfloat16),
    (2, 1, 16, 16, 1024, 544, 128, torch.bfloat16, torch.int8),
    (2, 64, 16, 16, 1024, 0, 128, torch.bfloat16, torch.bfloat16),
    (2, 64, 16, 16, 1024, 0, 128, torch.bfloat16, torch.int8),
    (2, 1, 8, 8, 1024, 1023, 128, torch.bfloat16, torch.int8),
    (2, 1, 16, 4, 1000, 999, 128, torch.float32, torch.float32),
    (2, 1, 16, 16, 1024, 1023, 128, torch.bfloat16, torch.float32),
    (2, 1, 16, 16, 1024, 1023, 64, torch.bfloat16, torch.bfloat16),
    (2, 1, 16, 16, 1024, 1023, 16, torch.bfloat16, torch.int8),
    (2, 1, 16, 16, 1024, 1023, 8, torch.bfloat16, torch.bfloat16),
    (2, 1, 16, 16, 1024, 1023, 8, torch.bfloat16, torch.int8),
    (2, 1, 16, 16, 997, 996, 128, torch.bfloat16, torch.bfloat16),
    (2, 3, 16, 4, 997, 500, 128, torch.float32, torch.int8),
]
DECODE_IDS = ["decode_bf16", "decode_int8", "mid_bf16", "mid_int8",
              "prefill_bf16", "prefill_int8", "tp2_int8", "gqa_f32",
              "bf16_q_f32_cache", "d64_bf16", "d16_int8", "d8_bf16",
              "d8_int8", "ragged_bf16", "f32_q_int8_gqa"]


def decode_operands(cuda, batch, t_new, heads, kv_heads, seq, dim, q_dtype,
                    cache, seed=6):
    """q and one layer's full cache on the card (int8: the codes and
    scales of normal values, as the cache write makes them)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    q = randn(batch, t_new, heads, dim).to(q_dtype)
    k, v = (randn(batch, seq, kv_heads, dim) for _ in range(2))
    if cache == torch.int8:
        (kq, ks), (vq, vs) = (kmod._quantize_kv_block(x) for x in (k, v))
        return q, {"k": kq, "k_s": ks, "v": vq, "v_s": vs}
    return q, {"k": k.to(cache), "v": v.to(cache)}


@pytest.mark.parametrize("batch,t_new,heads,kv_heads,seq,start,dim,q_dtype,"
                         "cache", DECODE_CASES, ids=DECODE_IDS)
def test_decode_attention_matches_plain_version(cuda, batch, t_new, heads,
                                                kv_heads, seq, start, dim,
                                                q_dtype, cache):
    """The kernel against the plain version computed in float32 from the
    same inputs, within the output dtype's tolerance (one rounding to
    bf16, or float32 sums in another order); the plain version's dtype;
    two launches bit-equal (no atomics); an int and a device position the
    same bits."""
    q, entry = decode_operands(cuda, batch, t_new, heads, kv_heads, seq,
                               dim, q_dtype, cache)
    pos = torch.tensor(start, device=cuda)
    before = decode_attention.launches
    got = decode_attention(q, entry, pos)
    again = decode_attention(q, entry, start)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(got, again)
    assert counters_at_zero()
    assert got.dtype == decode_attention_reference(q, entry, pos).dtype
    want = decode_attention_reference(
        q.float(), {n: t if t.dtype == torch.int8 else t.float()
                    for n, t in entry.items()}, pos)
    rtol, atol = TOL[got.dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("batch,t_new,heads,kv_heads,seq,start,dim,q_dtype,"
                         "cache", DECODE_CASES, ids=DECODE_IDS)
def test_kv_append_bit_equal_to_plain_version(cuda, batch, t_new, heads,
                                              kv_heads, seq, start, dim,
                                              q_dtype, cache):
    """The cache write against the plain version on the same cache: every
    leaf bit-equal (codes, scales, float rows), the rows outside [start,
    start + T) untouched."""
    _, base = decode_operands(cuda, batch, 1, heads, kv_heads, seq, dim,
                              q_dtype, cache)
    gen = torch.Generator(device=cuda).manual_seed(7)
    k, v = (torch.randn((batch, t_new, kv_heads, dim), generator=gen,
                        device=cuda).to(q_dtype) for _ in range(2))
    got = {n: t.clone() for n, t in base.items()}
    want = {n: t.clone() for n, t in base.items()}
    pos = torch.tensor(start, device=cuda)
    before = kv_append.launches
    assert kv_append(got, k, v, pos) is got
    kv_append_reference(want, k, v, pos)
    torch.cuda.synchronize()
    assert kv_append.launches == before + 1
    for name in got:
        assert torch.equal(got[name], want[name]), name
        assert torch.equal(got[name][:, :start], base[name][:, :start])
        assert torch.equal(got[name][:, start + t_new:],
                           base[name][:, start + t_new:])


#: rope_kv_append's cases: chip_smoke.py phase 3e's rows, then element
#: loads (head_dim 10: an odd half), f32 q and k into an int8 cache
#: with GQA and T 3, and bf16 into an f32 cache at a prefill block
ROPE_CASES = [shape[1:] for shape in chip_smoke.DECODE_SHAPES] + [
    (2, 1, 8, 2, 64, 63, 10, torch.bfloat16, torch.int8),
    (2, 3, 16, 4, 997, 500, 128, torch.float32, torch.int8),
    (2, 64, 16, 16, 1024, 0, 64, torch.bfloat16, torch.float32),
]
ROPE_IDS = [f"{shape[0]}_{chip_smoke.dtype_name(shape[-1])}"
            for shape in chip_smoke.DECODE_SHAPES] + [
    "d10_element_loads_int8", "f32_gqa_t3_int8", "prefill_bf16_f32_cache"]


def rope_operands(cuda, batch, t_new, heads, kv_heads, dim, dtype, seed=10):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn((batch, t_new, h, dim), generator=gen,
                             device=cuda).to(dtype)
                 for h in (heads, kv_heads, kv_heads))


@pytest.mark.parametrize("batch,t_new,heads,kv_heads,seq,start,dim,q_dtype,"
                         "cache", ROPE_CASES, ids=ROPE_IDS)
def test_rope_kv_append_bit_equal_to_plain_version(cuda, batch, t_new, heads,
                                                   kv_heads, seq, start, dim,
                                                   q_dtype, cache):
    """The rotation and cache write against the plain version (``_rope``
    of q and k, then the write) on the same cache: the rotated q and
    every leaf bit-equal (codes, scales, float rows), the rows outside
    [start, start + T) untouched, one launch counted; an int position
    gives the same bits as a device one."""
    _, base = decode_operands(cuda, batch, 1, heads, kv_heads, seq, dim,
                              q_dtype, cache)
    q, k, v = rope_operands(cuda, batch, t_new, heads, kv_heads, dim,
                            q_dtype)
    got, at_int, want = ({n: t.clone() for n, t in base.items()}
                         for _ in range(3))
    pos = torch.tensor(start, device=cuda)
    before = rope_kv_append.launches
    q_got = rope_kv_append(got, q, k, v, pos, 10000.0)
    q_int = rope_kv_append(at_int, q, k, v, start, 10000.0)
    q_want = rope_kv_append_reference(want, q, k, v, pos, 10000.0)
    torch.cuda.synchronize()
    assert rope_kv_append.launches == before + 2
    assert q_got.dtype == q.dtype and q_got.shape == q.shape
    assert torch.equal(q_got, q_want)
    assert torch.equal(q_int, q_want)
    for name in got:
        assert torch.equal(got[name], want[name]), name
        assert torch.equal(at_int[name], want[name]), name
        assert torch.equal(got[name][:, :start], base[name][:, :start])
        assert torch.equal(got[name][:, start + t_new:],
                           base[name][:, start + t_new:])


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_rope_kv_append_graph_replay_across_positions(cuda, cache):
    """rope_kv_append captured in a CUDA graph with the position on the
    device, as the decode step is, then replayed at later positions: the
    rotated q of each replay and the cache after all of them equal eager
    launches at the same positions bit for bit."""
    batch, heads, kv_heads, seq, dim = 4, 16, 4, 256, 128
    _, entry = decode_operands(cuda, batch, 1, heads, kv_heads, seq, dim,
                               torch.bfloat16, cache)
    q, k, v = rope_operands(cuda, batch, 1, heads, kv_heads, dim,
                            torch.bfloat16)
    positions = [3, 4, 5, 100, 200, 255]
    eager_cache = {n: t.clone() for n, t in entry.items()}
    eager = [rope_kv_append(eager_cache, q, k, v, start, 10000.0)
             for start in positions]
    pos = torch.tensor(positions[0], device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = rope_kv_append(entry, q, k, v, pos, 10000.0)  # eager
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = rope_kv_append(entry, q, k, v, pos, 10000.0)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(first, eager[0])
    for start, want in zip(positions[1:], eager[1:]):
        pos.fill_(start)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), start
    for name in entry:
        assert torch.equal(entry[name], eager_cache[name]), name


def test_rope_kv_append_capture_needs_an_eager_call_first(cuda):
    """The frequencies are made by an eager call and kept (a replayed
    graph reads them in place): a capture before any eager call at that
    (theta, head_dim) raises, and one after it succeeds."""
    _, entry = decode_operands(cuda, 2, 1, 4, 2, 16, 64, torch.bfloat16,
                               torch.int8)
    q, k, v = rope_operands(cuda, 2, 1, 4, 2, 64, torch.bfloat16)
    theta = 12345.0
    assert not any(key[0] == theta for key in kmod._freqs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="eager call"):
            with torch.cuda.graph(graph, stream=side):
                rope_kv_append(entry, q, k, v, 3, theta)
        want = rope_kv_append(entry, q, k, v, 3, theta)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = rope_kv_append(entry, q, k, v, 3, theta)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_rope_kv_append_skips_rows_past_the_cache(cuda):
    """A device position whose block runs past the cache: the rows inside
    it are written as the plain version writes them, those past it
    nowhere, and the rotated q is returned for every row."""
    batch, t_new, heads, kv_heads, seq, dim = 2, 4, 8, 2, 16, 64
    _, base = decode_operands(cuda, batch, 1, heads, kv_heads, seq, dim,
                              torch.bfloat16, torch.int8)
    q, k, v = rope_operands(cuda, batch, t_new, heads, kv_heads, dim,
                            torch.bfloat16)
    got, want = ({n: t.clone() for n, t in base.items()} for _ in range(2))
    q_got = rope_kv_append(got, q, k, v, torch.tensor(14, device=cuda),
                           10000.0)
    rope_kv_append_reference(want, q[:, :2].contiguous(), k[:, :2]
                             .contiguous(), v[:, :2].contiguous(), 14,
                             10000.0)
    positions = torch.arange(t_new, device=cuda) + 14
    torch.cuda.synchronize()
    assert torch.equal(q_got, _rope(q, 10000.0, positions))
    for name in got:
        assert torch.equal(got[name], want[name]), name


def counters_at_zero() -> bool:
    """Whether every stream's split-combine ticket counters are 0."""
    return all(not c.any() for c in dmod._counters.values())


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_decode_attention_graph_replay_equals_eager(cuda, cache):
    """Both kernels captured in a CUDA graph with the position on the
    device, as the decode step is, then replayed at later positions that
    cross a key tile's edge (64: a second split takes keys) and the edge
    where the splits' runs grow from one tile to two (64 x splits): the
    cache and the attention equal eager launches at the same positions
    bit for bit, and every launch leaves the split counters at 0."""
    batch, heads, seq, dim = 4, 16, 1024, 64
    p = dmod.plan(batch, 1, heads, heads, seq, dim, torch.bfloat16, cache)
    assert p.splits > 1 and p.key_tile == 64
    edge = p.splits * p.key_tile
    assert dmod.split_ranges(p, edge + 1)[0] == (0, 2 * p.key_tile)
    positions = [60, *range(61, 67), *range(edge - 2, edge + 3)]
    q, entry = decode_operands(cuda, batch, 1, heads, heads, seq, dim,
                               torch.bfloat16, cache)
    gen = torch.Generator(device=cuda).manual_seed(8)
    ks, vs = (torch.randn((batch, 1, heads, dim), generator=gen,
                          device=cuda).bfloat16() for _ in range(2))
    eager_cache = {n: t.clone() for n, t in entry.items()}
    eager = []
    for start in positions:
        kv_append(eager_cache, ks, vs, start)
        eager.append(decode_attention(q, eager_cache, start))
    torch.cuda.synchronize()
    assert counters_at_zero()
    pos = torch.tensor(positions[0], device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kv_append(entry, ks, vs, pos)  # the stream's first call is eager
        first = decode_attention(q, entry, pos)
        pos += 1
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            kv_append(entry, ks, vs, pos)
            out = decode_attention(q, entry, pos)
            pos += 1
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(first, eager[0])
    for start, want in zip(positions[1:], eager[1:]):
        pos.fill_(start)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), start
        assert counters_at_zero(), start
    for name in entry:
        assert torch.equal(entry[name], eager_cache[name]), name


@pytest.mark.parametrize("batch,t_new,heads,kv_heads,seq,start,dim,q_dtype,"
                         "cache", DECODE_CASES, ids=DECODE_IDS)
def test_decode_attention_reads_nothing_past_the_position(
        cuda, batch, t_new, heads, kv_heads, seq, start, dim, q_dtype,
        cache):
    """NaN planted in the cache past the step's last key (in the scales
    of an int8 cache) leaves the output bit-equal: the kernel stops at
    the last visible key and skips the splits past it."""
    q, entry = decode_operands(cuda, batch, t_new, heads, kv_heads, seq,
                               dim, q_dtype, cache)
    want = decode_attention(q, entry, start)
    for name in ("k_s", "v_s") if cache == torch.int8 else ("k", "v"):
        entry[name][:, start + t_new:] = float("nan")
    got = decode_attention(q, entry, torch.tensor(start, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert counters_at_zero()


def test_int8_recipe_on_the_card_equals_the_cpu(cuda):
    """``_sym_int8`` (the cache write's plain version and the weight
    quantizer) gives the CPU's codes and scales bit for bit on the card:
    both divide IEEE, as the JAX package does (a Python-number divisor
    would take its reciprocal on CUDA)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((4096, 128), generator=gen, device=cuda) * 3
    for axis in (0, -1):
        codes, scales = kmod._sym_int8(x, axis)
        want_codes, want_scales = kmod._sym_int8(x.cpu(), axis)
        assert torch.equal(codes.cpu(), want_codes)
        assert torch.equal(scales.cpu(), want_scales)


#: the norm's cases: chip_smoke.py phase 3f's rows (rows, dim, dtype),
#: each with and without the residual add, and a mix of dtypes (bf16 h
#: under an f32 delta, as a bf16 model over an f32 cache gives)
NORM_CASES = [(rows, dim, dtype, add)
              for _, rows, dim, dtype, _ in chip_smoke.NORM_SHAPES
              for add in (True, False)]
NORM_IDS = [f"{label}_{'add' if add else 'no_add'}"
            for label, *_ in chip_smoke.NORM_SHAPES
            for add in (True, False)]


def norm_operands(cuda, rows, dim, dtype, seed=20):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h, d, dy, ds = (torch.randn((rows, dim), generator=gen, device=cuda)
                    .to(dtype) for _ in range(4))
    w = (1 + 0.1 * torch.randn((dim,), generator=gen, device=cuda)).to(dtype)
    return h, d, w, dy, ds


def norm_limit(ref_s, ref_y, w, rstd):
    """KERNEL_TOL taken once for each of the norm's two roundings (the
    variance sums in another order, so s * rstd may round one ulp apart
    before the weight multiply)."""
    rtol, atol = TOL[ref_y.dtype]
    pre = (ref_s * rstd[..., None]).to(ref_s.dtype).float().abs() \
        * w.float().abs()
    return atol + rtol * (ref_y.float().abs() + pre)


@pytest.mark.parametrize("rows,dim,dtype,add", NORM_CASES, ids=NORM_IDS)
def test_rms_norm_matches_plain_version(cuda, rows, dim, dtype, add):
    """The forward kernel against the plain version: the sum bit-equal,
    the norm within the limit of its two roundings, rstd within 1e-6; two
    launches and a graph replay bit-equal; one CUDA launch a call."""
    h, d, w, _, _ = norm_operands(cuda, rows, dim, dtype)
    d = d if add else None
    before = rmod.add_rms_norm.launches

    def call():
        return rmod._launch_forward(h, d, w, rmod.EPS, True)

    s, y, rstd = call()
    again = call()
    torch.cuda.synchronize()
    assert rmod.add_rms_norm.launches == before + 2
    ref_s, ref_y = rmod.add_rms_norm_reference(h, d, w)
    _, ref_rstd = rmod._rms_parts(ref_s, w, rmod.EPS)
    if add:
        assert torch.equal(s, ref_s)
    assert y.dtype == ref_y.dtype
    err = (y.float() - ref_y.float()).abs()
    assert (err <= norm_limit(ref_s, ref_y, w, ref_rstd)).all()
    assert ((rstd - ref_rstd).abs() <= 1e-6 * ref_rstd).all()
    for a, b in zip((s, y, rstd), again):
        assert a is None or torch.equal(a, b)
    outputs = chip_smoke.flat_bytes(s, y, rstd)
    assert chip_smoke.graph_replay_equal(
        lambda: chip_smoke.flat_bytes(*call()), outputs)
    assert chip_smoke.cuda_launches(call) == 1


def test_rms_norm_promotes_mixed_dtypes_as_the_plain_version(cuda):
    """bf16 h under an f32 delta and a bf16 weight (the decode step of a
    bf16 model over an f32 cache): the sum and the norm in f32, the sum
    bit-equal to ``h + delta``, the norm within f32's limit."""
    h, _, w, _, _ = norm_operands(cuda, 8, 256, torch.bfloat16)
    d = torch.randn(8, 256, device=cuda)
    s, y = rmod.add_rms_norm(h, d, w)
    ref_s, ref_y = rmod.add_rms_norm_reference(h, d, w)
    assert s.dtype == y.dtype == torch.float32
    assert torch.equal(s, ref_s)
    _, rstd = rmod._rms_parts(ref_s, w, rmod.EPS)
    assert ((y - ref_y).abs() <= norm_limit(ref_s, ref_y, w, rstd)).all()


@pytest.mark.parametrize("rows,dim,dtype,fused", NORM_CASES, ids=NORM_IDS)
def test_rms_norm_bwd_matches_plain_formula(cuda, rows, dim, dtype, fused):
    """The backward kernel against its plain formula within the dtype's
    tolerance (the row sums and dw's sum over the rows in another order),
    ds added into dx; two launches and a graph replay bit-equal (dw's
    partials combined in a fixed order by the last blocks to draw their
    tickets, no atomics), the ticket counters back at 0; one CUDA launch
    a call."""
    _, _, w, dy, ds = norm_operands(cuda, rows, dim, dtype)
    x = norm_operands(cuda, rows, dim, dtype, seed=21)[0]
    ds = ds if fused else None
    _, rstd = rmod._rms_parts(x, w, rmod.EPS)
    before = rmod.rms_norm_bwd.launches

    def call():
        return rmod.rms_norm_bwd(dy, x, w, rstd, ds)

    dx, dw = call()
    again = call()
    torch.cuda.synchronize()
    assert rmod.rms_norm_bwd.launches == before + 2
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    assert all(not c.any() for c in rmod._counters.values())
    ref_dx, ref_dw = rmod.rms_norm_backward_reference(dy, x, w, rstd, ds)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(dx.float(), ref_dx.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(dw.float(), ref_dw.float(), rtol=rtol,
                               atol=atol)
    assert chip_smoke.graph_replay_equal(
        lambda: chip_smoke.flat_bytes(*call()),
        chip_smoke.flat_bytes(dx, dw))
    assert chip_smoke.cuda_launches(call) == 1


def test_rms_norm_bwd_dw_deterministic_at_the_train_shape(cuda):
    """dw sums 16,384 rows over the blocks' partials and the two-level
    combine: five launches, each on a fresh workspace, give the same
    bits."""
    _, _, w, dy, ds = norm_operands(cuda, chip_smoke.TRAIN_ROWS, 2048,
                                    torch.bfloat16)
    x = norm_operands(cuda, chip_smoke.TRAIN_ROWS, 2048, torch.bfloat16,
                      seed=22)[0]
    _, rstd = rmod._rms_parts(x, w, rmod.EPS)
    first = rmod.rms_norm_bwd(dy, x, w, rstd, ds)
    for _ in range(4):
        dx, dw = rmod.rms_norm_bwd(dy, x, w, rstd, ds)
        assert torch.equal(dx, first[0]) and torch.equal(dw, first[1])


@pytest.mark.parametrize("case", ["f32_x_bf16_w", "width_1001"])
def test_rms_norm_bwd_mixed_dtypes_and_odd_widths(cuda, case):
    """One backward on an f32 x (and dy, ds) under a bf16 weight (the
    instance that holds float32 vectors at 8 a load, dw rounded to bf16),
    and one at a width that is not a multiple of 8 (element loads, four
    vectors a thread): within the dtype's tolerance of the plain formula,
    two launches bit-equal, the counters back at 0."""
    if case == "f32_x_bf16_w":
        _, _, _, dy, ds = norm_operands(cuda, 300, 2048, torch.float32)
        x = norm_operands(cuda, 300, 2048, torch.float32, seed=23)[0]
        w = norm_operands(cuda, 300, 2048, torch.bfloat16, seed=24)[2]
    else:
        _, _, w, dy, ds = norm_operands(cuda, 300, 1001, torch.bfloat16)
        x = norm_operands(cuda, 300, 1001, torch.bfloat16, seed=23)[0]
    _, rstd = rmod._rms_parts(x, w, rmod.EPS)
    dx, dw = rmod.rms_norm_bwd(dy, x, w, rstd, ds)
    again = rmod.rms_norm_bwd(dy, x, w, rstd, ds)
    torch.cuda.synchronize()
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    assert all(not c.any() for c in rmod._counters.values())
    ref_dx, ref_dw = rmod.rms_norm_backward_reference(dy, x, w, rstd, ds)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    rtol, atol = TOL[x.dtype]
    torch.testing.assert_close(dx.float(), ref_dx.float(), rtol=rtol,
                               atol=atol)
    rtol, atol = TOL[w.dtype]
    torch.testing.assert_close(dw.float(), ref_dw.float(), rtol=rtol,
                               atol=atol)


def test_rms_norm_without_the_add_deterministic_at_the_train_shape(cuda):
    """The norm alone at the train shape (its rows a block, the grid
    striding over them, rstd written): two launches give the same bits."""
    h, _, w, _, _ = norm_operands(cuda, chip_smoke.TRAIN_ROWS, 2048,
                                  torch.bfloat16)
    _, y, rstd = rmod._launch_forward(h, None, w, rmod.EPS, True)
    _, y2, rstd2 = rmod._launch_forward(h, None, w, rmod.EPS, True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(rstd, rstd2)


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "graph"])
def test_dependent_launches_wait_for_the_product_before_them(cuda, captured):
    """The norm (with the add, and alone) and then the gate, each launched
    with programmatic dependent launch right after the ``torch.matmul``
    whose output it reads, as on the decode step, eagerly or replayed
    from a captured graph: the same bits as each launched after a
    ``torch.cuda.synchronize()``, so that the kernels' wait guards every
    read of the product."""
    gen = torch.Generator(device=cuda).manual_seed(25)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)) \
            .to(torch.bfloat16)

    m, h, g = randn(8, 2048), randn(8, 2048), randn(8, 8192)
    w = (1 + 0.1 * torch.randn(2048, generator=gen, device=cuda)) \
        .to(torch.bfloat16)
    wo, wu = randn(2048, 2048, scale=2048 ** -0.5), \
        randn(2048, 8192, scale=2048 ** -0.5)

    def chain(sync):
        def product(a, b):
            out = a @ b
            if sync:
                torch.cuda.synchronize()
            return out

        s, y = rmod.add_rms_norm(h, product(m, wo), w)
        _, alone = rmod.add_rms_norm(product(m, wo), None, w)
        return s, y, alone, smod.swiglu(g, product(y, wu))

    want = chain(sync=True)
    before = (rmod.add_rms_norm.launches, smod.swiglu.launches)
    if captured:
        assert chip_smoke.graph_replay_equal(
            lambda: chip_smoke.flat_bytes(*chain(sync=False)),
            chip_smoke.flat_bytes(*want))
    else:
        for got, ref in zip(chain(sync=False), want):
            assert torch.equal(got, ref)
    assert rmod.add_rms_norm.launches > before[0]
    assert smod.swiglu.launches > before[1]


#: the gate's cases: chip_smoke.py phase 3f's rows (rows, d_ff, dtype),
#: then a ragged count (a scalar tail after the vectors)
GATE_CASES = [(rows, dim, dtype)
              for _, rows, dim, dtype, _ in chip_smoke.GATE_SHAPES] + [
    (3, 1001, torch.bfloat16)]
GATE_IDS = [label for label, *_ in chip_smoke.GATE_SHAPES] + ["ragged"]


@pytest.mark.parametrize("rows,dim,dtype", GATE_CASES, ids=GATE_IDS)
def test_swiglu_matches_plain_version(cuda, rows, dim, dtype):
    """The gate and its backward against ``F.silu(g) * u`` and the plain
    backward formula: bit-equal where the card's expf is PyTorch's (the
    ulps are reported otherwise, held to the dtype's tolerance); two
    launches and a graph replay bit-equal; one CUDA launch a call each."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    dy, g, u = ((2 * torch.randn((rows, dim), generator=gen, device=cuda))
                .to(dtype) for _ in range(3))
    before = (smod.swiglu.launches, smod.swiglu_bwd.launches)
    y = smod.swiglu(g, u)
    dg, du = smod.swiglu_bwd(dy, g, u)
    torch.cuda.synchronize()
    assert (smod.swiglu.launches, smod.swiglu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    rtol, atol = TOL[dtype]
    for got, want in ((y, smod.swiglu_reference(g, u)),
                      *zip((dg, du), smod.swiglu_backward_reference(
                          dy, g, u))):
        if not torch.equal(got, want):
            print(f"ulps off the plain version: "
                  f"{chip_smoke.max_ulp(got, want)}")
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
    assert torch.equal(smod.swiglu(g, u), y)
    assert all(torch.equal(a, b)
               for a, b in zip(smod.swiglu_bwd(dy, g, u), (dg, du)))
    assert chip_smoke.graph_replay_equal(lambda: smod.swiglu(g, u), y)
    assert chip_smoke.graph_replay_equal(
        lambda: chip_smoke.flat_bytes(*smod.swiglu_bwd(dy, g, u)),
        chip_smoke.flat_bytes(dg, du))
    assert chip_smoke.cuda_launches(lambda: smod.swiglu(g, u)) == 1
    assert chip_smoke.cuda_launches(lambda: smod.swiglu_bwd(dy, g, u)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_and_gate_gradients_on_the_card(cuda, dtype):
    """A block of both Functions on the card: its gradients against the
    same block on the CPU (the plain forwards and backward formulas)
    within the dtype's tolerance, and under ``checkpoint`` bit-equal to
    those without it; each backward kernel once, each forward once (twice
    under checkpoint)."""
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator().manual_seed(24)
    leaves = [torch.randn(4, 16, 256, generator=gen).to(dtype),
              torch.randn(4, 16, 256, generator=gen).to(dtype),
              (1 + 0.1 * torch.randn(256, generator=gen)).to(dtype),
              (0.06 * torch.randn(256, 512, generator=gen)).to(dtype),
              (0.06 * torch.randn(256, 512, generator=gen)).to(dtype),
              (0.04 * torch.randn(512, 256, generator=gen)).to(dtype)]

    def block(h, d, w, wg, wu, wd):
        s, m = rmod.add_rms_norm(h, d, w)
        return s + smod.swiglu(m @ wg, m @ wu) @ wd

    def grads(device, remat):
        inputs = [t.to(device).requires_grad_() for t in leaves]
        out = checkpoint(block, *inputs, use_reentrant=False) if remat \
            else block(*inputs)
        return torch.autograd.grad(out.float().square().sum(), inputs)

    before = {n: WRAPPERS[n].launches for n in chip_smoke.BLOCK_KERNELS}
    plain = grads(cuda, False)
    after = {n: WRAPPERS[n].launches - before[n]
             for n in chip_smoke.BLOCK_KERNELS}
    assert after == dict.fromkeys(chip_smoke.BLOCK_KERNELS, 1)
    remat = grads(cuda, True)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    rtol, atol = TOL[dtype]
    for got, want in zip(plain, grads("cpu", False)):
        scale = want.float().abs().max().item()
        err = (got.float().cpu() - want.float()).abs().max().item()
        # products of the block in another order on the card: held as a
        # share of the leaf's scale
        assert err <= (8 * rtol if dtype == torch.bfloat16 else 1e-4) \
            * scale, (err, scale)


def test_decode_step_launches_the_norm_and_the_gate(cuda):
    """One ``forward_with_cache`` call on the card launches the norm 2L +
    1 times and the gate L times, their backward kernels never."""
    params = tllama.init_llama_params(DECODE_CFG, param_dtype=torch.bfloat16,
                                      seed=1, device=cuda)
    cache = tdecode.init_kv_cache(DECODE_CFG, 2, 16, torch.bfloat16,
                                  device=cuda)
    before = {n: WRAPPERS[n].launches for n in chip_smoke.BLOCK_KERNELS}
    with torch.no_grad():
        tdecode.forward_with_cache(params, torch.zeros(2, 3, dtype=torch.long,
                                                       device=cuda),
                                   cache, 0, DECODE_CFG)
    n = DECODE_CFG.n_layers
    assert {k: WRAPPERS[k].launches - v for k, v in before.items()} == {
        "rms_norm": 2 * n + 1, "swiglu": n, "rms_norm_bwd": 0,
        "swiglu_bwd": 0}


@pytest.mark.parametrize("module", ["decode_attention", "kv_append",
                                    "rope_kv_append", "int8_matmul",
                                    "rms_norm", "rms_norm_bwd", "swiglu",
                                    "swiglu_bwd", "rope", "rope_bwd",
                                    "adamw", "cross_entropy",
                                    "global_norm", "token_pick"])
def test_kernel_build_failure_raises(cuda, monkeypatch, module):
    """A kernel whose build fails raises on CUDA tensors: the wrapper
    never returns its plain version's result instead."""
    def broken():
        raise RuntimeError("nvcc failed (test)")

    mod = {"decode_attention": dmod, "kv_append": kmod,
           "rope_kv_append": kmod, "int8_matmul": imod, "rms_norm": rmod,
           "rms_norm_bwd": rmod, "swiglu": smod, "swiglu_bwd": smod,
           "rope": ropemod, "rope_bwd": ropemod, "adamw": amod,
           "cross_entropy": lossmod, "global_norm": nmod,
           "token_pick": pmod}[module]
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_library", broken)
    q, entry = decode_operands(cuda, 2, 1, 4, 2, 16, 8, torch.bfloat16,
                               torch.int8)
    x = q.reshape(2, 32)
    weight = torch.ones(32, device=cuda, dtype=torch.bfloat16)
    wrappers = (decode_attention, kv_append, rope_kv_append,
                imod.int8_matmul, *WRAPPERS.values())
    before = {w.__name__: w.launches for w in wrappers}
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if module == "rms_norm":
            rmod.add_rms_norm(x, x, weight)
        elif module == "rms_norm_bwd":
            rmod.rms_norm_bwd(x, x, weight, torch.ones(2, device=cuda))
        elif module == "swiglu":
            smod.swiglu(x, x)
        elif module == "swiglu_bwd":
            smod.swiglu_bwd(x, x, x)
        elif module == "rope":
            ropemod.rope_qk(q, q, 10000.0)
        elif module == "rope_bwd":
            ropemod.rope_bwd(q, q, 10000.0)
        elif module == "adamw":
            amod.adamw_update([x], {"count": torch.zeros(
                (), dtype=torch.int32, device=cuda), "mu": [x], "nu": [x]},
                [x], lr=1e-3, weight_decay=1e-4)
        elif module == "cross_entropy":
            lossmod.cross_entropy(x.reshape(2, 1, 32), torch.zeros(
                (2, 1), dtype=torch.int64, device=cuda))
        elif module == "global_norm":
            nmod.sum_of_squares([x], norm=True)
        elif module == "token_pick":
            pmod.pick(x, None, 0.0)
        elif module == "decode_attention":
            decode_attention(q, entry, 3)
        elif module == "kv_append":
            kv_append(entry, q[:, :, :2].contiguous(),
                      q[:, :, :2].contiguous(), 3)
        elif module == "rope_kv_append":
            rope_kv_append(entry, q, q[:, :, :2].contiguous(),
                           q[:, :, :2].contiguous(), 3, 10000.0)
        else:
            imod.int8_matmul(q.reshape(2, 32), entry["k"].reshape(32, -1)
                             .contiguous(), torch.ones(
                                 entry["k"].numel() // 32, device=cuda))
    assert before == {w.__name__: w.launches for w in wrappers}


def same_bits(got, want) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                               b.reshape(-1).contiguous().view(torch.uint8))
               for a, b in zip(got, want))


#: (B, S, H, H_kv, D, dtype, head_major, first position): the flash
#: path's layout with v, the input layout at an offset (the ring's), f32,
#: and head_dim 18 (one pair a thread)
ROPE_CASES = [(2, 64, 4, 2, 128, torch.bfloat16, True, None),
              (2, 64, 4, 2, 128, torch.bfloat16, False, 100),
              (1, 37, 3, 1, 64, torch.float32, True, 5),
              (2, 9, 2, 2, 18, torch.bfloat16, False, None)]


@pytest.mark.parametrize("batch,seq,heads,kv_heads,dim,dtype,head_major,"
                         "start", ROPE_CASES,
                         ids=["flash_bf16", "natural_offset_bf16",
                              "flash_f32", "d18_bf16"])
def test_rope_kernels_match_plain_versions(cuda, batch, seq, heads,
                                           kv_heads, dim, dtype, head_major,
                                           start):
    """rope_qk and rope_bwd: every output bit-equal to the plain version
    (zeros and negative zeros in the gradients), one launch each, and
    the autograd Function's gradients those of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(31)

    def randn(h):
        return torch.randn((batch, seq, h, dim), generator=gen,
                           device=cuda).to(dtype)

    q, k = randn(heads), randn(kv_heads)
    v = randn(kv_heads) if head_major else None
    pos = None if start is None else start + torch.arange(seq, device=cuda)
    extra = {"v": v, "head_major": True} if head_major else {}
    before = (WRAPPERS["rope"].launches, WRAPPERS["rope_bwd"].launches)
    outs = ropemod.rope_qk(q, k, 10000.0, pos, **extra)
    assert same_bits(outs, ropemod._plain(q, k, v, 10000.0, pos,
                                          head_major))
    douts = [torch.randn(t.shape, generator=gen, device=cuda).to(dtype)
             for t in outs]
    douts[0].view(-1)[:dim] = -0.0
    dv = douts[2] if head_major else None
    grads = ropemod.rope_bwd(douts[0], douts[1], 10000.0, pos, dv=dv,
                             head_major=head_major)
    assert same_bits(grads, ropemod._plain_backward(
        douts[0], douts[1], dv, 10000.0, pos, head_major))
    assert (WRAPPERS["rope"].launches, WRAPPERS["rope_bwd"].launches) == (
        before[0] + 1, before[1] + 1)
    inputs = [t.clone().requires_grad_() for t in (q, k, v) if t is not None]
    outs = ropemod.rope_qk(*inputs[:2], 10000.0, pos,
                           **({"v": inputs[2], "head_major": True}
                              if head_major else {}))
    assert same_bits(torch.autograd.grad(outs, inputs, douts), grads)


def adamw_operands(cuda, dtype, n_leaves, seed=32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shapes = [(64, 48), (1000,), (3, 5, 7)] * (n_leaves // 3) \
        + [(17,)] * (n_leaves % 3)

    def like(shape, scale):
        return (scale * torch.randn(shape, generator=gen, device=cuda)) \
            .to(dtype)

    params = [like(s, 1.0) for s in shapes]
    grads = [like(s, 1e-2) for s in shapes]
    mu = [like(s, 1e-3) for s in shapes]
    nu = [like(s, 1e-2).square() for s in shapes]
    return grads, mu, nu, params


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["constant", "schedule", "clip_above",
                                  "clip_below", "adam"])
def test_adamw_kernel_matches_plain_version(cuda, dtype, case):
    """The update over 50 leaves (two launches: 48 a table) bit-equal to
    the plain version, the inputs unchanged."""
    from tpu_operator_libs_torch.optim import AdamW
    from tpu_operator_libs_torch.parallel import global_norm

    options = {"constant": {}, "schedule": {"warmup_steps": 2,
                                            "total_steps": 10},
               "clip_above": {"clip_norm": 0.1},
               "clip_below": {"clip_norm": 100.0},
               "adam": {"weight_decay": 0.0}}[case]
    opt = AdamW(3e-3, **options)
    grads, mu, nu, params = adamw_operands(cuda, dtype, 50)
    count = torch.tensor(5 if case == "schedule" else 0, dtype=torch.int32,
                         device=cuda)
    state = {"count": count, "mu": mu, "nu": nu}
    kw = {"lr": opt.learning_rate(count), "weight_decay": opt.weight_decay,
          "clip_norm": opt.clip_norm,
          "norm": global_norm(grads) if opt.clip_norm else None}
    before = [t.clone() for t in grads + mu + nu + params]
    launches = WRAPPERS["adamw"].launches
    got_p, got_s = amod.adamw_update(grads, state, params, **kw)
    assert WRAPPERS["adamw"].launches == launches + 2
    want_p, want_s = amod.adamw_update_reference(grads, state, params, **kw)
    assert same_bits(got_p + got_s["mu"] + got_s["nu"],
                     want_p + want_s["mu"] + want_s["nu"])
    assert torch.equal(got_s["count"], want_s["count"])
    assert same_bits(before, grads + mu + nu + params)


def test_rope_and_adamw_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError):
        ropemod.rope_qk(q, q.bfloat16(), 10000.0)
    with pytest.raises(ValueError):
        ropemod.rope_qk(q.transpose(1, 2).contiguous().transpose(1, 2), q,
                        10000.0)
    grads, mu, nu, params = adamw_operands(cuda, torch.float32, 3)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    for bad in ({"grads": [grads[0].bfloat16()] + grads[1:]},
                {"params": [params[0].t()] + params[1:]}):
        args = {"grads": grads, "params": params, **bad}
        with pytest.raises(ValueError):
            amod.adamw_update(args["grads"], {"count": count, "mu": mu,
                                              "nu": nu}, args["params"],
                              lr=1e-3, weight_decay=1e-4)


def test_train_step_launches_rope_and_adamw(cuda):
    """One flash train step of a narrow Llama on the card: RoPE and its
    backward once a layer, AdamW once; against the same step on the CPU
    (the plain versions) within the bf16 logits' tolerance of the loss."""
    cfg = tllama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=512, seq_len=64,
                             attention_impl="flash")
    losses = {}
    for device in (cuda, torch.device("cpu")):
        optimizer, step = tllama.make_train_step(cfg, device=device)
        params = tllama.init_llama_params(cfg, seed=2, device="cpu")
        params = {k: v.to(device) if torch.is_tensor(v) else
                  [{n: t.to(device) for n, t in layer.items()}
                   for layer in v] for k, v in params.items()}
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        before = {n: WRAPPERS[n].launches for n in ("rope", "rope_bwd",
                                                    "adamw")}
        _, loss = step(state, tllama.make_token_batch(0, cfg, device="cpu"))
        losses[device.type] = float(loss)
        launched = {n: WRAPPERS[n].launches - before[n] for n in before}
        assert launched == ({"rope": 2, "rope_bwd": 2, "adamw": 1}
                            if device.type == "cuda" else
                            dict.fromkeys(before, 0))
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


@pytest.mark.parametrize(
    "label,batch,seq,vocab,dtype,used,gradient",
    [shape[:7] for shape in chip_smoke.LOSS_SHAPES],
    ids=[shape[0] for shape in chip_smoke.LOSS_SHAPES])
def test_cross_entropy_kernels_match_plain_versions(cuda, label, batch, seq,
                                                    vocab, dtype, used,
                                                    gradient):
    """The loss's forward and backward kernels at phase 3g's shapes
    against the plain version and its autograd: the loss within
    chip_smoke.LOSS_RTOL, bf16 dlogits within one ulp (f32 within
    chip_smoke's f32 limit), 0 past S_used; one launch each a call; the
    autograd Function's gradient the backward kernel's."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    logits = (3.0 * torch.randn((batch, seq, vocab), generator=gen,
                                device=cuda)).to(dtype)
    targets = torch.randint(0, vocab, (batch, used), generator=gen,
                            device=cuda)
    grad = torch.tensor(gradient, device=cuda)
    before = (WRAPPERS["cross_entropy"].launches,
              WRAPPERS["cross_entropy_bwd"].launches)
    loss, stats = lossmod.cross_entropy_fwd(logits, targets)
    dlogits = lossmod.cross_entropy_bwd(logits, targets, stats, grad)
    assert (WRAPPERS["cross_entropy"].launches,
            WRAPPERS["cross_entropy_bwd"].launches) == (before[0] + 1,
                                                        before[1] + 1)
    x = logits.clone().requires_grad_()
    want = lossmod.next_token_loss_reference(x, targets)
    (dwant,) = torch.autograd.grad(want, x, grad)
    assert abs(float(loss) - float(want)) <= \
        chip_smoke.LOSS_RTOL * abs(float(want))
    assert not dlogits[:, used:].any()
    if dtype == torch.bfloat16:
        assert chip_smoke.max_ulp(dlogits, dwant) <= 1
    else:
        gp = gradient / targets.numel()
        limit = (chip_smoke.DLOGITS_F32_RTOL * dwant.abs()
                 + chip_smoke.DLOGITS_F32_GP_ATOL * gp)
        assert bool(((dlogits - dwant).abs() <= limit).all())
    y = logits.clone().requires_grad_()
    (got,) = torch.autograd.grad(lossmod.cross_entropy(y, targets), y, grad)
    assert same_bits([got], [dlogits])


def test_cross_entropy_launches_and_replays_bit_equal(cuda):
    """At the train step's shape: two launches of each kernel and a
    graph-replayed one give the same bits (the mean's partials added in
    order, no float atomics), the ticket counter back at 0."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    logits = torch.randn((16, 1024, 2048), generator=gen,
                         device=cuda).bfloat16()
    targets = torch.randint(0, 2048, (16, 1023), generator=gen, device=cuda)
    grad = torch.ones((), device=cuda)
    first = lossmod.cross_entropy_fwd(logits, targets)
    again = lossmod.cross_entropy_fwd(logits, targets)
    assert same_bits(first, again)
    d_first = lossmod.cross_entropy_bwd(logits, targets, first[1], grad)
    assert same_bits([d_first], [lossmod.cross_entropy_bwd(
        logits, targets, first[1], grad)])
    assert chip_smoke.graph_replay_equal(
        lambda: chip_smoke.flat_bytes(
            *lossmod.cross_entropy_fwd(logits, targets)),
        chip_smoke.flat_bytes(*first))
    assert chip_smoke.graph_replay_equal(
        lambda: lossmod.cross_entropy_bwd(logits, targets, first[1], grad),
        d_first)
    torch.cuda.synchronize()
    assert all(not c.any() for c in lossmod._counters.values())


def test_cross_entropy_target_outside_the_vocabulary_gives_nan(cuda):
    logits = torch.randn((2, 5, 16), device=cuda)
    targets = torch.zeros((2, 4), dtype=torch.int64, device=cuda)
    targets[1, 2] = 16
    assert torch.isnan(lossmod.cross_entropy(logits, targets))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_leaves,norm", [(39, True), (50, False),
                                            (50, True)],
                         ids=["39_leaves_norm", "50_leaves_two_launches",
                              "50_leaves_norm"])
def test_global_norm_kernel_matches_plain_version(cuda, dtype, n_leaves,
                                                  norm):
    """Each leaf's sum of squares (one empty leaf among them) and the
    norm within chip_smoke.GLOBAL_NORM_RTOL of the plain version, one
    launch for every 48 leaves, two launches bit-equal."""
    grads, _, _, _ = adamw_operands(cuda, dtype, n_leaves)
    grads[5] = grads[5][:0]
    before = WRAPPERS["global_norm"].launches
    sums, total = nmod.sum_of_squares(grads, norm=norm)
    assert WRAPPERS["global_norm"].launches == before + (
        1 if n_leaves <= nmod.MAX_LEAVES else 2)
    plain = torch.stack(nmod.sum_of_squares_reference(grads))
    assert float(sums[5]) == 0.0
    rel = ((sums - plain).abs() / plain.clamp_min(1e-30)).max()
    assert float(rel) <= chip_smoke.GLOBAL_NORM_RTOL
    if norm:
        want = torch.sqrt(sum(nmod.sum_of_squares_reference(grads)))
        assert abs(float(total) - float(want)) <= \
            chip_smoke.GLOBAL_NORM_RTOL * float(want)
        assert same_bits([total], [nmod.sum_of_squares(grads,
                                                       norm=True)[1]])
    else:
        assert total is None
    assert same_bits([sums], [nmod.sum_of_squares(grads, norm=norm)[0]])


def test_clipped_train_step_launches_the_loss_and_the_norm(cuda):
    """One flash train step of a narrow Llama in the clipped trainer
    configuration on the card: RoPE and its backward once a layer, the
    loss and its backward once, the global norm and AdamW once; the loss
    within 1e-4 relative of the same step on the CPU (the plain
    versions)."""
    cfg = tllama.LlamaConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=512, seq_len=64,
                             attention_impl="flash", grad_clip_norm=0.5,
                             warmup_steps=2, total_steps=100)
    names = ("rope", "rope_bwd", "cross_entropy", "cross_entropy_bwd",
             "adamw", "global_norm")
    losses = {}
    for device in (cuda, torch.device("cpu")):
        optimizer, step = tllama.make_train_step(cfg, device=device)
        params = tllama.init_llama_params(cfg, seed=2, device="cpu")
        params = {k: v.to(device) if torch.is_tensor(v) else
                  [{n: t.to(device) for n, t in layer.items()}
                   for layer in v] for k, v in params.items()}
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        before = {n: WRAPPERS[n].launches for n in names}
        _, loss = step(state, tllama.make_token_batch(0, cfg, device="cpu"))
        losses[device.type] = float(loss)
        launched = {n: WRAPPERS[n].launches - before[n] for n in names}
        assert launched == ({"rope": 2, "rope_bwd": 2, "cross_entropy": 1,
                             "cross_entropy_bwd": 1, "adamw": 1,
                             "global_norm": 1}
                            if device.type == "cuda" else
                            dict.fromkeys(names, 0))
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


#: a narrow Llama for the decode loops on the card (the kernels' shapes
#: at full width are in test_int8_matmul_matches_plain_version)
DECODE_CFG = tllama.LlamaConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                seq_len=64)


@pytest.mark.parametrize("case", ["greedy_bf16",
                                  "greedy_int8_weights_int8_kv",
                                  "sampled_int8_eos_logprobs"])
def test_graph_decode_equals_host_loop(cuda, case):
    """generate_on_device on the card replays one captured step per
    token after one eager step; its tokens (and logprobs) equal the host
    loop's bit for bit, so no step was lost or doubled, and the int8
    kernel's launches count every replay."""
    int8 = "int8" in case
    params = tllama.init_llama_params(DECODE_CFG, param_dtype=torch.bfloat16,
                                      seed=1, device=cuda)
    if int8:
        params = tdecode.quantize_params_int8(params)
    prompt = torch.randint(0, DECODE_CFG.vocab, (4, 8), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    new = 12
    kw = {"param_dtype": torch.bfloat16, "quantize_kv": int8}
    if case.startswith("sampled"):
        kw.update(temperature=1.0, top_k=50, top_p=0.9,
                  return_logprobs=True)
        free, _ = tdecode.generate(
            params, prompt, DECODE_CFG, new,
            generator=torch.Generator(device=cuda).manual_seed(3), **kw)
        kw["eos_id"] = int(free[0, 8 + 3])

    def run(fn):
        gen = (torch.Generator(device=cuda).manual_seed(3)
               if "temperature" in kw else None)
        return fn(params, prompt, DECODE_CFG, new, generator=gen, **kw)

    host = run(tdecode.generate)
    before = int8_matmul.launches
    before_decode = (decode_attention.launches, rope_kv_append.launches,
                     kv_append.launches)
    before_blocks = (rmod.add_rms_norm.launches, smod.swiglu.launches)
    before_picks = pmod.pick.launches
    dev = run(tdecode.generate_on_device)
    torch.cuda.synchronize()
    assert tdecode.generate_on_device.last_call["eager_steps"] == 1
    assert tdecode.generate_on_device.last_call["graph_launches"] == new - 2
    per_forward = 7 * DECODE_CFG.n_layers + 1
    assert int8_matmul.launches - before == (new * per_forward if int8
                                             else 0)
    # the rotation and cache write and the attention, once a layer a
    # forward; the rotation-free cache write never
    assert (decode_attention.launches - before_decode[0],
            rope_kv_append.launches - before_decode[1],
            kv_append.launches - before_decode[2]) == (
                new * DECODE_CFG.n_layers, new * DECODE_CFG.n_layers, 0)
    # the norm 2L + 1 times and the gate L times a forward
    assert (rmod.add_rms_norm.launches - before_blocks[0],
            smod.swiglu.launches - before_blocks[1]) == (
                new * (2 * DECODE_CFG.n_layers + 1),
                new * DECODE_CFG.n_layers)
    # every token is the token pick's: after prefill and after each step
    assert pmod.pick.launches - before_picks == new
    if "return_logprobs" in kw:
        (host, host_lp), (dev, dev_lp) = host, dev
        assert torch.equal(host_lp, dev_lp)
        assert (dev[0, 8 + 3:] == kw["eos_id"]).all()
    assert torch.equal(host, dev)


@pytest.mark.parametrize("case", ["greedy_bf16",
                                  "sampled_int8_eos_logprobs"])
def test_kept_graphs_decode_equals_host_loop(cuda, case):
    """generate_on_device with kept graphs (``DecodeGraphs``, a server's):
    the first call of a prompt shape captures its step, a later one of
    the same shape, other tokens and seed, replays it for every step over
    the first call's cache; each call's tokens (and logprobs) and the
    caller's generator after it equal the host loop's, and a replayed
    call counts every step's launches."""
    int8 = "int8" in case
    params = tllama.init_llama_params(DECODE_CFG, param_dtype=torch.bfloat16,
                                      seed=1, device=cuda)
    if int8:
        params = tdecode.quantize_params_int8(params)
    new = 12
    kw = {"param_dtype": torch.bfloat16, "quantize_kv": int8}
    if case.startswith("sampled"):
        kw.update(temperature=1.0, top_k=50, top_p=0.9,
                  return_logprobs=True, eos_id=7)
    graphs = tdecode.DecodeGraphs()

    def run(fn, length, seed, **more):
        prompt = torch.randint(0, DECODE_CFG.vocab, (4, length), device=cuda,
                               generator=torch.Generator(device=cuda)
                               .manual_seed(seed))
        gen = (torch.Generator(device=cuda).manual_seed(seed)
               if "temperature" in kw else None)
        out = fn(params, prompt, DECODE_CFG, new, generator=gen, **kw,
                 **more)
        return out, None if gen is None else gen.get_state()

    for length, seed, eager in ((8, 3, 1), (8, 4, 0), (13, 5, 1),
                                (8, 3, 0)):
        host = run(tdecode.generate, length, seed)
        before = (pmod.pick.launches, rmod.add_rms_norm.launches)
        dev = run(tdecode.generate_on_device, length, seed, graphs=graphs)
        torch.cuda.synchronize()
        assert tdecode.generate_on_device.last_call["eager_steps"] == eager
        assert tdecode.generate_on_device.last_call["graph_launches"] == (
            new - 1 - eager)
        assert (pmod.pick.launches - before[0],
                rmod.add_rms_norm.launches - before[1]) == (
                    new, new * (2 * DECODE_CFG.n_layers + 1))
        (host, host_state), (dev, dev_state) = host, dev
        if "return_logprobs" in kw:
            (host, host_lp), (dev, dev_lp) = host, dev
            assert torch.equal(host_lp, dev_lp)
            assert torch.equal(host_state, dev_state)
        assert torch.equal(host, dev)
    assert len(graphs) == 2


def need_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, {torch.cuda.device_count()} visible")


@pytest.mark.parametrize("ranks", [1, 2], ids=["one_rank", "two_ranks"])
@pytest.mark.parametrize("case", ["greedy_bf16",
                                  "greedy_int8_weights_int8_kv",
                                  "sampled_int8_eos_logprobs"])
def test_mesh_graph_decode_equals_host_loop(cuda, case, ranks):
    """generate_on_device with a mesh over NCCL (one rank a card, dp x
    tp: 1 x 1, or 1 x 2 with the step's all-reduces and the vocabulary
    gather in the graph) replays one captured step per token on every
    rank; each rank's tokens (and logprobs) equal the host loop's bit for
    bit and every rank's, and the int8 kernel's launches count every
    replay."""
    need_cards(ranks)
    new = 12
    results = run_ranks(workers.mesh_graph_decode_rank, ranks, case,
                        dataclasses.asdict(DECODE_CFG), 4, 8, new,
                        device="cuda", timeout=300.0)
    per_forward = 7 * DECODE_CFG.n_layers + 1
    first = results[0]
    for rank in results:
        assert rank["device_loop"]["eager_steps"] == 1
        assert rank["device_loop"]["graph_launches"] == new - 2
        assert rank["int8_launches"] == (new * per_forward
                                         if "int8" in case else 0)
        assert rank["decode_launches"] == {
            "decode_attention": new * DECODE_CFG.n_layers,
            "rope_kv_append": new * DECODE_CFG.n_layers, "kv_append": 0,
            "rms_norm": new * (2 * DECODE_CFG.n_layers + 1),
            "swiglu": new * DECODE_CFG.n_layers, "rope": 0, "rope_bwd": 0,
            "adamw": 0, "token_pick": new}
        np.testing.assert_array_equal(rank["device"], rank["host"])
        np.testing.assert_array_equal(rank["device"], first["device"])
        if "device_logprobs" in rank:
            np.testing.assert_array_equal(rank["device_logprobs"],
                                          rank["host_logprobs"])
            assert (rank["device"][0, 8 + 3:] == rank["eos_id"]).all()
    assert first["device"].shape == (4, 8 + new)


@pytest.mark.parametrize("ranks", [1, 2], ids=["one_rank", "two_ranks"])
def test_mesh_pod_over_nccl_drains_without_drops(cuda, ranks):
    """The serving pod on NCCL ranks: a mid-burst drain parks requests and
    drops none, and every rank replays each generation's decode from a
    graph: the first generation captures it (max_new_tokens - 2 launches),
    and every later one, of the same shape, replays it for each step
    (max_new_tokens - 1)."""
    need_cards(ranks)
    new = 8
    pod = run_ranks(serving.serve_rank, ranks, {"max_new_tokens": new},
                    {"n_requests": 8, "drain_after": 4, "workers": 3},
                    device="cuda", timeout=300.0)
    summary = pod[0]
    assert summary["dropped"] == 0 and summary["parked"] >= 1
    generations = summary["completed"]
    launches = (new - 2) + (new - 1) * (generations - 1)
    assert summary["graph_launches"] == launches
    for follower in pod[1:]:
        assert follower["follower_generations"] == generations
        assert follower["graph_launches"] == launches


@pytest.mark.parametrize("case", chip_smoke.PICK_CASES,
                         ids=[c[0] for c in chip_smoke.PICK_CASES])
def test_token_pick_matches_plain_version(cuda, case):
    """Phase 3h's cases: greedy tokens bit-equal to ``pick_reference``,
    sampled tokens equal but where either token's nucleus decision lies
    within ``chip_smoke.NUCLEUS_EXEMPT`` of top_p, logprobs within
    ``LOGPROB_RTOL`` and ``LOGPROB_ATOL`` (``pick_agreement`` raises
    otherwise); one launch a pick."""
    label, batch, vocab, dtype, settings, kind, draws, _ = case
    before = pmod.pick.launches
    _, _, exempt_rows, _, use = chip_smoke.pick_agreement(
        label, batch, vocab, dtype, settings, kind, draws)
    assert pmod.pick.launches - before == draws
    assert use <= 1.0
    assert exempt_rows < draws * batch  # the check held most rows


@pytest.mark.parametrize("settings", [
    chip_smoke.GREEDY, {**chip_smoke.PICK_SAMPLED, "want_logprob": True}],
    ids=["greedy", "sampled_logprob"])
def test_token_pick_graph_replay_equals_eager(cuda, settings):
    """The pick captured in a CUDA graph and replayed gives the eager
    launch's tokens and logprobs bit for bit, and so does a second
    launch; the prefill's strided view too."""
    gen = torch.Generator(device=cuda).manual_seed(51)
    for kind in ("randn", "strided"):
        x = chip_smoke.pick_logits(gen, 8, 2048, torch.bfloat16, kind)
        u = torch.rand((8, 2048), generator=gen, device=cuda)
        args = tuple(settings[k] for k in ("temperature", "top_k", "top_p",
                                           "want_logprob"))
        eager = pmod.pick(x, u, *args)
        assert same_bits([t for t in pmod.pick(x, u, *args) if t is not None],
                         [t for t in eager if t is not None])
        assert chip_smoke.graph_replay_equal(
            lambda: chip_smoke.flat_bytes(*pmod.pick(x, u, *args)),
            chip_smoke.flat_bytes(*eager))


def test_token_pick_sampled_draws_follow_the_generator_in_a_graph(cuda):
    """``_pick_next`` captured with its generator registered: each replay
    draws at the generator's next offsets, as eager picks from an equally
    seeded generator do, token for token."""
    gen = torch.Generator(device=cuda).manual_seed(52)
    x = chip_smoke.pick_logits(gen, 8, 2048, torch.bfloat16, "randn")
    eager_gen = torch.Generator(device=cuda).manual_seed(7)
    want = [tdecode._pick_next(x, 1.0, 50, eager_gen, 0.9, True)
            for _ in range(4)]
    graph_gen = torch.Generator(device=cuda).manual_seed(7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(graph_gen)
    with torch.cuda.stream(side):
        first = tdecode._pick_next(x, 1.0, 50, graph_gen, 0.9, True)
        graph.capture_begin()
        out = tdecode._pick_next(x, 1.0, 50, graph_gen, 0.9, True)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    got = [first]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        got.append(tuple(t.clone() for t in out))
    for (tok, lp), (want_tok, want_lp) in zip(got, want):
        assert torch.equal(tok, want_tok) and torch.equal(lp, want_lp)


def test_token_pick_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 16), device=cuda)
    with pytest.raises(ValueError, match="u is on"):
        pmod.pick(x, torch.rand((2, 16)), 1.0)  # noise on the CPU
    with pytest.raises(ValueError, match="uniforms"):
        pmod.pick(x, None, 1.0)
    with pytest.raises(ValueError, match="top_k"):
        pmod.pick(x, torch.rand((2, 16), device=cuda), 1.0, top_k=17)
    # wider than a cluster's shared memory holds
    wide = torch.zeros((1, pmod.WIDE_ELEMS + 8), dtype=torch.bfloat16,
                       device=cuda)
    with pytest.raises(ValueError, match="columns"):
        pmod.pick(wide, None, 0.0)

"""The CUDA flash-attention kernels against their plain versions, on the
card.

Run on a machine with an NVIDIA H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without CUDA every test here skips (decided in a fixture, not at import,
so that every pytest-xdist worker collects the same tests).
"""

import pytest
import torch

from tpu_operator_libs_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_reference,
    flash_backward,
    flash_forward,
    kernel_design,
)

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


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim,dtype", [
    (8, 16, 16, 1024, 128, torch.bfloat16),   # llama-277M forward
    (2, 8, 2, 1000, 64, torch.float32),       # GQA and a ragged tile
    # GQA and a ragged tile through the bf16 (wgmma) design
    (2, 8, 2, 1000, 128, torch.bfloat16),
    (2, 8, 2, 1000, 64, torch.bfloat16),
], ids=["a_full_width_bf16", "c_gqa_ragged_f32", "d_gqa_ragged_bf16",
        "d64_gqa_ragged_bf16"])
def test_kernel_matches_plain_version(cuda, batch, heads, kv_heads, seq,
                                      dim, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((batch, h, seq, dim), generator=gen,
                           device=cuda).to(dtype)
               for h in (heads, kv_heads, kv_heads))
    before = flash_attention.launches
    out, lse = flash_forward(q, k, v, causal=True, sm_scale=dim ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             sm_scale=dim ** -0.5)
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
], ids=["main_train_step_bf16", "c_gqa_ragged_f32", "d_gqa_ragged_bf16",
        "d64_gqa_ragged_bf16", "odd_gqa_ragged_bf16",
        "d_non_causal_bf16"])
def test_backward_kernels_match_plain_version(cuda, batch, heads, kv_heads,
                                              seq, dim, dtype, causal):
    """dK/dV and dQ against flash_attention_backward_reference on the
    forward kernel's out and lse; two launches give bit-equal results
    (no atomics, a fixed order of every sum); bf16 at head_dim 64 and 128
    runs both on the tensor cores."""
    wgmma = dtype == torch.bfloat16 and dim in (64, 128)
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert kernel_design(name, dtype, dim)["design"] == (
            "sm90 wgmma" if wgmma else "scalar")
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((batch, h, seq, dim), generator=gen,
                               device=cuda).to(dtype)
                   for h in (heads, kv_heads, kv_heads, heads))
    kw = {"causal": causal, "sm_scale": dim ** -0.5}
    out, lse = flash_forward(q, k, v, **kw)
    before = (flash_attention_bwd_dkv.launches,
              flash_attention_bwd_dq.launches)
    got = flash_backward(q, k, v, out, lse, do, **kw)
    again = flash_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (before[0] + 2,
                                                 before[1] + 2)
    want = flash_attention_backward_reference(q, k, v, out, lse, do, **kw)
    rtol, atol = TOL[dtype]
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)

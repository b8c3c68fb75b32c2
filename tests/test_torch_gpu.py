"""The CUDA kernels (flash attention, the ring-attention fold, the
int8-weight matmul) against their plain versions, on the card, the
ring's block chain against the whole-sequence kernels, and the
graph-replayed decode loop against the host loop.

Run on a machine with an NVIDIA H100:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without CUDA every test here skips (decided in a fixture, not at import,
so that every pytest-xdist worker collects the same tests).
"""

import pytest
import torch

from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.examples.ring_attention import (
    _block_attention,
    _block_backward,
    _schedule,
)
from tpu_operator_libs_torch.kernels.attention_fold import (
    attention_fold,
    attention_fold_reference,
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
    # a ring's past block: no mask
    (1, 16, 16, 2048, 128, torch.bfloat16, False),
    (2, 8, 2, 1000, 64, torch.float32, False),
], ids=["main_train_step_bf16", "c_gqa_ragged_f32", "d_gqa_ragged_bf16",
        "d64_gqa_ragged_bf16", "odd_gqa_ragged_bf16",
        "d_non_causal_bf16", "ring_block_non_causal_bf16",
        "c_non_causal_f32"])
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
], ids=["decode_qkvo", "decode_gate_up", "decode_down", "contract_qkvo",
        "prefill_qkvo", "prefill_gate_up", "prefill_down", "tp2_column",
        "tp2_row", "ragged", "decode_f32"])
def test_int8_matmul_matches_plain_version(cuda, m, k, n, dtype):
    """The kernel against ``(x @ q.to(x.dtype)) * s.to(x.dtype)`` on the
    same inputs; two launches bit-equal (split-K sums in a fixed order).
    Both sides round the f32 sum and then its product with the rounded
    scale, so the limit takes the dtype's rtol once for each rounding
    (``chip_smoke.int8_limit``)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.02
    s = torch.clamp_min(w.abs().amax(dim=0), 1e-8) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
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
    dev = run(tdecode.generate_on_device)
    torch.cuda.synchronize()
    assert tdecode.generate_on_device.last_call["eager_steps"] == 1
    assert tdecode.generate_on_device.last_call["graph_launches"] == new - 2
    per_forward = 7 * DECODE_CFG.n_layers + 1
    assert int8_matmul.launches - before == (new * per_forward if int8
                                             else 0)
    if "return_logprobs" in kw:
        (host, host_lp), (dev, dev_lp) = host, dev
        assert torch.equal(host_lp, dev_lp)
        assert (dev[0, 8 + 3:] == kw["eos_id"]).all()
    assert torch.equal(host, dev)

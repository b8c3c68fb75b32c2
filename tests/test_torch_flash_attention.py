"""The port's flash attention on the CPU: the plain versions of the
forward and the backward against JAX's Pallas TPU kernels run in
interpret mode, the wrappers' contract, and the rule that the port
imports nothing of JAX."""

import ast
import functools
import json
import math
import subprocess
from pathlib import Path

import jax  # noqa: F401  (imported before torch work: tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as pallas_flash_attention,
)

import chip_smoke
import flash_backward_variants as fbv
import tf32_hopper
from chip_smoke import KERNEL_TOL, LSE_ATOL, limit_use
from tpu_operator_libs_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_reference,
    flash_backward,
    flash_forward,
)

ROOT = Path(__file__).resolve().parent.parent

#: f32 on both sides; the Pallas kernel folds keys blockwise with the
#: online softmax while the plain version takes one softmax over all of
#: them, so sums differ in order (observed ~6e-7 at S=256).
PALLAS_ATOL = 2e-5


def _inputs(seed, batch, heads, kv_heads, seq, dim):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, seq, dim)).astype(np.float32)
    k = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    v = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim", [
    (1, 2, 2, 128, 32),
    (2, 4, 4, 256, 64),
    (1, 4, 2, 128, 16),   # GQA: K/V repeated on the JAX side only
])
def test_plain_version_matches_pallas_kernel(batch, heads, kv_heads, seq,
                                             dim):
    """The Pallas kernel takes q_seq_len >= 128 and a kv_seq_len that
    128 divides (its default BlockSizes), hence S = 128 * k."""
    q, k, v = _inputs(seq + dim, batch, heads, kv_heads, seq, dim)
    group = heads // kv_heads
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_flash_attention(
            jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, axis=1),
            jnp.repeat(jnp.asarray(v), group, axis=1),
            causal=True, sm_scale=dim ** -0.5))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True,
                          sm_scale=dim ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PALLAS_ATOL)


#: f32 on both sides; the Pallas backward recomputes P blockwise from its
#: (l, m) pair, the plain version from the lse in one pass.
PALLAS_BWD_ATOL = 1e-5
#: what chip_smoke.py holds the f32 kernels to on the card
KERNEL_RTOL_F32, KERNEL_ATOL_F32 = KERNEL_TOL[torch.float32]


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim", [
    (1, 2, 2, 128, 32),
    (1, 2, 2, 256, 64),
    (1, 4, 2, 128, 16),   # GQA: K/V repeated on the JAX side only
])
def test_plain_backward_matches_pallas_backward(batch, heads, kv_heads,
                                                seq, dim):
    """jax.grad of sum(out * dO) through the Pallas kernel (its
    _flash_attention_bwd_dkv and _flash_attention_bwd_dq, interpret
    mode) against flash_attention_backward_reference on the lse of the
    plain forward. The kernel's own mha_reference has no causal VJP, so
    it is not the oracle."""
    q, k, v = _inputs(seq + dim + 1, batch, heads, kv_heads, seq, dim)
    do = np.random.default_rng(seq + dim + 2).standard_normal(
        q.shape).astype(np.float32)
    group = heads // kv_heads
    scale = dim ** -0.5

    def objective(q, k, v):
        out = pallas_flash_attention(
            q, jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1),
            causal=True, sm_scale=scale)
        return jnp.sum(out * jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(objective, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_forward(qt, kt, vt, causal=True, sm_scale=scale)
    got = flash_attention_backward_reference(
        qt, kt, vt, out, lse, torch.from_numpy(do), causal=True,
        sm_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PALLAS_BWD_ATOL, err_msg=name)


def wrong_variant_errors(seed=0):
    """Max |err| against the plain backward, at chip_smoke.py's f32 shape
    (c) (2, 8 heads / 2 kv heads, 1000, 64), of wrong variants of the
    kernels' algorithm: the reading that a kernel with such a fault would
    give there."""
    batch, heads, kv_heads, seq, dim = 2, 8, 2, 1000, 64
    q, k, v = (torch.from_numpy(x) for x in _inputs(seed, batch, heads,
                                                     kv_heads, seq, dim))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed))
    kw = {"causal": True, "sm_scale": dim ** -0.5}
    o, lse = flash_forward(q, k, v, **kw)
    dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                    **kw)
    # the last query head of each group left out of the group sum
    group = heads // kv_heads
    keep = [h for h in range(heads) if h % group != group - 1]
    _, dk_part, dv_part = flash_attention_backward_reference(
        q[:, keep].contiguous(), k, v, o[:, keep].contiguous(),
        lse[:, keep].contiguous(), do[:, keep].contiguous(), **kw)
    # the ragged last key tile (keys 960-999) left out of dQ's key loop
    dq_tiles, _, _ = flash_attention_backward_reference(
        q, k[:, :, :960].contiguous(), v[:, :, :960].contiguous(), o, lse,
        do, **kw)
    # the f32 inputs staged in shared memory as bf16
    staged = flash_attention_backward_reference(
        *(t.to(torch.bfloat16).float() for t in (q, k, v, o)), lse,
        do.to(torch.bfloat16).float(), **kw)
    wrong = {"dk_unscaled": (dk / kw["sm_scale"], dk),
             "dk_group_head_dropped": (dk_part, dk),
             "dv_group_head_dropped": (dv_part, dv),
             "dq_ragged_tile_dropped": (dq_tiles, dq)}
    for name, got, want in zip(("dq", "dk", "dv"), staged, (dq, dk, dv)):
        wrong[f"{name}_staged_bf16"] = (got, want)
    return {name: ((got - want).abs().max().item(),
                   bool(((got - want).abs()
                         <= KERNEL_ATOL_F32
                         + KERNEL_RTOL_F32 * want.abs()).all()))
            for name, (got, want) in wrong.items()}


def test_backward_f32_limit_rejects_wrong_variants():
    """chip_smoke.py holds the f32 backward kernels to their plain
    version within KERNEL_TOL; the 3xTF32 kernels' sound reading at shape
    (c) is 6.0e-5, a limit_use of 0.75, on an H100 80GB HBM3 at 700 W
    (PERF.md §6). Every wrong variant lies outside that limit by a
    wide margin, so the limit lies between the two readings."""
    for name, (err, within) in wrong_variant_errors().items():
        assert not within and err > 100 * KERNEL_ATOL_F32, (name, err)


#: what chip_smoke.py holds the bf16 kernels to on the card
KERNEL_RTOL_BF16, KERNEL_ATOL_BF16 = KERNEL_TOL[torch.bfloat16]
#: the bf16 (wgmma) kernels' key tile
KEY_TILE = 64
LOG2E = math.log2(math.e)


def _tf32(x, rounded=True):
    """x as the tensor cores read it in TF32, on the bit pattern: the f32
    mantissa rounded to 10 bits, ties away from zero, as
    cvt.rna.tf32.f32 rounds and as the 3xTF32 kernels round their hi
    words by an integer add and mask, or with ``rounded`` False cut to
    10 bits (a lo word the kernels pass unrounded)."""
    bits = x.float().contiguous().view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


#: the 3xTF32 kernels' products (``csrc/tf32_mma.cuh``) and the faults
#: they can have: each mode's TF32 products of a = hi + lo and b = hi + lo
TF32_PRODUCTS = {"3xtf32": ("hh", "hl", "lh"), "tf32": ("hh",),
                 "3xtf32_no_lh": ("hh", "hl"), "3xtf32_no_hl": ("hh", "lh")}


def _tf32_product(a, b, how):
    """a @ b on the tensor cores as the TF32 products of ``how``
    (:data:`TF32_PRODUCTS`): a_hi b_hi, plus the cross products the mode
    keeps, each exact in f32 and summed in f32; lo = x - hi as the
    tensor cores read it (``csrc/tf32_mma.cuh``)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b - b_hi, False)
    terms = {"hh": (a_hi, b_hi), "hl": (a_hi, b_lo), "lh": (a_lo, b_hi)}
    cross = [terms[t][0] @ terms[t][1] for t in TF32_PRODUCTS[how][1:]]
    return a_hi @ b_hi + (sum(cross) if cross else 0.0)


def _first_product(a, b, how):
    """a @ b of two inputs (S = Q K^T and the like): in f32 as the
    wgmma kernels sum their bf16 inputs, or by :func:`_tf32_product`."""
    return _tf32_product(a, b, how) if how in TF32_PRODUCTS else a @ b


def _second_product(a, b, how):
    """a @ b for an f32 ``a`` as a wgmma kernel feeds it from registers:
    "split" as hi + lo, two bf16 values each run through the product;
    "round" rounded once to bf16, as the Pallas kernels do before P V and
    dS K; "f32" as it is; a mode of :data:`TF32_PRODUCTS` as the 3xTF32
    kernels run it."""
    if how in TF32_PRODUCTS:
        return _tf32_product(a, b.float(), how)
    if how == "f32":
        return a @ b
    hi = a.to(torch.bfloat16).float()
    if how == "round":
        return hi @ b
    lo = (a - hi).to(torch.bfloat16).float()
    return hi @ b + lo @ b


def _kv_for_heads(x, heads, kv_head):
    group = heads // x.shape[1]
    idx = torch.arange(heads) // group if kv_head is None else kv_head
    return x.float()[:, idx]


def _visible(sq, sk, mask_shift):
    return torch.arange(sk)[None] <= torch.arange(sq)[:, None] + mask_shift


def tiled_forward(q, k, v, sm_scale, *, second="split", drop_alpha=False,
                  mask_shift=0, kv_head=None):
    """The bf16 wgmma forward's arithmetic: S in f32 in base-2 units, the
    online softmax over 64-key tiles, P into P V by ``second``
    (:func:`_second_product`), O normalised at the end. The faults a
    tensor-core kernel can have: ``drop_alpha`` leaves O unrescaled when
    the row max moves, ``mask_shift=1`` lets query i see key i + 1,
    ``kv_head`` maps the query heads to other KV heads than h // group."""
    heads, sq, sk = q.shape[1], q.shape[2], k.shape[2]
    kf = _kv_for_heads(k, heads, kv_head)
    vf = _kv_for_heads(v, heads, kv_head)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (sm_scale * LOG2E)
    s = s.masked_fill(~_visible(sq, sk, mask_shift), float("-inf"))
    m = torch.full(s.shape[:3], float("-inf"))
    l = torch.zeros(s.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, sk, KEY_TILE):
        tile = s[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if not drop_alpha:
            acc = acc * alpha[..., None]
        acc = acc + _second_product(p, vf[:, :, k0:k0 + KEY_TILE], second)
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def tiled_dq(q, k, v, o, lse, do, sm_scale, *, second="split", first="f32",
             scaled=True, mask_shift=0, kv_head=None):
    """The dQ kernels' arithmetic: S = Q K^T and dP = dO V^T by
    ``first`` (:func:`_first_product`), P = exp2(S * scale_log2 - lse *
    log2e), dS = P * (dP - di) in f32, dS into dS K by ``second``, dQ
    scaled by sm_scale at the end unless ``scaled`` is False (a fault);
    ``mask_shift`` and ``kv_head`` as for :func:`tiled_forward`. The
    wgmma dQ takes the defaults, the 3xTF32 one "3xtf32" for both."""
    heads, sq, sk = q.shape[1], q.shape[2], k.shape[2]
    kf = _kv_for_heads(k, heads, kv_head)
    vf = _kv_for_heads(v, heads, kv_head)
    s = _first_product(q.float(), kf.transpose(-1, -2), first) \
        * (sm_scale * LOG2E)
    p = torch.exp2(s - lse[..., None] * LOG2E)
    p = p.masked_fill(~_visible(sq, sk, mask_shift), 0.0)
    dp = _first_product(do.float(), vf.transpose(-1, -2), first)
    di = (o.float() * do.float()).sum(-1)
    dq = _second_product(p * (dp - di[..., None]), kf, second)
    return (dq * (sm_scale if scaled else 1.0)).to(q.dtype)


#: the bf16 (wgmma) dK/dV's query tile
QUERY_TILE = 64


def tiled_dkv(q, k, v, o, lse, do, sm_scale, *, second="split",
              first="f32", scaled=True, mask_shift=0, kv_head=None,
              group_sum=True, dropped_head=None, dv_from_ds=False,
              lse_by_row=False):
    """The dK/dV kernels' arithmetic, transposed (keys as rows): S^T =
    K Q^T and dP^T = V dO^T by ``first`` (:func:`_first_product`; the
    3xTF32 kernel takes "3xtf32" for both products, the wgmma one the
    defaults), P^T = exp2(S^T * scale_log2 - lse * log2e) with lse read
    by column (the query), dS^T = P^T * (dP^T - di) in f32; then
    dV += P^T dO and dK += dS^T Q over 64-query tiles, P^T and dS^T into
    the products by ``second`` (:func:`_second_product`); dK scaled by
    sm_scale at the end and both summed over each KV head's group. The
    faults a tensor-core kernel can have: ``scaled=False`` leaves dK
    unscaled, ``group_sum=False`` keeps only the group's last query head
    (accumulators reset per head), ``dropped_head`` leaves that head of
    each group out of the sum (a partial the combine skips),
    ``dv_from_ds`` feeds dS^T to dV's
    product for P^T, ``lse_by_row`` reads lse by the fragment's row (the
    key) instead of its column; ``mask_shift`` and ``kv_head`` as for
    :func:`tiled_forward`."""
    batch, heads, sq, dim = q.shape
    kv_heads, sk = k.shape[1], k.shape[2]
    group = heads // kv_heads
    kf = _kv_for_heads(k, heads, kv_head)
    vf = _kv_for_heads(v, heads, kv_head)
    st = _first_product(kf, q.float().transpose(-1, -2), first) \
        * (sm_scale * LOG2E)
    lse_t = lse[..., :sk, None] if lse_by_row else lse[:, :, None]
    pt = torch.exp2(st - lse_t * LOG2E)
    pt = pt.masked_fill(~_visible(sq, sk, mask_shift).T, 0.0)
    dpt = _first_product(vf, do.float().transpose(-1, -2), first)
    di = (o.float() * do.float()).sum(-1)
    dst = pt * (dpt - di[:, :, None])
    dk = torch.zeros(batch, heads, sk, dim)
    dv = torch.zeros(batch, heads, sk, dim)
    for q0 in range(0, sq, QUERY_TILE):
        cols = slice(q0, q0 + QUERY_TILE)
        dv += _second_product((dst if dv_from_ds else pt)[..., cols],
                              do.float()[:, :, cols], second)
        dk += _second_product(dst[..., cols], q.float()[:, :, cols], second)
    dk = dk.reshape(batch, kv_heads, group, sk, dim)
    dv = dv.reshape(batch, kv_heads, group, sk, dim)
    if dropped_head is not None:
        kept = [i for i in range(group) if i != dropped_head]
        dk, dv = dk[:, :, kept], dv[:, :, kept]
    dk, dv = (dk.sum(2), dv.sum(2)) if group_sum else (dk[:, :, -1],
                                                       dv[:, :, -1])
    return ((dk * (sm_scale if scaled else 1.0)).to(k.dtype),
            dv.to(v.dtype))


def _bf16_limit_use(got, want):
    """chip_smoke.py's limit_use under the bf16 limit."""
    return limit_use((got.float() - want.float()).abs(), want,
                     KERNEL_RTOL_BF16, KERNEL_ATOL_BF16)


@pytest.fixture(scope="module", params=[64, 128], ids=["d64", "d128"])
def shape_d(request):
    """chip_smoke.py's bf16 shape (d), (2, 8 heads / 2 kv heads, 1000,
    D): GQA and a ragged last key tile, with the plain versions'
    out, lse and dq."""
    dim = request.param
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(20 + dim, 2, 8, 2, 1000, dim))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(dim)
                     ).to(torch.bfloat16)
    kw = {"causal": True, "sm_scale": dim ** -0.5}
    o, lse = flash_forward(q, k, v, **kw)
    dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                    **kw)
    return {"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse, "dq": dq,
            "dk": dk, "dv": dv, "sm_scale": kw["sm_scale"]}


def test_bf16_kernels_arithmetic_holds_the_bf16_limit(shape_d):
    """At shape (d), the wgmma kernels' arithmetic (64-key tiles, P and
    dS as hi + lo bf16 into the second product) lies within the limit
    chip_smoke.py holds the kernels to against the f32 plain versions."""
    d = shape_d
    out = tiled_forward(d["q"], d["k"], d["v"], d["sm_scale"])
    dq = tiled_dq(d["q"], d["k"], d["v"], d["o"], d["lse"], d["do"],
                  d["sm_scale"])
    assert _bf16_limit_use(out, d["o"]) <= 1
    assert _bf16_limit_use(dq, d["dq"]) <= 1


def test_rounding_once_to_bf16_misses_the_bf16_limit(shape_d):
    """Rounding P and dS once to bf16 before the second product, as the
    Pallas kernels do, lies outside that limit at shape (d): the reason
    the kernels carry them as hi + lo."""
    d = shape_d
    out = tiled_forward(d["q"], d["k"], d["v"], d["sm_scale"],
                        second="round")
    dq = tiled_dq(d["q"], d["k"], d["v"], d["o"], d["lse"], d["do"],
                  d["sm_scale"], second="round")
    assert _bf16_limit_use(out, d["o"]) > 1
    assert _bf16_limit_use(dq, d["dq"]) > 1


@pytest.mark.parametrize("fault", [
    "fwd_alpha_dropped", "fwd_mask_shifted", "fwd_wrong_kv_head",
    "dq_mask_shifted", "dq_wrong_kv_head", "dq_without_sm_scale",
])
def test_bf16_limit_rejects_tensor_core_faults(shape_d, fault):
    """Each fault a tensor-core kernel can have lies beyond the bf16
    limit by 10x or more at shape (d), so the limit catches it."""
    d = shape_d
    wrong_kv = torch.arange(8) % 2  # h % H_kv instead of h // group
    args = (d["q"], d["k"], d["v"])
    bwd_args = args + (d["o"], d["lse"], d["do"], d["sm_scale"])
    got, want = {
        "fwd_alpha_dropped": (lambda: tiled_forward(
            *args, d["sm_scale"], drop_alpha=True), "o"),
        "fwd_mask_shifted": (lambda: tiled_forward(
            *args, d["sm_scale"], mask_shift=1), "o"),
        "fwd_wrong_kv_head": (lambda: tiled_forward(
            *args, d["sm_scale"], kv_head=wrong_kv), "o"),
        "dq_mask_shifted": (lambda: tiled_dq(*bwd_args, mask_shift=1),
                            "dq"),
        "dq_wrong_kv_head": (lambda: tiled_dq(*bwd_args, kv_head=wrong_kv),
                             "dq"),
        "dq_without_sm_scale": (lambda: tiled_dq(*bwd_args, scaled=False),
                                "dq"),
    }[fault]
    assert _bf16_limit_use(got(), d[want]) >= 10


def _dkv_args(d):
    return (d["q"], d["k"], d["v"], d["o"], d["lse"], d["do"],
            d["sm_scale"])


def test_dkv_arithmetic_holds_the_bf16_limit(shape_d):
    """At shape (d), the wgmma dK/dV's arithmetic (transposed products,
    64-query tiles, P^T and dS^T as hi + lo bf16) lies within the bf16
    limit for dK and dV (0.78-0.80 and 0.59-0.66 in PERF.md)."""
    dk, dv = tiled_dkv(*_dkv_args(shape_d))
    assert _bf16_limit_use(dk, shape_d["dk"]) <= 1
    assert _bf16_limit_use(dv, shape_d["dv"]) <= 1


def test_dkv_rounding_once_to_bf16_misses_the_bf16_limit(shape_d):
    """Rounding P^T and dS^T once to bf16, as the Pallas dK/dV kernel does
    (flash_attention.py:900, :918), lies outside the limit for both dK
    and dV at shape (d): the reason the kernel carries them as hi + lo."""
    dk, dv = tiled_dkv(*_dkv_args(shape_d), second="round")
    assert _bf16_limit_use(dk, shape_d["dk"]) > 1
    assert _bf16_limit_use(dv, shape_d["dv"]) > 1


@pytest.mark.parametrize("fault,grad", [
    ("mask_shift", "dk"), ("mask_shift", "dv"),
    ("kv_head", "dk"), ("kv_head", "dv"),
    ("group_sum", "dk"), ("group_sum", "dv"),
    ("scaled", "dk"), ("dv_from_ds", "dv"),
    ("lse_by_row", "dk"), ("lse_by_row", "dv"),
])
def test_bf16_limit_rejects_dkv_faults(shape_d, fault, grad):
    """Each fault the tensor-core dK/dV can have puts the gradient it
    touches 10x or more beyond the bf16 limit at shape (d)."""
    wrong = {"mask_shift": 1, "kv_head": torch.arange(8) % 2,
             "group_sum": False, "scaled": False, "dv_from_ds": True,
             "lse_by_row": True}
    dk, dv = tiled_dkv(*_dkv_args(shape_d), **{fault: wrong[fault]})
    got = {"dk": dk, "dv": dv}[grad]
    assert _bf16_limit_use(got, shape_d[grad]) >= 10


@functools.cache
def shape_f32(name):
    """The f32 shapes of the 3xTF32 kernels: chip_smoke.py's "c", (2, 8
    heads / 2 kv heads, 1000, 64), GQA and a ragged last tile, and "d128",
    (1, 4 / 4, 1024, 128) at the model's head_dim; inputs from numpy
    seed 1, the plain versions' out, lse and gradients."""
    batch, heads, kv_heads, seq, dim = {
        "c": (2, 8, 2, 1000, 64), "d128": (1, 4, 4, 1024, 128)}[name]
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, batch, heads,
                                                     kv_heads, seq, dim))
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(
        q.shape).astype(np.float32))
    kw = {"causal": True, "sm_scale": dim ** -0.5}
    o, lse = flash_forward(q, k, v, **kw)
    dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                    **kw)
    return {"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse, "dq": dq,
            "dk": dk, "dv": dv, "sm_scale": kw["sm_scale"]}


def _tf32_limit_use(name, how, **faults):
    """limit_use of dq, dk and dv under the f32 limit at shape ``name``
    for the 3xTF32 kernels' arithmetic with every product in mode
    ``how``; ``faults`` go to :func:`tiled_dkv`."""
    d = shape_f32(name)
    args = _dkv_args(d)
    dq = tiled_dq(*args, first=how, second=how)
    dk, dv = tiled_dkv(*args, first=how, second=how, **faults)
    return {grad: limit_use((got - d[grad]).abs(), d[grad], KERNEL_RTOL_F32,
                            KERNEL_ATOL_F32)
            for grad, got in (("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.mark.parametrize("name", ["c", "d128"])
def test_3xtf32_arithmetic_holds_the_f32_limit(name):
    """Every product as three TF32 products (S^T, dP^T and the second
    products of dK/dV, S, dP and dS K of dQ), as the f32 backward kernels
    run them, summed in f32 with rounding to nearest: dq, dk and dv
    within half the f32 limit that chip_smoke.py holds the kernels to,
    at (c) and at head_dim 128. The tensor cores' own accumulation takes
    more of it (test_3xtf32_on_the_tensor_cores_holds_the_f32_limit)."""
    for grad, use in _tf32_limit_use(name, "3xtf32").items():
        assert use <= 0.5, (grad, use)


@pytest.mark.parametrize("name,how", [
    ("c", "tf32"), ("d128", "tf32"), ("c", "3xtf32_no_lh"),
    ("c", "3xtf32_no_hl"),
])
def test_f32_limit_rejects_fewer_tf32_products(name, how):
    """One TF32 product, or three without either cross product (a_lo b_hi
    or a_hi b_lo), puts dq, dk and dv more than 10x beyond the f32 limit:
    the limit tells the 3xTF32 kernels from these faults."""
    for grad, use in _tf32_limit_use(name, how).items():
        assert use > 10, (grad, use)


@pytest.mark.parametrize("c,products,want", [
    # 0.75 ulp(1) above 1: rounded toward zero, not to nearest
    (1.0, [0.75 * 2.0 ** -23], 1.0),
    (-1.0, [-0.75 * 2.0 ** -23], -1.0),
    # eight products of 2^-26 (one ulp of 1 in all) each cut to 0 on
    # the grid of 2^-25 that c = 1 sets
    (1.0, [2.0 ** -26] * 8, 1.0),
    # a product of 2^-25 stays on the grid: six make 1.5 ulp, rounded
    # toward zero to one
    (1.0, [2.0 ** -25] * 6, 1.0 + 2.0 ** -23),
    # 1 - 2^-25 lies halfway between 1 - 2^-24 and 1: toward zero, the
    # former (to nearest, ties to even, would give 1)
    (1.0, [-(2.0 ** -25)], 1.0 - 2.0 ** -24),
])
def test_tensor_core_step_cuts_and_rounds_toward_zero(c, products, want):
    """The model of one TF32 mma step (tests/tf32_hopper.py, held to the
    card bit for bit by tests/test_torch_gpu.py): c and the products cut
    toward zero to a multiple of 2^(e - 25) for the largest exponent e
    among them, the sum rounded toward zero to f32. Each product is
    a_k * 1.0 with a_k exact in TF32."""
    a = torch.zeros(1, 1, 8)
    b = torch.zeros(1, 8, 1)
    a[0, 0, :len(products)] = torch.tensor(products)
    b[0, :len(products), 0] = 1.0
    got = tf32_hopper.mma(torch.tensor([[[c]]]), a, b).item()
    assert got == torch.tensor(want, dtype=torch.float32).item(), \
        (got, want)


def test_3xtf32_on_the_tensor_cores_holds_the_f32_limit():
    """The 3xTF32 kernels' arithmetic with the tensor cores' own
    accumulation (tests/tf32_hopper.py: every mma step cut and rounded
    toward zero) on the first KV head's group of shape (c), batch 0:
    dq, dk and dv within the f32 limit, and dk and dv further from the
    plain backward than the same products summed to nearest. On the
    card the kernels read what this emulation reads on these inputs to
    within 0.05 of the limit
    (tests/test_torch_gpu.py::test_tf32_backward_reads_as_modelled)."""
    d = shape_f32("c")
    q, do, o, lse = (d[x][:1, :4].contiguous() for x in ("q", "do", "o",
                                                         "lse"))
    k, v = (d[x][:1, :1].contiguous() for x in ("k", "v"))
    di = (o * do).sum(-1)
    want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                              causal=True,
                                              sm_scale=d["sm_scale"])
    got = tf32_hopper.tf32_backward(q, k, v, do, lse, di, d["sm_scale"])
    nearest = (tiled_dq(q, k, v, o, lse, do, d["sm_scale"], first="3xtf32",
                        second="3xtf32"),
               *tiled_dkv(q, k, v, o, lse, do, d["sm_scale"],
                          first="3xtf32", second="3xtf32"))
    uses = {}
    for name, g, n, w in zip(("dq", "dk", "dv"), got, nearest, want):
        uses[name] = [limit_use((x - w).abs(), w, KERNEL_RTOL_F32,
                                KERNEL_ATOL_F32) for x in (g, n)]
    assert all(use <= 1 for use, _ in uses.values()), uses
    assert all(uses[g][0] > uses[g][1] for g in ("dk", "dv")), uses


def test_f32_limit_rejects_a_dropped_group_head():
    """A GQA combine that leaves one query head's dK/dV partial out of
    its group's sum puts dk and dv more than 10x beyond the f32 limit at
    (c)."""
    uses = _tf32_limit_use("c", "3xtf32", dropped_head=1)
    assert uses["dk"] > 10 and uses["dv"] > 10, uses


#: the 3xTF32 forward's inputs by shape_f32 name: its first (query heads,
#: KV heads) of batch 0, (c)'s first KV head's group and two heads of
#: "d128"
FWD_GROUPS = {"c": (4, 1), "d128": (2, 2)}


@functools.cache
def tf32_forward_at(name, single=None):
    """(q, k, v, sm_scale) of FWD_GROUPS[name] and tests/tf32_hopper.py's
    3xTF32 forward on them, ``single`` as it takes it."""
    d = shape_f32(name)
    heads, kv_heads = FWD_GROUPS[name]
    q = d["q"][:1, :heads].contiguous()
    k, v = (d[x][:1, :kv_heads].contiguous() for x in ("k", "v"))
    return (q, k, v, d["sm_scale"]), tf32_hopper.tf32_forward(
        q, k, v, d["sm_scale"], single=single)


def _f32_limit_use(got, want):
    return limit_use((got - want).abs(), want, KERNEL_RTOL_F32,
                     KERNEL_ATOL_F32)


@pytest.mark.parametrize("name", ["c", "d128"])
def test_3xtf32_forward_on_the_tensor_cores_holds_the_f32_limit(name):
    """The 3xTF32 forward's arithmetic as the kernel runs it, with the
    tensor cores' own accumulation (tests/tf32_hopper.py: both products
    as three TF32 mma steps each cut and rounded toward zero, the online
    softmax over each warp's 32-key half of a tile, the halves merged at
    the end): out within KERNEL_TOL[float32] and lse within LSE_ATOL of
    the plain version at (c)'s first group and at head_dim 128. On the
    card the kernel reads what this emulation reads to within 0.05 of
    the limit (tests/test_torch_gpu.py::test_tf32_forward_reads_as_modelled)."""
    (q, k, v, scale), (out, lse) = tf32_forward_at(name)
    want, want_lse = flash_attention_reference(q, k, v, causal=True,
                                               sm_scale=scale)
    assert _f32_limit_use(out, want) <= 1
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL


def test_3xtf32_forward_holds_the_f32_limit_against_pallas():
    """At (c)'s first group the same holds against JAX's Pallas forward
    run in interpret mode, its lse taken as m + log(l) from the
    residuals its custom_vjp saves. The Pallas kernel takes a key length
    that 128 divides, so K and V are padded with zero keys to 1024: every
    query row below 1000 has them masked by causality, and rows past
    1000 are dropped."""
    (q, k, v, scale), (out, lse) = tf32_forward_at("c")
    seq, pad = q.shape[2], 1024

    def padded(x):
        x = np.repeat(x.numpy(), q.shape[1] // x.shape[1], axis=1)
        return jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, pad - seq),
                                      (0, 0))))

    sizes = pallas_fa.BlockSizes.get_default(1, q.shape[1], pad, pad,
                                             q.shape[3])
    with pltpu.force_tpu_interpret_mode():
        want, l, m = pallas_fa._flash_attention(
            padded(q), padded(k), padded(v), None, None, True, True, scale,
            sizes, False)
    want = torch.from_numpy(np.array(want)[:, :, :seq])
    want_lse = torch.from_numpy(np.array(m + jnp.log(l))[:, :, :seq])
    assert _f32_limit_use(out, want) <= 1
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("single", ["s", "pv"])
def test_f32_limit_rejects_a_single_tf32_product_in_the_forward(single):
    """One TF32 product in place of three, in S = Q K^T or in P V, puts
    the forward's out more than 10x beyond the f32 limit at (c)'s first
    group: the limit tells the 3xTF32 forward from that fault."""
    (q, k, v, scale), (out, _) = tf32_forward_at("c", single)
    want, _ = flash_attention_reference(q, k, v, causal=True, sm_scale=scale)
    assert _f32_limit_use(out, want) > 10


#: ptxas's report of one kernel instance, as the build phase reads it
PTXAS_BLOCK = """ for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, 16 bytes smem
"""
#: mangled names of backward instances as nvcc 12.9 emits them
BWD_PREFIX = "_ZN55_GLOBAL__N__f030bcd0_22_flash_attention_bwd_cu_6b12611e"
BWD_INSTANCES = [
    (f"{BWD_PREFIX}25flash_bwd_dkv_tf32_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_"
     "PS1_S6_PfPiiiiiiiff", "flash_bwd_dkv_tf32_kernel", "float32", 128, 253),
    (f"{BWD_PREFIX}24flash_bwd_dq_tf32_kernelI13__nv_bfloat16Li16EEEvPKT_S4_"
     "S4_S4_PKfS6_PS2_iiiiiiff", "flash_bwd_dq_tf32_kernel", "bfloat16", 16,
     106),
    (f"{BWD_PREFIX}4sm9026flash_bwd_dkv_wgmma_kernelILi64EEEv14CUtensorMap_st"
     "S2_S2_S2_PKfS4_P13__nv_bfloat16S6_iiiiiff",
     "flash_bwd_dkv_wgmma_kernel", "bfloat16", 64, 168),
]


#: mangled names of forward instances, as nvcc 12.9 would emit them
FWD_PREFIX = "_ZN55_GLOBAL__N__0c5bd3a1_22_flash_attention_fwd_cu_6b12611e"
FWD_INSTANCES = [
    (f"{FWD_PREFIX}21flash_fwd_tf32_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiiiiiif",
     "flash_fwd_tf32_kernel", "float32", 128, 168),
    (f"{FWD_PREFIX}21flash_fwd_tf32_kernelI13__nv_bfloat16Li16EEEvPKT_S4_S4_"
     "PS2_Pfiiiiiif", "flash_fwd_tf32_kernel", "bfloat16", 16, 90),
    (f"{FWD_PREFIX}4sm9022flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS2_"
     "S2_P13__nv_bfloat16Pfiiiiif", "flash_fwd_wgmma_kernel", "bfloat16",
     128, 168),
]


def _check_build_phase(monkeypatch, capsys, source, instances):
    """The build phase names each flash instance of ``source`` by its
    template (the 3xTF32 kernels' names hold digits), dtype and head_dim,
    and phases 3 and 3b find its registers and spills by them."""
    report = "".join("Compiling entry function" + PTXAS_BLOCK.format(
        name=name, spill=0, regs=regs)
        for name, _, _, _, regs in instances)

    class Built:
        ptxas_report, build_seconds = report, 1.0

    monkeypatch.setattr(chip_smoke, "SOURCES", [source])
    monkeypatch.setattr(chip_smoke._build, "build_all",
                        lambda sources: [Built()])
    monkeypatch.setattr(chip_smoke, "BUILT_INSTANCES", {})
    monkeypatch.setattr(
        chip_smoke, "kernel_design",
        lambda name, dtype, dim: {
            "design": "sm90 wgmma" if dtype == torch.bfloat16 and dim >= 64
            else chip_smoke.TF32_DESIGN, "dynamic_smem_bytes": 0})
    chip_smoke.phase_build()
    capsys.readouterr()
    for _, kernel, dtype, dim, regs in instances:
        design = ("sm90 wgmma" if "wgmma" in kernel
                  else chip_smoke.TF32_DESIGN)
        if "fwd" in kernel:
            assert chip_smoke.fwd_template(design) == kernel
        else:
            which = "dkv" if "dkv" in kernel else "dq"
            assert chip_smoke.bwd_template(which, design) == kernel
        assert chip_smoke.instance_ptxas(
            source, kernel, dtype=dtype,
            head_dim=dim) == {"registers": regs, "spill_store_bytes": 0,
                              "stack_bytes": 0}


def test_build_phase_reads_the_backward_instances(monkeypatch, capsys):
    _check_build_phase(monkeypatch, capsys, "flash_attention_bwd.cu",
                       BWD_INSTANCES)


def test_build_phase_reads_the_forward_instances(monkeypatch, capsys):
    _check_build_phase(monkeypatch, capsys, "flash_attention_fwd.cu",
                       FWD_INSTANCES)


def test_backward_rows_report_the_tensor_core_bound_and_the_grid(
        monkeypatch):
    """Phase 3b's f32 rows of the 3xTF32 design hold the f32 CUDA-core
    bound as bound_ms and three TF32 products for each at 495 TFLOP/s
    beside it, which their share uses; their ``blocks`` is each launch's
    grid as torch.profiler's trace records it (here a trace written as
    the profiler writes one), the product of its three sizes."""
    shape = (2, 8, 2, 1000, 64, torch.float32)
    kv = 2 * 2 * 1000 * 64
    tf32 = chip_smoke.backward_bounds(4, 0.1, chip_smoke.TF32_DESIGN,
                                      *shape, outputs=[kv, kv], causal=True)
    flops = 4 * 2 * 64 * 2 * 8 * chip_smoke.visible_pairs(1000, 1000)
    assert tf32["bound_by"] == tf32["bound_3xtf32_by"] == "operations"
    assert math.isclose(tf32["bound_ms"], flops / 67e12 * 1e3)
    assert math.isclose(tf32["bound_3xtf32_ms"], 3 * flops / 495e12 * 1e3)
    assert tf32["bound_share_uses"] == "bound_3xtf32_ms"
    assert math.isclose(tf32["bound_share"], tf32["bound_3xtf32_ms"] / 0.1)
    wgmma = chip_smoke.backward_bounds(
        4, 0.1, "sm90 wgmma", 2, 8, 2, 1000, 128, torch.bfloat16,
        outputs=[2 * kv, 2 * kv], causal=True)
    assert "bound_3xtf32_ms" not in wgmma
    assert wgmma["bound_share_uses"] == "bound_ms"
    trace = [
        {"ph": "X", "cat": "kernel", "args": {"grid": [256, 1, 1]},
         "name": "void (anonymous namespace)::flash_bwd_dkv_tf32_kernel"
                 "<float, 64>(float const*, ...)"},
        {"ph": "X", "cat": "kernel", "args": {"grid": [8, 2, 2]},
         "name": "void (anonymous namespace)::flash_bwd_dq_tf32_kernel"
                 "<float, 64>(float const*, ...)"},
        {"ph": "X", "cat": "cpu_op", "args": {},
         "name": "flash_bwd_dkv_tf32_kernel"},
        {"ph": "X", "cat": "gpu_memset", "args": {}, "name": "Memset"},
    ]
    sessions = []

    class Profile:
        def __init__(self, activities):
            sessions.append(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": trace}))

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    kernels = ["flash_bwd_dkv_tf32_kernel", "flash_bwd_dq_tf32_kernel"]
    assert chip_smoke.launched_blocks(lambda: calls.append(1), kernels) \
        == {kernels[0]: [256], kernels[1]: [32]}
    assert len(sessions) == 1 and len(calls) == 2  # a warm-up call first
    # a session that lost a kernel's record is run again, and after
    # MAX_PROFILE_SESSIONS of them the grids are unknown
    del trace[1]
    sessions.clear()
    assert chip_smoke.launched_blocks(lambda: None, kernels) == {}
    assert len(sessions) == chip_smoke.MAX_PROFILE_SESSIONS


def test_forward_rows_report_the_tensor_core_bound():
    """Phase 3's f32 rows of the 3xTF32 design hold the f32 CUDA-core
    bound of the forward's two products as bound_ms and three TF32
    products for each at 495 TFLOP/s beside it, which their share uses;
    the wgmma rows have no such bound."""
    shape = (2, 8, 2, 1000, 1000, 64, torch.float32)
    flops = 2 * 2 * 64 * 2 * 8 * chip_smoke.visible_pairs(1000, 1000)
    tf32 = chip_smoke.forward_bounds(0.05, chip_smoke.TF32_DESIGN, *shape,
                                     causal=True)
    assert tf32["bound_by"] == tf32["bound_3xtf32_by"] == "operations"
    assert math.isclose(tf32["bound_ms"], flops / 67e12 * 1e3)
    assert math.isclose(tf32["bound_3xtf32_ms"], 3 * flops / 495e12 * 1e3)
    assert tf32["bound_share_uses"] == "bound_3xtf32_ms"
    assert math.isclose(tf32["bound_share"], tf32["bound_3xtf32_ms"] / 0.05)
    assert math.isclose(
        tf32["bound_ms"], chip_smoke.attention_bound_ms(*shape)[0])
    wgmma = chip_smoke.forward_bounds(
        0.05, "sm90 wgmma", 2, 8, 2, 1000, 1000, 128, torch.bfloat16,
        causal=False)
    assert "bound_3xtf32_ms" not in wgmma
    assert wgmma["bound_share_uses"] == "bound_ms"


def test_backward_grids_come_from_a_process_of_their_own(monkeypatch,
                                                         capsys):
    """Phase 3b reads the backward's grids in a child process,
    ``chip_smoke.py --backward-grids SPEC``, whose last line is the
    grids by label; main answers that argument before it touches the
    card."""
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout='built\n{"c": {"dkv": 256, "dq": 256}}\n',
            stderr="")

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    grids = chip_smoke.measure_backward_grids(
        [("c", 2, 8, 2, 1000, 64, torch.float32, True)])
    assert grids == {"c": {"dkv": 256, "dq": 256}}
    (cmd,) = calls
    assert cmd[1].endswith("chip_smoke.py") and cmd[2] == "--backward-grids"
    assert json.loads(cmd[3]) == [["c", 2, 8, 2, 1000, 64, "float32", True]]
    spec = []
    monkeypatch.setattr(chip_smoke, "backward_grids",
                        lambda s: spec.append(s) or {"c": None})
    monkeypatch.setattr(chip_smoke, "phase_device", None)  # not reached
    assert chip_smoke.main(["--backward-grids", cmd[3]]) == 0
    assert spec == [json.loads(cmd[3])]
    assert capsys.readouterr().out == '{"c": null}\n'


def test_variants_script_exits_without_cuda(capsys):
    assert fbv.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_lse_is_the_log_sum_exp_of_the_masked_scores():
    q, k, v = _inputs(3, 1, 2, 1, 40, 16)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_forward(qt, kt, vt, causal=True, sm_scale=0.25)
    kf = np.repeat(k, 2, axis=1).astype(np.float64)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kf) * 0.25
    scores = np.where(np.tril(np.ones((40, 40), bool)), scores, -np.inf)
    want = np.log(np.exp(scores).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    # row 0 sees key 0 only: its output is v[0] exactly
    np.testing.assert_allclose(out.numpy()[:, :, 0], v[:, [0, 0], 0],
                               rtol=0, atol=1e-6)


def test_non_causal_matches_sdpa():
    q, k, v = _inputs(4, 2, 2, 2, 33, 32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got, _ = flash_attention_reference(qt, kt, vt, causal=False,
                                       sm_scale=32 ** -0.5)
    want = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class TestWrapperContract:
    def test_cpu_tensor_takes_plain_path_without_counting(self):
        q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 2, 2, 17,
                                                         16))
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=True, sm_scale=0.25)
        want, _ = flash_attention_reference(q, k, v, causal=True,
                                            sm_scale=0.25)
        assert torch.equal(got, want)
        assert flash_attention.launches == before

    def test_bf16_output_keeps_the_input_dtype(self):
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(6, 1, 2, 2, 9, 16))
        got = flash_attention(q, k, v, causal=True, sm_scale=0.25)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_backward_through_autograd_is_the_plain_backward(self, dtype):
        """torch.autograd.grad through flash_attention (GQA, a ragged
        length, an output gradient that is not contiguous) equals the
        plain backward on the forward's saved out and lse, and launches
        nothing on the CPU."""
        q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
                   for x in _inputs(7, 2, 4, 2, 37, 16))
        do = torch.randn((2, 37, 4, 16), generator=torch.Generator()
                         .manual_seed(9)).to(dtype).transpose(1, 2)
        before = (flash_attention.launches, flash_attention_bwd_dkv.launches,
                  flash_attention_bwd_dq.launches)
        out = flash_attention(q, k, v, causal=True, sm_scale=0.25)
        got = torch.autograd.grad(out, (q, k, v), do)
        ref_out, lse = flash_forward(q.detach(), k.detach(), v.detach(),
                                     causal=True, sm_scale=0.25)
        want = flash_attention_backward_reference(
            q.detach(), k.detach(), v.detach(), ref_out, lse,
            do.contiguous(), causal=True, sm_scale=0.25)
        for g, w, x in zip(got, want, (q, k, v)):
            assert g.dtype == dtype and g.shape == x.shape
            assert torch.equal(g, w)
        assert (flash_attention.launches, flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches) == before

    def test_plain_backward_is_autograd_of_the_plain_forward(self):
        q, k, v = (torch.from_numpy(x).double().requires_grad_()
                   for x in _inputs(10, 1, 4, 2, 29, 32))
        do = torch.randn(q.shape, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(0))
        scores = torch.einsum(
            "bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1)) * 0.2
        scores = scores.masked_fill(
            ~torch.ones(29, 29, dtype=torch.bool).tril(), float("-inf"))
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1),
                           v.repeat_interleave(2, dim=1))
        want = torch.autograd.grad(out, (q, k, v), do)
        f32 = [t.detach().float() for t in (q, k, v)]
        o, lse = flash_forward(*f32, causal=True, sm_scale=0.2)
        got = flash_backward(*f32, o, lse, do.float(), causal=True,
                             sm_scale=0.2)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w.float(), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("case", ["o_shape", "do_dtype", "lse_dtype",
                                      "lse_shape", "do_strided"])
    def test_backward_rejects_what_the_kernels_do_not_take(self, case):
        q, k, v = (torch.from_numpy(x) for x in _inputs(11, 1, 4, 2, 8,
                                                         16))
        o, lse = flash_forward(q, k, v, causal=True, sm_scale=0.25)
        do = torch.ones_like(o)
        if case == "o_shape":
            o = o[:, :2].contiguous()
        elif case == "do_dtype":
            do = do.to(torch.bfloat16)
        elif case == "lse_dtype":
            lse = lse.double()
        elif case == "lse_shape":
            lse = lse[..., :4].contiguous()
        elif case == "do_strided":
            do = torch.ones(1, 4, 16, 8).transpose(2, 3)
        with pytest.raises(ValueError):
            flash_backward(q, k, v, o, lse, do, causal=True, sm_scale=0.25)

    def test_kernel_launchers_take_only_cuda_tensors(self):
        q, k, v = (torch.from_numpy(x) for x in _inputs(12, 1, 2, 2, 8,
                                                         16))
        lse = di = torch.zeros(1, 2, 8)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_bwd_dkv(q, k, v, q, lse, di, causal=True,
                                    sm_scale=0.25)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_bwd_dq(q, k, v, q, lse, di, causal=True,
                                   sm_scale=0.25)

    @pytest.mark.parametrize("case", [
        "dtype", "head_dim", "rank", "kv_heads", "contiguity", "mixed",
    ])
    def test_rejects_what_the_kernel_does_not_take(self, case):
        q, k, v = (torch.from_numpy(x) for x in _inputs(8, 1, 4, 2, 8,
                                                         16))
        if case == "dtype":
            q, k, v = q.half(), k.half(), v.half()
        elif case == "head_dim":
            q, k, v = q[..., :8].contiguous(), k[..., :8].contiguous(), \
                v[..., :8].contiguous()
        elif case == "rank":
            q = q[0]
        elif case == "kv_heads":
            k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
        elif case == "contiguity":
            q = q.transpose(1, 2)
        elif case == "mixed":
            k = k.double()
        with pytest.raises(ValueError):
            flash_attention(q, k, v, causal=True, sm_scale=0.25)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "tpu_operator_libs_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 5
    offenders = []
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "tpu_operator_libs", "optax",
                       "orbax"):
                offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert offenders == []

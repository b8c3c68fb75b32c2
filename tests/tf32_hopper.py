"""The float32 flash forward's and backward's 3xTF32 kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu`` over
``csrc/tf32_mma.cuh``) emulated in plain PyTorch on the CPU, with the
tensor cores' own accumulation. Imports nothing of JAX, so the card's
tests (``tests/test_torch_gpu.py``) take it too.

One ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` on an H100
computes d = c + sum_k a_k b_k over its 8 values of k as :func:`mma` does:

- each operand's low 13 bits are dropped (a TF32 operand is cut, not
  rounded);
- c and each product a_k b_k (exact) are cut toward zero to a multiple of
  2^(e - 25), where e is the largest of c's exponent and the products'
  exponents, a product's taken as e(a_k) + e(b_k), with e(x) =
  floor(log2 |x|);
- their sum is rounded toward zero to f32.

``test_tf32_mma_accumulates_as_modelled`` in ``tests/test_torch_gpu.py``
holds this bit for bit to the card's mma on random inputs. Each step
rounds toward zero, so a long f32 sum shrinks by some half an ulp a step:
the kernels' dK, dV and dQ, each a sum over the sequence of three such
steps every 8 rows, take more of the f32 limit than the same products
summed with rounding to nearest; the forward's O, rescaled as the row
max moves, sums its P V steps the same way.
"""

from __future__ import annotations

import math

import torch

LOG2E = math.log2(math.e)
#: the f32 values of csrc/flash_attention_common.cuh's kLog2e and kLn2
KLOG2E = torch.tensor(LOG2E, dtype=torch.float32).item()
KLN2 = torch.tensor(math.log(2.0), dtype=torch.float32).item()
#: the kernels' rows a block owns and streams, and a warp's half of them
ROWS, HALF = 64, 32


def tf32_hi(x):
    """x rounded to TF32 (10 mantissa bits, ties away from zero), as the
    kernels round a hi word by an integer add and mask."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """x as the tensor cores read a TF32 operand: its low 13 bits
    dropped."""
    return (x.float().contiguous().view(torch.int32) & -0x2000) \
        .view(torch.float32)


def split(x):
    """x as the kernels' hi and lo words: hi = x rounded to TF32, lo =
    x - hi (as the tensor cores read it)."""
    hi = tf32_hi(x)
    return hi, tf32_cut(x - hi)


def _exponent(x):
    """floor(log2 |x|) of a float64 tensor, -2000 for 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.full_like(e, -2000), e - 1)


def round_toward_zero(x):
    """float64 ``x`` rounded toward zero to float32."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma(c, a, b):
    """One tensor-core step, c + a @ b, for f32 c (..., M, N), a (..., M,
    k) and b (..., k, N) with k <= 8, as the module's header sets out."""
    a, b, c = tf32_cut(a).double(), tf32_cut(b).double(), c.double()
    products = a[..., :, :, None] * b[..., None, :, :]  # (..., M, k, N)
    exps = _exponent(a)[..., :, :, None] + _exponent(b)[..., None, :, :]
    top = torch.maximum(exps.amax(-2), _exponent(c)).clamp(min=-1000)
    unit = torch.ldexp(torch.ones_like(c), top - 25)
    cut = torch.trunc(products / unit[..., None, :]).sum(-2) \
        + torch.trunc(c / unit)
    return round_toward_zero(cut * unit)


def mma3(c, a, b):
    """c + a @ b as the kernels' mma3: the split words' a_lo b_hi, then
    a_hi b_lo, then a_hi b_hi, each a tensor-core step; ``a`` and ``b``
    are :func:`split` pairs."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    c = mma(c, a_lo, b_hi)
    c = mma(c, a_hi, b_lo)
    return mma(c, a_hi, b_hi)


def product(a, b, chunks):
    """a (..., M, K) @ b (..., K, N) from 0 by :func:`mma3` over the
    slices of K in ``chunks``, in their order."""
    a, b = split(a), split(b)
    c = torch.zeros(*a[0].shape[:-1], b[0].shape[-1])
    for ks in chunks:
        c = mma3(c, tuple(x[..., ks] for x in a),
                 tuple(x[..., ks, :] for x in b))
    return c


def depth_chunks(depth):
    """The first products' order: head_dim by 8 from 0."""
    return [slice(i, min(i + 8, depth)) for i in range(0, depth, 8)]


def half_chunks(rows, side):
    """The second products' order for a warp of ``side`` (0 or 1): its
    half of each 64-row tile, by 8 rows, tile by tile."""
    return [slice(s, min(s + 8, rows))
            for t0 in range(0, rows, ROWS)
            for s in range(t0 + HALF * side, t0 + HALF * (side + 1), 8)
            if s < rows]


def _probabilities(scores, lse, scale, visible):
    """exp2f(fmaf(S, scale_log2, -lse * log2e)) where visible, else 0
    (the fma exact, then rounded once)."""
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * KLOG2E
    shift = (lse.float() * KLOG2E).double()
    arg = (scores.double() * scale_log2.double() - shift).float()
    return torch.where(visible, torch.exp2(arg), torch.zeros(()))


def tf32_backward(q, k, v, do, lse, di, sm_scale, causal=True):
    """(dq, dk, dv) of f32 inputs as the 3xTF32 kernels compute them:
    each product by :func:`product` in the kernels' order, P and dS in
    f32 on the products, the two warps' halves of each sum added at the
    end, a GQA group's dK and dV partials added in head order and dK and
    dQ scaled last."""
    batch, heads, sq, dim = q.shape
    kv_heads, sk = k.shape[1], k.shape[2]
    group = heads // kv_heads
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    q, do, lse, di = q.float(), do.float(), lse.float(), di.float()
    scale = torch.tensor(sm_scale, dtype=torch.float32).item()
    visible = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        visible = visible.tril()
    depth = depth_chunks(dim)

    # dK/dV: keys as rows, S^T = K Q^T and dP^T = V dO^T
    pt = _probabilities(product(kf, q.transpose(-1, -2), depth),
                        lse[:, :, None, :], scale, visible.T)
    dst = pt * (product(vf, do.transpose(-1, -2), depth)
                - di[:, :, None, :])
    grads = {}
    for name, a, b in (("dk", dst, q), ("dv", pt, do)):
        halves = [product(a, b, half_chunks(sq, side)) for side in (0, 1)]
        heads_sum = (halves[0] + halves[1]).reshape(batch, kv_heads, group,
                                                    sk, dim)
        total = heads_sum[:, :, 0]
        for g in range(1, group):
            total = total + heads_sum[:, :, g]
        grads[name] = total * scale if name == "dk" else total

    # dQ: queries as rows, S = Q K^T and dP = dO V^T
    p = _probabilities(product(q, kf.transpose(-1, -2), depth),
                       lse[..., None], scale, visible)
    ds = p * (product(do, vf.transpose(-1, -2), depth) - di[..., None])
    halves = [product(ds, kf, half_chunks(sk, side)) for side in (0, 1)]
    return (halves[0] + halves[1]) * scale, grads["dk"], grads["dv"]


def _step(c, a, b, products):
    """c + a @ b as one tensor-core step of each TF32 product: three
    (:func:`mma3` of the split words) or, a fault, one (a_hi b_hi)."""
    if products == 3:
        return mma3(c, split(a), split(b))
    return mma(c, tf32_hi(a), tf32_hi(b))


def tf32_forward(q, k, v, sm_scale, causal=True, single=None):
    """(out, lse) of f32 inputs as the 3xTF32 forward kernel computes
    them. Each 64-key tile is cut into the two warps' halves of 32 keys;
    a half whose keys all lie after a row is not visited for it (the
    kernel's warps skip it), and every row that visits a half sees its
    first key. Per half: S = Q K^T by tensor-core steps over head_dim by
    8, times scale_log2 in f32, masked to -inf; the half's running max
    m, sum l and accumulator take the online softmax in f32 (alpha =
    exp2(m - m_new), P = exp2(S - m_new)); then acc * alpha and P V by
    steps over the half's keys by 8. The two halves' (m, l, acc) are
    merged at the end, O = acc / l and lse = (m + log2 l) ln 2.
    ``single`` ("s" or "pv") runs that product as one TF32 product, a
    fault the f32 limit has to catch."""
    batch, heads, sq, dim = q.shape
    sk = k.shape[2]
    group = heads // k.shape[1]
    q = q.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    scale_log2 = (torch.tensor(sm_scale, dtype=torch.float32)
                  * torch.tensor(KLOG2E, dtype=torch.float32))
    s_products = 1 if single == "s" else 3
    pv_products = 1 if single == "pv" else 3
    halves = []
    for side in (0, 1):
        m = torch.full((batch, heads, sq), float("-inf"))
        l = torch.zeros(batch, heads, sq)
        acc = torch.zeros(batch, heads, sq, dim)
        for c0 in range(HALF * side, sk, ROWS):
            keys = torch.arange(c0, min(c0 + HALF, sk))
            r0 = c0 if causal else 0  # the rows that visit the half
            if r0 >= sq:
                break
            rows = torch.arange(r0, sq)
            sc = torch.zeros(batch, heads, sq - r0, len(keys))
            for ks in depth_chunks(dim):
                sc = _step(sc, q[:, :, r0:, ks],
                           kf[:, :, keys][..., ks].transpose(-1, -2),
                           s_products)
            x = sc * scale_log2
            if causal:
                x = x.masked_fill(keys[None] > rows[:, None], float("-inf"))
            m_new = torch.maximum(m[..., r0:], x.amax(-1))
            alpha = torch.exp2(m[..., r0:] - m_new)
            p = torch.exp2(x - m_new[..., None])
            l[..., r0:] = l[..., r0:] * alpha + p.sum(-1)
            m[..., r0:] = m_new
            o = acc[..., r0:, :] * alpha[..., None]
            for j in range(0, len(keys), 8):
                o = _step(o, p[..., j:j + 8], vf[:, :, keys[j:j + 8]],
                          pv_products)
            acc[..., r0:, :] = o
        halves.append((m, l, acc))
    (m0, l0, acc0), (m1, l1, acc1) = halves
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    l = l0 * a0 + l1 * a1
    out = (acc0 * a0[..., None] + acc1 * a1[..., None]) \
        * (1.0 / l)[..., None]
    return out, (m + torch.log2(l)) * KLN2

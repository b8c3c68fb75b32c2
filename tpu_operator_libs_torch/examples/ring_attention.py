"""Ring attention: self-attention with the sequence sharded over the sp
ranks, K/V blocks rotating round the ring.

Mirrors ``tpu_operator_libs/examples/ring_attention.py``:
``_block_attention``, ``ring_attention``, ``make_ring_attention`` and
``dense_reference``. Each rank holds one block of Q/K/V; over ``sp``
steps, step ``i`` sees the K/V block of rank ``(me - i) % sp`` and folds
its attention into the rank's running state, then the K/V pass one hop
on (``parallel.ring_hop``; the reference's ``ppermute``). Only the narrow
GQA K/V travel: the kernels read them as they are.

A block is one launch of the flash forward kernel
(``kernels/flash_attention.py::flash_forward``), which returns its
output and log-sum-exp: causal on the diagonal block, unmasked on a block
strictly in the past, skipped for a block in the future. The blocks are
contiguous and of equal length, so the diagonal block's mask is the
kernel's own (query i sees keys <= i). The block's ``(out, lse)`` is
folded into the state ``(acc, lse)`` by the fold kernel
(``kernels/attention_fold.py``), starting from ``acc = 0``, ``lse =
-inf`` as the reference starts from ``m = -inf``. On the CPU both are
their plain versions.

The backward (:class:`_RingAttention`) is a second ring: ``(k, v, dk,
dv)`` travel together, each visible block launches the dK/dV and dQ
kernels with the GLOBAL lse and ``di = rowsum(out * dout)`` of the final
output, computed once, and dK/dV accumulate in float32 and reach the
rank that owns them after the ``sp``-th hop.
"""

from __future__ import annotations

import torch

from tpu_operator_libs_torch.kernels.attention_fold import attention_fold
from tpu_operator_libs_torch.kernels.flash_attention import (
    _check_backward_inputs,
    _check_inputs,
    flash_attention_backward_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_forward,
)
from tpu_operator_libs_torch.parallel import gather_axis, local_seq, ring_hop


def _schedule(me: int, n: int, causal: bool):
    """(step, source block, block causal or None when skipped) for the
    ``n`` steps of rank ``me``: the reference's ``src = (me - i) % n``."""
    for i in range(n):
        src = (me - i) % n
        if causal and src > me:
            yield i, src, None          # in the future: contributes nothing
        else:
            yield i, src, causal and src == me


def _block_attention(q, k, v, acc, lse, causal: bool, sm_scale: float):
    """Fold one K/V block into the state ``(acc, lse)`` in place. Kernel
    layout: q (B, H, Sq, D), k/v (B, H_kv, Sk, D); ``acc`` (B, H, Sq, D)
    and ``lse`` (B, H, Sq) float32. ``causal``: the diagonal block's
    mask."""
    out, lse_blk = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)
    attention_fold(acc, lse, out, lse_blk)


def _block_backward(q, k, v, out, lse, do, di, causal: bool,
                    sm_scale: float):
    """(dq, dk, dv) of one visible block given the global ``lse`` and
    ``di``: the two kernels on the card, the plain version on the CPU
    (which takes ``di`` from ``out`` and ``do``, the same rows)."""
    if q.device.type == "cuda":
        kw = {"causal": causal, "sm_scale": sm_scale}
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
        return flash_attention_bwd_dq(q, k, v, do, lse, di, **kw), dk, dv
    return flash_attention_backward_reference(q, k, v, out, lse, do,
                                              causal=causal,
                                              sm_scale=sm_scale)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, sm_scale):
        n, me, _ = mesh.axis(axis_name)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                         device=q.device)
        k_cur, v_cur = k, v
        for i, _, block_causal in _schedule(me, n, causal):
            if block_causal is not None:
                _block_attention(q, k_cur, v_cur, acc, lse, block_causal,
                                 sm_scale)
            if i < n - 1:
                # every rank joins every hop, also after a skipped block
                k_cur, v_cur = ring_hop([k_cur, v_cur], mesh, axis_name)
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis_name = mesh, axis_name
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        n, me, _ = ctx.mesh.axis(ctx.axis_name)
        do = grad_out.contiguous()
        _check_backward_inputs(q, k, v, out, lse, do)
        di = (out.float() * do.float()).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for i, _, block_causal in _schedule(me, n, ctx.causal):
            if block_causal is not None:
                parts = _block_backward(q, k_cur, v_cur, out, lse, do, di,
                                        block_causal, ctx.sm_scale)
                for acc, part in zip((dq, dk, dv), parts):
                    acc.add_(part.float())
            # dK/dV ride with their K/V; the last hop brings them home
            if i < n - 1:
                k_cur, v_cur, dk, dv = ring_hop([k_cur, v_cur, dk, dv],
                                                ctx.mesh, ctx.axis_name)
            else:
                dk, dv = ring_hop([dk, dv], ctx.mesh, ctx.axis_name)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, mesh, causal: bool = True,
                   axis_name: str = "sp"):
    """Blockwise ring attention on this rank: q (B, S_local, H, D) and
    k/v (B, S_local, H_kv, D), this rank's block of a sequence sharded
    over the mesh axis ``axis_name``. Returns the block's attention
    output (B, S_local, H, D) in q's dtype; differentiable (the second
    ring). Every rank of the axis must call it together."""
    if q.dim() != 4 or k.shape[:2] != q.shape[:2] or k.shape != v.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "must be (B, S_local, H, D) blocks of one length")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    _check_inputs(qt, kt, vt)
    out = _RingAttention.apply(qt, kt, vt, mesh, axis_name, causal,
                               q.shape[-1] ** -0.5)
    return out.transpose(1, 2)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = True):
    """The run-ranks counterpart of the reference's jitted ``shard_map``:
    ``(q, k, v) -> out`` on global (B, S, H, D) tensors that every rank
    of the axis passes whole; each rank attends its sequence block and
    the blocks are gathered, so every rank returns the whole output."""
    size = mesh.axis(axis_name)[0]

    def run(q, k, v):
        if q.shape[1] % size:
            raise ValueError(f"sequence {q.shape[1]} must divide over "
                             f"{axis_name}={size}")
        blocks = [local_seq(x.to(mesh.device), mesh, axis_name)
                  for x in (q, k, v)]
        out = ring_attention(*blocks, mesh, causal, axis_name)
        return gather_axis(out, mesh, axis_name, dim=1)

    return run


def dense_reference(q, k, v, causal: bool = True):
    """Unsharded exact attention for verification: float32 scores and
    softmax, a -inf causal mask, the output in q's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (q.shape[-1] ** -0.5)
    if causal:
        seq = q.shape[1]
        mask = torch.ones(seq, seq, dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v.float()).to(q.dtype)

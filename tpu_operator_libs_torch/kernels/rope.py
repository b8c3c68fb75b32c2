"""RoPE of a layer's queries and keys in the batch forward, and its
gradient.

Mirrors ``tpu_operator_libs/examples/llama.py::_rope`` (``:117-136``),
called on q and k at ``:280``, and its gradient through ``jax.grad``,
which XLA fuses on the TPU (no Pallas source): a half-split rotation (not
interleaved) of the last axis by the float32 angles ``position * theta **
(-i / half)``.

:func:`rope_qk` rotates one layer's q and k in one launch of
``csrc/rope.cu`` for CUDA tensors, in their layout (B, S, heads, D) or,
with ``head_major``, into the (B, heads, S, D) that the flash kernels
read, copying v there beside them; it runs the plain version,
:func:`rope_reference` (the port's ``_rope``), for CPU tensors. When a
gradient is wanted it goes through an autograd Function that saves only
the positions: its backward, :func:`rope_bwd`, recomputes the angles and
takes the gradients back to the input layout in one launch
(:func:`rope_backward_reference` on the CPU). Kernels and plain versions
write the same bits: every product, sum and difference is rounded on its
own, with the same ``cosf`` / ``sinf``, and the backward rounds where
autograd rounds through :func:`rope_reference`. The frequencies live on
the card, made once a (theta, head_dim, device) by ``rope_freqs``; the
decode step's rotating cache write (``kernels/kv_append.py``) reads them
too.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpu_operator_libs_torch.kernels._build import load, raise_on, sm_count

#: the CUDA source under ``csrc/``
SOURCE = "rope.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the threads an H100 SM holds at once: the grid's head groups aim at
#: filling every SM
THREADS_PER_SM = 2048
_lib = None
#: the rotation's frequencies on the card by (theta, head_dim, device),
#: made at a call's first eager launch and kept (a captured launch reads
#: them in place)
_freqs = {}
_freqs_lock = threading.Lock()


def rope_freqs(theta: float, head_dim: int, device):
    """RoPE's (head_dim // 2,) float32 frequencies, ``theta ** (-i /
    half)``: the expression of the reference's ``_rope``
    (``tpu_operator_libs/examples/llama.py:128``)."""
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _cos_sin(x, theta: float, positions):
    """The (1, S, 1, half) float32 cosines and sines of ``x``'s angles."""
    _, seq, _, head_dim = x.shape
    freqs = rope_freqs(theta, head_dim, x.device)
    if positions is None:
        positions = torch.arange(seq, dtype=torch.float32, device=x.device)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return (torch.cos(angles)[None, :, None, :],
            torch.sin(angles)[None, :, None, :])


def rope_reference(x, theta: float, positions=None):
    """Rotary position embedding over the last axis of (B, S, H, D):
    a half-split rotation (not interleaved) with f32 frequencies.

    ``positions`` (S,) overrides the default 0..S-1 — decode steps pass
    the absolute position so a cached token rotates identically whether
    it arrived via prefill or one step at a time."""
    half = x.shape[-1] // 2
    cos, sin = _cos_sin(x, theta, positions)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope_backward_reference(dy, theta: float, positions=None):
    """The gradient of :func:`rope_reference` from ``dy`` (B, S, H, D),
    with autograd's roundings: ``dy`` in float32 times cos and sin, each
    product rounded to ``dy``'s dtype (as autograd casts each use's
    gradient to the input's), then ``dx1 = dy1 cos + dy2 sin`` and ``dx2
    = dy2 cos - dy1 sin`` in the dtype, then ``+ 0``: autograd adds the
    two half-slices' gradients into zeros, which turns -0 into +0."""
    half = dy.shape[-1] // 2
    cos, sin = _cos_sin(dy, theta, positions)
    g = dy.float()
    g1, g2 = g[..., :half], g[..., half:]
    dtype = dy.dtype
    dx1 = (g1 * cos).to(dtype) + (g2 * sin).to(dtype)
    dx2 = (g2 * cos).to(dtype) - (g1 * sin).to(dtype)
    return torch.cat([dx1, dx2], dim=-1) + 0


def _plain(q, k, v, theta, positions, head_major):
    out = [rope_reference(q, theta, positions),
           rope_reference(k, theta, positions)]
    if head_major:
        out = [t.transpose(1, 2).contiguous()
               for t in out + ([] if v is None else [v])]
    return tuple(out)


def _plain_backward(dq, dk, dv, theta, positions, head_major):
    if head_major:
        dq, dk = dq.transpose(1, 2), dk.transpose(1, 2)
    out = (rope_backward_reference(dq, theta, positions),
           rope_backward_reference(dk, theta, positions))
    if dv is not None:
        out += (dv.transpose(1, 2).contiguous(),)
    return out


def _freqs_on(theta, head_dim, device):
    """``rope_freqs`` on ``device``, made once (eagerly) and kept: a
    captured launch holds its address."""
    key = (theta, head_dim, device)
    with _freqs_lock:
        freqs = _freqs.get(key)
        if freqs is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"RoPE's frequencies for theta={theta}, "
                    f"head_dim={head_dim} on {device} are made by an eager "
                    "call: launch it once before capturing")
            freqs = rope_freqs(theta, head_dim, device)
            # ready for launches on every stream of the device
            torch.cuda.synchronize(device)
            _freqs[key] = freqs
    return freqs


def _check(q, k, v, theta, positions, head_major) -> None:
    """q (B, S, H, D) and k (B, S, H_kv, D), v like k (only with
    ``head_major``), of one device and one dtype, float32 or bfloat16, D
    even; ``positions`` None or int64 (S,) on their device."""
    named = [("q", q), ("k", k)] + ([] if v is None else [("v", v)])
    if v is not None and not head_major:
        raise ValueError("v is copied into the head-major layout: pass "
                         "head_major=True with it")
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a (B, S, heads, D) tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} has dtype {t.dtype}; q, k and v take "
                             f"one dtype, float32 or bfloat16 (q: "
                             f"{q.dtype})")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or 0 in q.shape or 0 in k.shape:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         "be (B, S, H, D) and (B, S, H_kv, D)")
    if v is not None and v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} and k {tuple(k.shape)} differ")
    if q.shape[3] % 2:
        raise ValueError(f"head_dim {q.shape[3]} must be even")
    if isinstance(theta, bool) or not isinstance(theta, (int, float)) \
            or not theta > 0:
        raise ValueError(f"theta must be a number > 0, got {theta!r}")
    if positions is not None and (
            not isinstance(positions, torch.Tensor)
            or positions.dtype != torch.int64
            or positions.shape != q.shape[1:2]
            or positions.device != q.device):
        raise ValueError(f"positions must be None or an int64 "
                         f"({q.shape[1]},) tensor on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _check_contiguous(**named) -> None:
    """The kernels read contiguous tensors."""
    for name, t in named.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def vector_width(dim: int, *tensors) -> int:
    """Pairs a thread takes: 8, else 4, where half of ``dim`` divides
    into them and every buffer is aligned to them (16 bytes at most),
    else 1. The C entry checks it."""
    for vec in (8, 4):
        if (dim // 2) % vec == 0 and all(
                t.data_ptr() % min(16, vec * t.element_size()) == 0
                for t in tensors if t is not None):
            return vec
    return 1


def splits(tokens: int, dim: int, vec: int, heads: int, sms: int) -> int:
    """The grid's head groups: enough that ``tokens * dim / 2 / vec``
    threads a group fill ``sms`` SMs, at most one a head."""
    threads = tokens * (dim // 2 // vec)
    return max(1, min(heads, -(-sms * THREADS_PER_SM // threads)))


def _library():
    global _lib
    if _lib is None:
        entry = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        _lib = load(SOURCE, {"rope_qk": entry, "rope_qk_bwd": entry},
                    "rope_error_string")
    return _lib


def _launch(entry, inputs, theta, positions, head_major):
    """One launch of ``entry`` (``rope_qk`` or ``rope_qk_bwd``) from
    ``inputs`` (q, k, v or None, or their gradients); returns the outputs
    it wrote, in (B, S, heads, D) or (B, heads, S, D) as the entry
    writes."""
    q, k, v = inputs
    backward = entry == "rope_qk_bwd"
    if backward and head_major:
        batch, heads, seq, dim = q.shape
        kv_heads = k.shape[1]
    else:
        batch, seq, heads, dim = q.shape
        kv_heads = k.shape[2]

    def out_like(t, h):
        shape = (batch, h, seq, dim) if head_major and not backward \
            else (batch, seq, h, dim)
        return None if t is None else torch.empty(shape, dtype=t.dtype,
                                                  device=t.device)

    outs = (out_like(q, heads), out_like(k, kv_heads), out_like(v, kv_heads))
    lib = _library()
    vec = vector_width(dim, *inputs, *outs)
    device = q.device
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *(None if t is None else t.data_ptr() for t in inputs + outs),
            _freqs_on(theta, dim, device).data_ptr(),
            None if positions is None else positions.data_ptr(), batch, seq,
            heads, kv_heads, dim, _DTYPE_CODES[q.dtype], int(head_major),
            vec, splits(batch * seq, dim, vec,
                        heads + kv_heads * (1 if v is None else 2),
                        sm_count(device.index)),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(err, lib.rope_error_string, entry)
    return outs if v is not None else outs[:2]


def rope_bwd(dq, dk, theta: float, positions=None, *, dv=None,
             head_major=False):
    """The gradients of :func:`rope_qk`'s inputs from those of its
    outputs (``head_major``: in (B, heads, S, D), as it wrote them), in
    (B, S, heads, D): dq and dk rotated back, dv (given with
    ``head_major`` only) transposed. The kernel for CUDA tensors, one
    launch for all of them, the plain version
    (:func:`rope_backward_reference`) for CPU ones."""
    natural = [t if t is None or not head_major else t.transpose(1, 2)
               for t in (dq, dk, dv)]
    _check(*natural, theta, positions, head_major)
    if dq.device.type == "cpu":
        return _plain_backward(dq, dk, dv, theta, positions, head_major)
    _check_contiguous(dq=dq, dk=dk, dv=dv, positions=positions)
    outs = _launch("rope_qk_bwd", (dq, dk, dv), theta, positions,
                   head_major)
    rope_bwd.launches += 1
    return outs


class _RopeQK(torch.autograd.Function):
    """:func:`rope_qk` with its backward; it saves only the positions
    (the backward recomputes the angles)."""

    @staticmethod
    def forward(ctx, q, k, v, theta, positions, head_major):
        ctx.theta, ctx.head_major = theta, head_major
        ctx.has_v = v is not None
        ctx.save_for_backward(positions)
        if q.device.type == "cpu":
            return _plain(q, k, v, theta, positions, head_major)
        return _launch_forward(q, k, v, theta, positions, head_major)

    @staticmethod
    def backward(ctx, dq, dk, dv=None):
        (positions,) = ctx.saved_tensors
        grads = rope_bwd(dq.contiguous(), dk.contiguous(), ctx.theta,
                         positions,
                         dv=dv.contiguous() if ctx.has_v else None,
                         head_major=ctx.head_major)
        return (*grads[:2], grads[2] if ctx.has_v else None, None, None,
                None)


def _launch_forward(q, k, v, theta, positions, head_major):
    outs = _launch("rope_qk", (q, k, v), theta, positions, head_major)
    rope_qk.launches += 1
    return outs


def rope_qk(q, k, theta: float, positions=None, *, v=None,
            head_major=False):
    """RoPE of one layer's ``q`` (B, S, H, D) and ``k`` (B, S, H_kv, D)
    at ``positions`` (None: 0 .. S - 1; else an int64 (S,) tensor on
    their device): ``(q_rot, k_rot)`` in their layout, or with
    ``head_major`` in (B, heads, S, D), there with ``v`` (like k) copied
    beside them: ``(q_rot, k_rot, v)``. One dtype, float32 or bfloat16,
    D even. The kernel for CUDA tensors (contiguous), one launch for all
    of it, the plain version for CPU ones; with the backward when a
    gradient is wanted. The frequencies are made on the device at the
    first eager call for a (theta, head_dim)."""
    _check(q, k, v, theta, positions, head_major)
    if q.device.type == "cuda":
        _check_contiguous(q=q, k=k, v=v, positions=positions)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v)):
        return _RopeQK.apply(q, k, v, theta, positions, head_major)
    if q.device.type == "cpu":
        return _plain(q, k, v, theta, positions, head_major)
    return _launch_forward(q, k, v, theta, positions, head_major)


#: Kernel launches since the last reset (the plain CPU path adds none).
rope_qk.launches = 0
rope_bwd.launches = 0
#: the kernels' wrappers, by the name each launch count reports under
WRAPPERS = {"rope": rope_qk, "rope_bwd": rope_bwd}

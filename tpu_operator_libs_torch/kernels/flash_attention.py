"""Causal flash-attention forward: the CUDA port of the Pallas TPU kernel.

Mirrors the forward of ``jax.experimental.pallas.ops.tpu.flash_attention``
(``_flash_attention_impl``: ``pl.pallas_call`` with the kernel
``_flash_attention_kernel``), which
``tpu_operator_libs/examples/llama.py::forward`` calls as
``flash_attention(q, k, v, causal=True, sm_scale=head_dim ** -0.5)`` on
``(B, H, S, D)`` inputs. The kernel is ``csrc/flash_attention_fwd.cu``;
its design note says what bounds it and what it leaves for later.

:func:`flash_attention` takes the plain version
(:func:`flash_attention_reference`) for tensors on the CPU and launches
the kernel for tensors on a CUDA device. K/V may carry fewer heads than
Q (grouped-query attention: kv head = h // (H // H_kv)); the Pallas
call needs them repeated to H heads first, the kernel reads them as
they are. The backward kernels (the Pallas ``_flash_attention_bwd_dkv``
and ``_flash_attention_bwd_dq``) come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

#: head_dim values the kernel is compiled for: the model's 128 and the
#: narrow widths the tests use.
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention_fwd.cu"


def flash_attention_reference(q, k, v, *, causal: bool, sm_scale: float):
    """Plain PyTorch version: (out (B, H, Sq, D) in q's dtype, lse
    (B, H, Sq) float32). An einsum in float32, a -inf causal mask (query
    i sees keys <= i) and a float32 softmax."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        visible = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril()
        scores = scores.masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype), lse


def _check_inputs(q, k, v) -> None:
    """Raise on anything the kernel does not take; the CPU path holds
    its inputs to the same contract so the tests exercise it."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D (B, H, S, D) tensor")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"{name} has dtype {t.dtype}; the kernel takes "
                f"{sorted(str(d) for d in _DTYPE_CODES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    batch, heads, sq, dim = q.shape
    if k.shape[0] != batch or k.shape[3] != dim:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in "
            "batch or head_dim")
    if heads % k.shape[1]:
        raise ValueError(
            f"kv heads {k.shape[1]} must divide q heads {heads}")
    if dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head_dim {dim} not in {SUPPORTED_HEAD_DIMS}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("sequence lengths must be >= 1")


_lib = None


def _library():
    global _lib
    if _lib is None:
        from tpu_operator_libs_torch.kernels._build import build

        lib = build(_SOURCE).lib
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k, v, causal: bool, sm_scale: float):
    lib = _library()
    batch, heads, sq, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, sq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch, heads, k.shape[1], sq, k.shape[2], dim,
            _DTYPE_CODES[q.dtype], int(causal), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(
            "flash_attention_fwd launch failed: "
            f"{lib.flash_attention_error_string(err).decode()} ({err})")
    flash_attention.launches += 1
    return out, lse


def flash_forward(q, k, v, *, causal: bool, sm_scale: float):
    """(out, lse) from the kernel for CUDA tensors, from the plain
    version for CPU tensors."""
    _check_inputs(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, _ = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_NO_BACKWARD)


_NO_BACKWARD = (
    "flash_attention has no backward yet: the dK/dV and dQ kernels come "
    "with the training slice (ROADMAP.md Queue 2, kernel rows 2-3); call "
    "it under torch.no_grad() or on tensors that do not require grad")


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float):
    """Attention output (B, H, Sq, D) for q (B, H, Sq, D) and k, v
    (B, H_kv, Sk, D), float32 or bfloat16, contiguous. Raises in grad
    mode on inputs that require grad, before any work is done."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)
            if isinstance(t, torch.Tensor)):
        raise NotImplementedError(_NO_BACKWARD)
    return _FlashAttention.apply(q, k, v, causal, sm_scale)


#: Kernel launches since the last reset (the plain CPU path adds none).
flash_attention.launches = 0

"""The SwiGLU gate, forward and backward.

Mirrors the gate ``jax.nn.silu(m @ w_gate) * (m @ w_up)`` of
``tpu_operator_libs/examples/llama.py:311`` and
``tpu_operator_libs/examples/llama_decode.py:251-252``, which XLA fuses
on the TPU (no Pallas source): ``silu(g) * u`` on the two products.

:func:`swiglu` launches ``csrc/swiglu.cu``'s forward kernel for CUDA
tensors, one launch a call, and runs the plain version,
:func:`swiglu_reference` (``F.silu(g) * u``), for CPU ones. When a
gradient is wanted it goes through an autograd Function whose backward
is :func:`swiglu_bwd`: one pass over ``dy``, ``g`` and ``u`` writing
``dg`` and ``du`` on the card, the explicit plain formula
:func:`swiglu_backward_reference` on the CPU. Each kernel computes the
same correctly rounded float32 operations as its plain version, in the
same order, with ``expf``, so the two agree bit for bit where PyTorch's
``exp`` on the card does.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: the CUDA source under ``csrc/``
SOURCE = "swiglu.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: blocks of 256 threads an SM before the grid strides (2,048 threads,
#: an H100 SM's most)
BLOCKS_PER_SM = 8
_lib = None


def swiglu_reference(g, u):
    """Plain PyTorch version: ``F.silu(g) * u``."""
    return F.silu(g) * u


def swiglu_backward_reference(dy, g, u):
    """Plain PyTorch version of :func:`swiglu_bwd`: with ``t = dy * u``
    in the dtype and ``s = 1 / (1 + exp(-g))`` in float32,
    ``dg = t * s * (1 + g * (1 - s))`` and ``du = dy * silu(g)``, each in
    the dtype: the gradient autograd takes through ``F.silu(g) * u``."""
    gf = g.float()
    s = torch.reciprocal(1 + torch.exp(-gf))
    t = (dy * u).float()
    dg = (t * s * (1 + gf * (1 - s))).to(g.dtype)
    return dg, dy * F.silu(g)


def vector_width(*tensors) -> int:
    """Elements a load: 8, else 4, where every buffer is aligned to them
    (16 bytes at most), else 1 (the kernels take the elements past the
    last whole vector one at a time)."""
    for vec in (8, 4):
        if all(t.data_ptr() % min(16, vec * t.element_size()) == 0
               for t in tensors):
            return vec
    return 1


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(*named) -> None:
    """(name, tensor) pairs of one shape, on one device; for the kernel
    contiguous and of one dtype, float32 or bfloat16."""
    first = named[0][1]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {named[0][0]} on "
                             f"{first.device}")
        if t.shape != first.shape:
            raise ValueError(f"{name} {tuple(t.shape)} and {named[0][0]} "
                             f"{tuple(first.shape)} differ")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    if first.device.type == "cuda":
        for name, t in named:
            if t.dtype != first.dtype or t.dtype not in _DTYPE_CODES:
                raise ValueError(
                    f"{name} has dtype {t.dtype}; the kernel takes one "
                    f"dtype, float32 or bfloat16 ({named[0][0]}: "
                    f"{first.dtype})")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _library():
    global _lib
    if _lib is None:
        from tpu_operator_libs_torch.kernels._build import build_all

        lib = build_all([SOURCE])[0].lib
        lib.swiglu_fwd.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.swiglu_fwd.restype = ctypes.c_int
        lib.swiglu_bwd.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.swiglu_bwd.restype = ctypes.c_int
        lib.swiglu_error_string.argtypes = [ctypes.c_int]
        lib.swiglu_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(entry, name, tensors, dtype, device):
    """One launch of ``entry`` over ``tensors`` (inputs then outputs)."""
    lib = _library()
    vec = vector_width(*tensors)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in tensors), tensors[0].numel(),
            _DTYPE_CODES[dtype], vec, BLOCKS_PER_SM * _sm_count(device.index),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        message = lib.swiglu_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {message} ({err})")


def _launch_forward(g, u):
    y = torch.empty_like(g)
    if g.numel():
        _launch("swiglu_fwd", "swiglu", (g, u, y), g.dtype, g.device)
        swiglu.launches += 1
    return y


def swiglu_bwd(dy, g, u):
    """``(dg, du)`` of the gate from the gradient ``dy`` of its output:
    the backward kernel for CUDA tensors, one launch for both, the plain
    version (:func:`swiglu_backward_reference`) for CPU ones."""
    _check(("dy", dy), ("g", g), ("u", u))
    if g.device.type == "cpu":
        return swiglu_backward_reference(dy, g, u)
    dg, du = torch.empty_like(g), torch.empty_like(u)
    if g.numel():
        _launch("swiglu_bwd", "swiglu_bwd", (dy, g, u, dg, du), g.dtype,
                g.device)
        swiglu_bwd.launches += 1
    return dg, du


class _SwiGLU(torch.autograd.Function):
    """The gate with its backward; it saves ``g`` and ``u``."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        if g.device.type == "cpu":
            return swiglu_reference(g, u)
        return _launch_forward(g, u)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        return swiglu_bwd(dy.contiguous(), g, u)


def swiglu(g, u):
    """``silu(g) * u``: the kernel for CUDA tensors (one dtype, float32 or
    bfloat16, contiguous, of one shape), one launch a call, the plain
    version for CPU ones; with the gate's backward when a gradient is
    wanted."""
    _check(("g", g), ("u", u))
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        return _SwiGLU.apply(g, u)
    if g.device.type == "cpu":
        return swiglu_reference(g, u)
    return _launch_forward(g, u)


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph a wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
swiglu.launches = 0
swiglu_bwd.launches = 0
#: the kernels' wrappers, by the name each launch count reports under
WRAPPERS = {"swiglu": swiglu, "swiglu_bwd": swiglu_bwd}

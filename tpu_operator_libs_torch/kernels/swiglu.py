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
``exp`` on the card does. The forward is launched with programmatic
dependent launch: its blocks may be scheduled while the product before
it finishes and wait for it on the card (graph capture of such a launch
needs CUDA 12.3 or later); :func:`plan` sets its vectors a thread and
its grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from tpu_operator_libs_torch.kernels._build import load, raise_on, sm_count

#: the CUDA source under ``csrc/``
SOURCE = "swiglu.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads a block of either kernel (``kThreads`` in the source)
THREADS = 256
#: the backward's blocks of 256 threads an SM before its grid strides
#: (2,048 threads, an H100 SM's most)
BLOCKS_PER_SM = 8
#: the forward's vectors a thread a tile, most first (the instances
#: built)
UNROLLS = (4, 2, 1)
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


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the forward runs: a thread takes ``unroll`` vectors of a
    block's tile of ``unroll`` x 256, and ``blocks`` blocks stride over
    the tiles (the C entry checks it)."""

    unroll: int
    blocks: int


def plan(n: int, vec: int, sms: int, resident=None) -> Plan:
    """The forward's launch for ``n`` elements at ``vec`` a load on a
    card of ``sms`` SMs: the most vectors a thread (of UNROLLS) that
    still gives every SM a tile, else one (the decode step's 65,536
    elements: the shortest chain, the most blocks); the grid is the
    tiles, at most ``resident(unroll)`` blocks an SM (one without it),
    and one block for fewer elements than a vector."""
    vectors = n // vec
    for unroll in UNROLLS:
        tiles = -(-vectors // (THREADS * unroll))
        if tiles >= sms:
            break
    per_sm = 1 if resident is None else resident(unroll)
    return Plan(unroll, max(1, min(tiles, sms * per_sm)))


@functools.cache
def _resident(index: int, dtype_code: int, vec: int, unroll: int) -> int:
    """Blocks of the forward instance that fit on one SM of card
    ``index``."""
    with torch.cuda.device(index):
        blocks = _library().swiglu_fwd_resident(dtype_code, vec, unroll)
    if blocks < 1:
        raise RuntimeError(f"swiglu: no occupancy for dtype {dtype_code}, "
                           f"vec {vec}, unroll {unroll}")
    return blocks


def forward_plan(n: int, vec: int, dtype, index: int) -> Plan:
    """:func:`plan` on card ``index``, with its SMs and the instance's
    resident blocks."""
    return plan(n, vec, sm_count(index), resident=functools.partial(
        _resident, index, _DTYPE_CODES[dtype], vec))


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
        _lib = load(SOURCE, {
            "swiglu_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            "swiglu_fwd_resident": [ctypes.c_int] * 3,
            "swiglu_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]}, "swiglu_error_string")
    return _lib


def _launch_forward(g, u):
    y = torch.empty_like(g)
    if g.numel():
        lib = _library()
        vec = vector_width(g, u, y)
        p = forward_plan(g.numel(), vec, g.dtype, g.device.index)
        with torch.cuda.device(g.device):
            err = lib.swiglu_fwd(
                g.data_ptr(), u.data_ptr(), y.data_ptr(), g.numel(),
                _DTYPE_CODES[g.dtype], vec, p.unroll, p.blocks,
                torch.cuda.current_stream(g.device).cuda_stream)
        raise_on(err, lib.swiglu_error_string, "swiglu", f" ({p})")
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
        lib = _library()
        with torch.cuda.device(g.device):
            err = lib.swiglu_bwd(
                *(t.data_ptr() for t in (dy, g, u, dg, du)), g.numel(),
                _DTYPE_CODES[g.dtype], vector_width(dy, g, u, dg, du),
                BLOCKS_PER_SM * sm_count(g.device.index),
                torch.cuda.current_stream(g.device).cuda_stream)
        raise_on(err, lib.swiglu_error_string, "swiglu_bwd")
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

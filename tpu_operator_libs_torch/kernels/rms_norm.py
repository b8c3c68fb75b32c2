"""RMSNorm with the residual add folded in, forward and backward.

Mirrors ``tpu_operator_libs/examples/llama.py::_rms_norm`` (``:108-114``)
and the residual adds before it (``llama.py:307, 312``,
``llama_decode.py:247, 253``), which XLA fuses on the TPU (no Pallas
source): ``s = h + delta`` rounded to the residual stream's dtype, the
float32 variance of ``s``, ``s * (1 / sqrt(var + eps))`` rounded to s's
dtype, then the weight multiply, rounded again.

:func:`add_rms_norm` returns ``(h + delta, rms_norm(h + delta))``
(``delta=None``: ``(h, rms_norm(h))``). For CUDA tensors it launches
``csrc/rms_norm.cu``'s forward kernel, one launch a call, with
programmatic dependent launch (its blocks may be scheduled while the
product before it finishes and wait for it on the card; graph capture of
such a launch needs CUDA 12.3 or later), in the layout :func:`plan`
gives; for CPU ones it runs the plain version,
:func:`add_rms_norm_reference`. When a gradient
is wanted it goes through an autograd Function that saves the normalised
input, the weight and ``rstd`` (float32, one a row) and whose backward is
:func:`rms_norm_bwd`: the backward kernel on the card, the explicit plain
formula :func:`rms_norm_backward_reference` on the CPU. The backward
kernel adds the incoming gradient of the residual output into ``dx`` and
sums ``dw`` over every row in a fixed order inside its one launch (each
thread's columns in registers over its rows, then the block's groups,
then a two-level combine of the blocks' partials: :func:`plan`), so
repeated launches and graph replays give the same bits. The row sums
differ in order from PyTorch's, so the kernels are held to their plain
versions within a tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from tpu_operator_libs_torch.kernels._build import (
    load,
    raise_on,
    sm_count,
    zeroed_counters,
)

#: the CUDA source under ``csrc/``
SOURCE = "rms_norm.cu"
EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads a block of the forward and of the backward kernel at most
#: (``kFwdThreads`` and ``kBwdThreads`` in the source); the backward's
#: where a thread holds more than 8 registers of each array of a row
#: (``backward_threads``: its instances then take over 128 registers)
FORWARD_THREADS = 256
BACKWARD_THREADS = 512
WIDE_BACKWARD_THREADS = 256
#: the most threads a row takes, and an H100's shared memory a block
MAX_THREADS_PER_ROW = 256
MAX_SMEM_BYTES = 227 * 1024
#: the forward's register path: the vectors of a row a thread holds at
#: most (``kMaxLoads``; wider rows take the two-pass loop) and the
#: instances built (``loads`` 0 is the two-pass loop)
MAX_LOADS = 4
LOADS = (0, 1, 2, 4)
#: the vectors of a row a thread of the forward aims to hold: one (256
#: threads a row of 2,048) while the rows fit one wave at a row a block,
#: two (128 threads, two rows a block) past that. On the H100 these were
#: the fastest at the decode step and the prefill block, and at the train
#: step, of 1, 2, 4 and 8 (``norm_gate_variants.py``, PERF.md)
TARGET_LOADS = (1, 2)
#: the vectors of a row a thread of the backward aims to hold: two (128
#: threads a row of 2,048, four rows a block), at every row count; of 1,
#: 2 and 4 the fastest at the train shape on the H100 (``chip_smoke.py``
#: phase 3f's ``layouts_ms``, PERF.md)
BACKWARD_TARGET_LOADS = 2
#: the backward's combine groups of blocks at most (``kMaxCombineGroups``),
#: and the blocks up to which one level adds every partial (the rows of
#: partials whose loads the combine issues at once, ``kRowsInFlight``)
COMBINE_GROUPS = 64
ONE_LEVEL_BLOCKS = 16
_lib = None
#: the backward's ticket counters by (device index, stream): one for
#: each combine group and one for the second level, 0 between launches
_counters: "dict[tuple[int, int], torch.Tensor]" = {}


def _rms_parts(x, weight, eps):
    """The plain norm and its float32 ``rstd`` (x's leading shape)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    return (x * rstd).to(x.dtype) * weight, rstd[..., 0]


def rms_norm_reference(x, weight, eps: float = EPS):
    """Plain PyTorch version of the norm: the variance in float32,
    ``x * rsqrt`` cast back to x's dtype BEFORE the weight multiply, in
    the JAX package's order."""
    return _rms_parts(x, weight, eps)[0]


def add_rms_norm_reference(h, delta, weight, eps: float = EPS):
    """Plain PyTorch version of :func:`add_rms_norm`."""
    s = h if delta is None else h + delta
    return s, rms_norm_reference(s, weight, eps)


def rms_norm_backward_reference(dy, x, weight, rstd, ds=None):
    """Plain PyTorch version of :func:`rms_norm_bwd`, in float32: with
    ``g = dy * w`` and ``c`` the row sum of ``g * x``,
    ``dx = rstd * (g - x * (rstd^2 * c / dim)) (+ ds)`` in x's dtype and
    ``dw`` the sum over every row of ``dy * round(x * rstd)`` in w's
    dtype."""
    dim = x.shape[-1]
    xf = x.float()
    r = rstd.float()[..., None]
    g = dy.float() * weight.float()
    c = torch.sum(g * xf, dim=-1, keepdim=True)
    dx = r * (g - xf * (r * r * c / dim))
    if ds is not None:
        dx = dx + ds.float()
    n = (xf * r).to(x.dtype).float()
    dw = torch.sum((dy.float() * n).reshape(-1, dim), dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a kernel runs: a group of ``threads_per_row`` threads a row,
    ``rows_per_block`` groups a block, each thread holding ``loads``
    vectors of a row (0: the two-pass loop); the ``blocks`` blocks stride
    over the groups of rows. The backward's blocks fall into combine
    groups of ``blocks_per_group`` for dw's two-level combine (the C
    entry checks it)."""

    threads_per_row: int
    rows_per_block: int
    loads: int = 0
    blocks: int = 0
    blocks_per_group: int = 0


def _row_layout(vectors: int, target: int) -> "tuple[int, int]":
    """(threads a row, vectors a thread) for a row of ``vectors`` aiming
    at ``target`` vectors a thread: the fewest threads a row (a multiple
    of 32, at most 256) at which a thread holds at most ``target``, the
    vectors a thread the power of two that covers the row; (256, 0), the
    two-pass loop, past MAX_LOADS."""
    per_row = min(MAX_THREADS_PER_ROW,
                  max(32, -(-vectors // (32 * target)) * 32))
    need = -(-vectors // per_row)
    if need > MAX_LOADS:
        return MAX_THREADS_PER_ROW, 0
    return per_row, next(n for n in LOADS if n >= need)


def plan(rows: int, dim: int, vec: int, sms: int, backward: bool = False,
         resident=None, add: bool = False, bf16: bool = False) -> Plan:
    """The launch for ``rows`` rows of ``dim`` at ``vec`` elements a load
    on a card of ``sms`` SMs, from these alone.

    Forward: ``TARGET_LOADS[0]`` vectors a thread while the rows fit one
    wave of a row a block (``resident(loads, threads)`` blocks an SM, one
    without it), ``TARGET_LOADS[1]`` past it (``_row_layout``). A block
    takes up to 256 threads of rows, no more rows a block than spread
    the rows over the SMs. Without the add a grid of the resident blocks
    strides over the groups of rows; with it (``add``) there is a block
    for every group, which measured faster at the train shape.
    Backward: ``BACKWARD_TARGET_LOADS`` vectors a thread (the two-pass
    loop, a row a block, past the register budget), up to 512 threads of
    rows a block (256 where a thread holds more than 8 registers of each
    array of a row: 16 elements packed, every tensor ``bf16`` at 8 a
    load, else 8), no more rows a block than spread the rows over the SMs, a grid
    of the resident blocks striding over the groups of rows; dw's combine
    in one level up to ``ONE_LEVEL_BLOCKS`` blocks, else in groups of
    about the square root of the blocks, at most ``COMBINE_GROUPS``.
    Every width whose dw sums fit a block's shared memory (dim floats) is
    taken."""
    vectors = -(-dim // vec)
    per_sm = resident or (lambda loads, threads: 1)
    if backward:
        if 4 * dim > MAX_SMEM_BYTES:
            raise ValueError(f"width {dim} needs more shared memory than a "
                             "block has for its dw sums")
        per_row, loads = _row_layout(vectors, BACKWARD_TARGET_LOADS)
        packed = bf16 and vec == 8 and loads > 0
        threads = BACKWARD_THREADS if loads * vec <= (16 if packed else 8) \
            else WIDE_BACKWARD_THREADS
        per_block = 1 if loads == 0 else max(
            1, min(threads // per_row, -(-rows // sms)))
        groups = -(-rows // per_block)
        blocks = min(groups, sms * per_sm(loads, per_row * per_block))
        per_group = blocks if blocks <= ONE_LEVEL_BLOCKS else max(
            math.isqrt(blocks - 1) + 1, -(-blocks // COMBINE_GROUPS))
        return Plan(per_row, per_block, loads, blocks, per_group)
    per_row, loads = _row_layout(vectors, TARGET_LOADS[0])
    if rows > sms * per_sm(loads, per_row):
        per_row, loads = _row_layout(vectors, TARGET_LOADS[1])
    per_block = max(1, min(FORWARD_THREADS // per_row, -(-rows // sms)))
    groups = -(-rows // per_block)
    blocks = groups if add else min(
        groups, sms * per_sm(loads, per_row * per_block))
    return Plan(per_row, per_block, loads=loads, blocks=blocks)


def vector_width(dim: int, *tensors) -> int:
    """Elements a load: 8, else 4, where ``dim`` divides into them and
    every buffer is aligned to them (16 bytes at most), else 1."""
    for vec in (8, 4):
        if dim % vec == 0 and all(
                t.data_ptr() % min(16, vec * t.element_size()) == 0
                for t in tensors if t is not None):
            return vec
    return 1


@functools.cache
def _resident(index: int, dtypes: "tuple[int, int, int]", vec: int,
              loads: int, threads: int) -> int:
    """Blocks of ``threads`` threads of the forward instance for (vec,
    loads) and the dtype codes of h, delta (h's without it) and w that
    fit on one SM of card ``index``."""
    with torch.cuda.device(index):
        blocks = _library().rms_norm_fwd_resident(vec, loads, threads,
                                                  *dtypes)
    if blocks < 1:
        raise RuntimeError(f"rms_norm: no occupancy for vec {vec}, loads "
                           f"{loads}, {threads} threads, dtypes {dtypes}")
    return blocks


def packed(vec: int, loads: int, dtypes) -> bool:
    """Whether the forward's register path holds its vectors as packed
    bfloat16 (``packs`` in the source): every tensor bfloat16 at 8 a
    load."""
    return vec == 8 and loads > 0 and all(d == torch.bfloat16
                                          for d in dtypes)


def forward_plan(rows: int, dim: int, vec: int, index: int, add: bool,
                 dtypes=(torch.bfloat16,) * 3) -> Plan:
    """:func:`plan` of the forward on card ``index``, with its SMs and
    the resident blocks of the instance it launches for the dtypes of h,
    delta (h's without it) and w."""
    codes = tuple(_DTYPE_CODES[d] for d in dtypes)
    return plan(rows, dim, vec, sm_count(index),
                resident=functools.partial(_resident, index, codes, vec),
                add=add)


@functools.cache
def _bwd_resident(index: int, dtypes: "tuple[int, int, int, int]",
                  vec: int, dim: int, loads: int, threads: int) -> int:
    """Blocks of ``threads`` threads of the backward instance for (vec,
    loads), a row of ``dim`` and the dtype codes of dy, x, w and ds (-1
    without ds) that fit on one SM of card ``index``."""
    with torch.cuda.device(index):
        blocks = _library().rms_norm_bwd_resident(vec, loads, threads, dim,
                                                  *dtypes)
    if blocks < 1:
        raise RuntimeError(f"rms_norm_bwd: no occupancy for vec {vec}, "
                           f"loads {loads}, {threads} threads, dim {dim}, "
                           f"dtypes {dtypes}")
    return blocks


def backward_plan(rows: int, dim: int, vec: int, index: int,
                  dtypes=(torch.bfloat16,) * 4) -> Plan:
    """:func:`plan` of the backward on card ``index``, with its SMs and
    the resident blocks of the instance it launches for the dtypes of
    dy, x, w and ds (None without ds)."""
    codes = tuple(-1 if d is None else _DTYPE_CODES[d] for d in dtypes)
    return plan(rows, dim, vec, sm_count(index), backward=True,
                resident=functools.partial(_bwd_resident, index, codes, vec,
                                           dim),
                bf16=all(d in (None, torch.bfloat16) for d in dtypes))


def _check(h, delta, weight) -> None:
    named = {"h": h, "delta": delta, "weight": weight}
    for name, t in named.items():
        if t is None and name == "delta":
            continue
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    if h.dim() < 1 or h.shape[-1] < 1:
        raise ValueError(f"h {tuple(h.shape)} must be (..., dim)")
    if delta is not None and delta.shape != h.shape:
        raise ValueError(f"delta {tuple(delta.shape)} and h "
                         f"{tuple(h.shape)} differ")
    if weight.shape != h.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} must be "
                         f"({h.shape[-1]},)")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")
    if h.device.type == "cuda":
        _check_kernel_operands(named)


def _check_kernel_operands(named) -> None:
    """The kernels take contiguous float32 or bfloat16 tensors."""
    for name, t in named.items():
        if t is None:
            continue
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             "float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    global _lib
    if _lib is None:
        _lib = load(SOURCE, {
            "rms_norm_fwd": [ctypes.c_void_p] * 6 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_int] * 8 + [ctypes.c_void_p],
            "rms_norm_fwd_resident": [ctypes.c_int] * 6,
            "rms_norm_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
            + [ctypes.c_void_p],
            "rms_norm_bwd_resident": [ctypes.c_int] * 8},
            "rms_norm_error_string")
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_forward(h, delta, weight, eps, want_rstd):
    """(s or None, y, rstd or None) from one launch of the forward
    kernel."""
    dim = h.shape[-1]
    rows = h.numel() // dim
    s_dtype = h.dtype if delta is None \
        else torch.promote_types(h.dtype, delta.dtype)
    s = None if delta is None else torch.empty(h.shape, dtype=s_dtype,
                                               device=h.device)
    y = torch.empty(h.shape, dtype=torch.promote_types(s_dtype, weight.dtype),
                    device=h.device)
    rstd = torch.empty(h.shape[:-1], dtype=torch.float32,
                       device=h.device) if want_rstd else None
    if rows == 0:
        return s, y, rstd
    vec = vector_width(dim, h, delta, weight, s, y)
    p = forward_plan(rows, dim, vec, h.device.index, delta is not None, (
        h.dtype, h.dtype if delta is None else delta.dtype, weight.dtype))
    lib = _library()
    with torch.cuda.device(h.device):
        err = lib.rms_norm_fwd(
            h.data_ptr(), _ptr(delta), weight.data_ptr(), _ptr(s),
            y.data_ptr(), _ptr(rstd), rows, dim, eps, _DTYPE_CODES[h.dtype],
            _DTYPE_CODES[delta.dtype] if delta is not None else 0,
            _DTYPE_CODES[weight.dtype], vec, p.threads_per_row,
            p.rows_per_block, p.loads, p.blocks,
            torch.cuda.current_stream(h.device).cuda_stream)
    raise_on(err, lib.rms_norm_error_string, "rms_norm", f" ({p})")
    add_rms_norm.launches += 1
    return s, y, rstd


def rms_norm_bwd(dy, x, weight, rstd, ds=None):
    """``(dx, dw)`` of the norm from the gradient ``dy`` of its output,
    the normalised input ``x`` (..., dim), the weight (dim,), ``rstd``
    (x's leading shape, float32) and ``ds``, the incoming gradient of the
    residual output when the add was fused (added into ``dx``): the
    backward kernel for CUDA tensors, one launch, the plain version
    (:func:`rms_norm_backward_reference`) for CPU ones. ``dx`` in x's
    dtype, ``dw`` in the weight's."""
    _check(x, ds, weight)
    for name, t in (("dy", dy), ("rstd", rstd)):
        if not isinstance(t, torch.Tensor) or t.device != x.device:
            raise ValueError(f"{name} must be a tensor on {x.device}")
    if dy.shape != x.shape or rstd.shape != x.shape[:-1] \
            or rstd.dtype != torch.float32:
        raise ValueError(f"dy {tuple(dy.shape)} must be x's "
                         f"{tuple(x.shape)} and rstd {tuple(rstd.shape)} "
                         "float32 of its leading shape")
    if x.device.type == "cpu":
        return rms_norm_backward_reference(dy, x, weight, rstd, ds)
    _check_kernel_operands({"dy": dy, "rstd": rstd})
    dim = x.shape[-1]
    rows = x.numel() // dim
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight)
    dw = torch.empty_like(weight)
    vec = vector_width(dim, dy, x, weight, ds, dx)
    p = backward_plan(rows, dim, vec, x.device.index, (
        dy.dtype, x.dtype, weight.dtype, None if ds is None else ds.dtype))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        counters = zeroed_counters(_counters, x.device, stream,
                                   COMBINE_GROUPS + 1, "rms_norm_bwd")
        # the blocks' partial dw, then the combine groups' sums; allocated
        # here, so inside a captured graph it comes from the graph's pool
        ws = torch.empty((p.blocks + -(-p.blocks // p.blocks_per_group),
                          dim), dtype=torch.float32, device=x.device)
        err = lib.rms_norm_bwd(
            dy.data_ptr(), x.data_ptr(), weight.data_ptr(), rstd.data_ptr(),
            _ptr(ds), dx.data_ptr(), dw.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), rows, dim, _DTYPE_CODES[dy.dtype],
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
            _DTYPE_CODES[ds.dtype] if ds is not None else 0, vec,
            p.threads_per_row, p.rows_per_block, p.loads, p.blocks,
            p.blocks_per_group, stream.cuda_stream)
    raise_on(err, lib.rms_norm_error_string, "rms_norm_bwd", f" ({p})")
    rms_norm_bwd.launches += 1
    return dx, dw


class _AddRMSNorm(torch.autograd.Function):
    """``(s, y)`` (``y`` alone without delta) with the norm's backward.
    It saves the normalised input, the weight and rstd: under
    ``checkpoint`` the recompute gives all three again."""

    @staticmethod
    def forward(ctx, h, delta, weight, eps):
        if h.device.type == "cpu":
            s = h if delta is None else h + delta
            y, rstd = _rms_parts(s, weight, eps)
        else:
            s, y, rstd = _launch_forward(h, delta, weight, eps, True)
            if delta is None:
                s = h
        ctx.fused = delta is not None
        ctx.save_for_backward(s, weight, rstd)
        return (s, y) if ctx.fused else y

    @staticmethod
    def backward(ctx, *grads):
        s, weight, rstd = ctx.saved_tensors
        ds, dy = grads if ctx.fused else (None, grads[0])
        dx, dw = rms_norm_bwd(dy.contiguous(), s, weight, rstd,
                              None if ds is None else ds.contiguous())
        return dx, dx if ctx.fused else None, dw, None


def add_rms_norm(h, delta, weight, eps: float = EPS):
    """``(h + delta, rms_norm(h + delta))`` over the last axis of ``h``
    (..., dim), ``delta`` like ``h`` or None (then ``(h, rms_norm(h))``),
    ``weight`` (dim,): the kernel for CUDA tensors (float32 or bfloat16,
    contiguous; the outputs in PyTorch's promoted dtypes, as the plain
    version's), one launch a call, the plain version for CPU ones; with
    the norm's backward when a gradient is wanted."""
    _check(h, delta, weight)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (h, delta, weight)):
        out = _AddRMSNorm.apply(h, delta, weight, eps)
        return (h, out) if delta is None else out
    if h.device.type == "cpu":
        return add_rms_norm_reference(h, delta, weight, eps)
    s, y, _ = _launch_forward(h, delta, weight, eps, False)
    return (h if delta is None else s), y


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph a wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
add_rms_norm.launches = 0
rms_norm_bwd.launches = 0
#: the kernels' wrappers, by the name each launch count reports under
WRAPPERS = {"rms_norm": add_rms_norm, "rms_norm_bwd": rms_norm_bwd}

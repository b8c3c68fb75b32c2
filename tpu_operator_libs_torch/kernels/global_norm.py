"""The gradients' global norm for the clip, over every leaf in one pass.

Mirrors ``optax.global_norm`` under ``optax.clip_by_global_norm``, as
``tpu_operator_libs/examples/llama.py::make_train_step`` chains it before
``optax.adamw`` (``:400-404``) when ``grad_clip_norm > 0``; XLA fuses it
on the TPU (no Pallas source). The port keeps the norm in float32 (optax
sums a bfloat16 leaf's squares in bfloat16 and returns a bfloat16 norm;
the clip divides by the norm cast to the leaf's dtype, where the port's
is within one ulp of optax's, see ``parallel.global_norm``).

:func:`sum_of_squares` launches the global-norm kernel of
``csrc/adamw.cu`` for CUDA leaves: one launch over up to ``MAX_LEAVES``
leaves, on the AdamW update's table of leaves, which writes each leaf's
float32 sum of squares and, when asked, the square root of their sum in
leaf order (in the last launch), so that the one-card step's norm is one
launch. Its blocks' partial sums are added in a fixed order
inside the launch, so launches and graph replays give the same bits; the
order is not PyTorch's, so it agrees with the plain version,
:func:`sum_of_squares_reference` (``torch.sum(g.float() ** 2)`` a leaf,
which CPU leaves take), within 1e-5 relative.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_libs_torch.kernels import adamw
from tpu_operator_libs_torch.kernels._build import (
    load,
    raise_on,
    zeroed_counters,
)

#: the CUDA source under ``csrc/``: the AdamW update's, whose table of
#: leaves the norm shares
SOURCE = adamw.SOURCE
#: leaves a launch (the table's ``kMaxLeaves``)
MAX_LEAVES = adamw.MAX_LEAVES
#: threads of a block and vectors a thread (``kThreads`` and
#: ``kNormVectors`` in the source): a block takes a chunk of
#: ``THREADS * NORM_VECTORS`` vectors of one leaf
THREADS = 256
NORM_VECTORS = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
#: the ticket counter by (device index, stream), 0 between launches
_counters: "dict[tuple[int, int], torch.Tensor]" = {}


def sum_of_squares_reference(leaves):
    """Plain version: each leaf's float32 sum of squares, a list of 0-d
    tensors."""
    return [torch.sum(g.float() ** 2) for g in leaves]


def _library():
    global _lib
    if _lib is None:
        _lib = load(SOURCE, {
            "global_norm": [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]}, "adamw_error_string")
    return _lib


def _check(leaves) -> None:
    """At least one leaf, every leaf on one device, cpu or cuda; on the
    card one dtype, float32 or bfloat16, and contiguous leaves."""
    if not leaves:
        raise ValueError("the global norm takes at least one leaf")
    device, dtype = leaves[0].device, leaves[0].dtype
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for i, g in enumerate(leaves):
        if g.device != device:
            raise ValueError(f"leaf {i} is on {g.device}, leaf 0 on {device}")
        if device.type == "cuda":
            if g.dtype != dtype or dtype not in _DTYPE_CODES:
                raise ValueError(
                    f"leaf {i} has dtype {g.dtype}; the kernel takes one "
                    f"dtype, float32 or bfloat16 (leaf 0: {dtype})")
            if not g.is_contiguous():
                raise ValueError(f"leaf {i} must be contiguous")


def sum_of_squares(leaves, *, norm=False):
    """``(sums, norm)``: each leaf's float32 sum of squares, as a (n,)
    float32 tensor on the card or a list of 0-d tensors on the CPU, and,
    with ``norm=True``, the 0-d float32 square root of their sum in leaf
    order (else None). The kernel for CUDA leaves (one dtype, float32 or
    bfloat16, contiguous), one launch for every ``MAX_LEAVES`` leaves, the
    norm in the last; the plain version for CPU ones."""
    _check(leaves)
    if leaves[0].device.type == "cpu":
        sums = sum_of_squares_reference(leaves)
        return sums, torch.sqrt(sum(sums)) if norm else None
    device = leaves[0].device
    # an empty leaf adds 0, so the kernel passes over it
    rows = [i for i, g in enumerate(leaves) if g.numel()]
    full = torch.empty(len(leaves), dtype=torch.float32, device=device)
    out = full if len(rows) == len(leaves) else torch.empty(
        len(rows), dtype=torch.float32, device=device)
    total = torch.empty((), dtype=torch.float32, device=device) \
        if norm else None
    if not rows:
        full.zero_()
        return full, total.zero_() if norm else None
    picked = [leaves[i] for i in rows]
    vec = adamw.vector_width(*picked)
    chunk = THREADS * NORM_VECTORS * vec
    pointers = (ctypes.c_void_p * len(rows))(*(g.data_ptr() for g in picked))
    sizes = (ctypes.c_longlong * len(rows))(*(g.numel() for g in picked))
    n_partials = sum(-(-g.numel() // chunk) for g in picked)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        counter = zeroed_counters(_counters, device, stream, 1,
                                  "global_norm")
        # allocated here, so inside a captured graph from the graph's pool
        partials = torch.empty(n_partials, dtype=torch.float32,
                               device=device)
        err = lib.global_norm(
            pointers, sizes, len(rows), partials.data_ptr(), n_partials,
            out.data_ptr(), None if total is None else total.data_ptr(),
            counter.data_ptr(), _DTYPE_CODES[picked[0].dtype], vec,
            stream.cuda_stream)
    raise_on(err, lib.adamw_error_string, "global_norm")
    sum_of_squares.launches += -(-len(rows) // MAX_LEAVES)
    if out is not full:
        full.zero_().index_copy_(0, torch.tensor(rows, device=device), out)
    return full, total


#: Kernel launches since the last reset (the plain CPU path adds none).
sum_of_squares.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"global_norm": sum_of_squares}

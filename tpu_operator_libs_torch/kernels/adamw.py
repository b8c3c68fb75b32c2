"""The training step's AdamW update: every parameter leaf in one pass.

Mirrors ``optax.adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8, weight decay
1e-4), optionally behind ``optax.clip_by_global_norm``, as
``tpu_operator_libs/examples/llama.py::make_train_step`` builds it
(``:400-404``) and applies it (``:411-413``), and ``optax.adam``
(``weight_decay=0``) for the MLP of ``examples/jax_training_job.py``.
XLA fuses it on the TPU (no Pallas source).

:func:`adamw_update` launches ``csrc/adamw.cu`` for CUDA leaves: one
launch over every leaf (one for each ``MAX_LEAVES``), which reads p, g,
m and v and writes new p, m and v; and it runs the plain version,
:func:`adamw_update_reference` (``optim.AdamW.update``'s body, op for
op), for CPU leaves. Both are functional: they return new tensors and
leave their inputs as they are. The scalars (the count, the bias
corrections, a schedule's rate, the clip's norm and its test) stay 0-d
device-tensor ops, which the kernel reads through pointers, so no value
comes back to the host. The kernel rounds every operation to the
leaves' dtype where PyTorch rounds it, so the two write the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_libs_torch.kernels._build import load, raise_on

#: the CUDA source under ``csrc/``
SOURCE = "adamw.cu"
#: optax.adamw's defaults, which make_train_step takes as they are
B1, B2, EPS = 0.9, 0.999, 1e-8
#: leaves a launch (``kMaxLeaves``: 7 pointers a leaf in the launch's 4 KB
#: of parameters)
MAX_LEAVES = 48
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def clip_reference(grads, norm, clip_norm):
    """Plain version of ``optax.clip_by_global_norm``'s scaling: the
    leaves as they are where ``norm < clip_norm``, else each divided by
    the norm cast to its dtype and multiplied by ``clip_norm``; ``norm``
    a 0-d float32 tensor."""
    keep = norm < clip_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * clip_norm)
            for g in grads]


def adamw_update_reference(grads, state, params, *, lr, weight_decay,
                           clip_norm=0.0, norm=None):
    """Plain PyTorch version: ``(new params, new state)`` from lists of
    leaves ``grads`` and ``params`` and ``state`` ``{"count", "mu",
    "nu"}`` (``mu`` and ``nu`` lists like ``params``); ``lr`` a float or a
    0-d float32 tensor (a schedule's, at the count before the step);
    with ``clip_norm > 0``, ``norm`` the gradients' global norm, a 0-d
    float32 tensor."""
    if clip_norm > 0.0:
        grads = clip_reference(grads, norm, clip_norm)
    mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, state["mu"])]
    nu = [(1 - B2) * g * g + B2 * v for g, v in zip(grads, state["nu"])]
    count = state["count"] + 1
    bias1 = 1 - torch.pow(B1, count.float())
    bias2 = 1 - torch.pow(B2, count.float())

    def step(p, m, v):
        u = (m / bias1.to(m.dtype)) / (
            torch.sqrt(v / bias2.to(v.dtype)) + EPS)
        if weight_decay:
            u = u + weight_decay * p
        if isinstance(lr, torch.Tensor):
            u = (-lr).to(u.dtype) * u
        else:
            u = u * -lr
        return (p + u).to(p.dtype)

    new_params = [step(p, m, v) for p, m, v in zip(params, mu, nu)]
    return new_params, {"count": count, "mu": mu, "nu": nu}


def _check(grads, state, params, lr, clip_norm, norm) -> None:
    """Lists of one length, leaf i of one shape in each; every tensor on
    one device, cpu or cuda; on the card one dtype, float32 or bfloat16,
    and contiguous leaves."""
    lists = {"grads": grads, "mu": state["mu"], "nu": state["nu"],
             "params": params}
    lengths = {name: len(leaves) for name, leaves in lists.items()}
    if not params or len(set(lengths.values())) != 1:
        raise ValueError(f"grads, mu, nu and params must be lists of one "
                         f"length >= 1, got {lengths}")
    device = params[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    scalars = {"count": state["count"]}
    if isinstance(lr, torch.Tensor):
        scalars["lr"] = lr
    if clip_norm > 0.0:
        if not isinstance(norm, torch.Tensor) or norm.dim() != 0:
            raise ValueError("clipping takes the global norm as a 0-d "
                             "tensor")
        scalars["norm"] = norm
    for name, t in scalars.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the leaves on "
                             f"{device}")
    dtype = params[0].dtype
    for name, leaves in lists.items():
        for i, t in enumerate(leaves):
            if t.device != device:
                raise ValueError(f"{name}[{i}] is on {t.device}, params[0] "
                                 f"on {device}")
            if t.shape != params[i].shape:
                raise ValueError(f"{name}[{i}] {tuple(t.shape)} and "
                                 f"params[{i}] {tuple(params[i].shape)} "
                                 "differ")
            if device.type == "cuda":
                if t.dtype != dtype or dtype not in _DTYPE_CODES:
                    raise ValueError(
                        f"{name}[{i}] has dtype {t.dtype}; the kernel takes "
                        f"one dtype, float32 or bfloat16 (params[0]: "
                        f"{dtype})")
                if not t.is_contiguous():
                    raise ValueError(f"{name}[{i}] must be contiguous")


def vector_width(*tensors) -> int:
    """Elements a load: 16 bytes' worth where every buffer is 16-byte
    aligned, else 1. The C entry checks it."""
    if all(t.data_ptr() % 16 == 0 for t in tensors):
        return 16 // tensors[0].element_size()
    return 1


def _library():
    global _lib
    if _lib is None:
        _lib = load(SOURCE, {
            "adamw": [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 5 + [ctypes.c_float] * 8
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]}, "adamw_error_string")
    return _lib


def scalars(count, lr, dtype, clip_norm=0.0, norm=None) -> dict:
    """:func:`launch`'s 0-d arguments for the step to ``count`` (the count
    after it): the plain version's 0-d operations, rounded to the leaves'
    ``dtype`` as it rounds them before their elementwise use."""
    out = {"bias1": (1 - torch.pow(B1, count.float())).to(dtype),
           "bias2": (1 - torch.pow(B2, count.float())).to(dtype),
           "neg_lr": (-lr).to(dtype) if isinstance(lr, torch.Tensor)
           else -lr}
    if clip_norm > 0.0:
        out.update(norm=norm.to(dtype), keep=norm < clip_norm)
    return out


def launch(grads, mu, nu, params, *, bias1, bias2, neg_lr, weight_decay,
           clip_norm=0.0, norm=None, keep=None):
    """The kernel's launches alone: new ``(params, mu, nu)`` lists from the
    CUDA leaves and the 0-d tensors of the leaves' dtype ``bias1`` and
    ``bias2`` (and with clipping ``norm``, beside the 0-d bool ``keep``);
    ``neg_lr`` is ``-lr``, a float or a 0-d tensor of the dtype. Leaves
    without elements are passed over."""
    outs = [[torch.empty_like(p) for p in params] for _ in range(3)]
    rows = [i for i, p in enumerate(params) if p.numel()]
    if not rows:
        return outs
    tensors = [t for i in rows for t in (
        params[i], grads[i], mu[i], nu[i], outs[0][i], outs[1][i],
        outs[2][i])]
    pointers = (ctypes.c_void_p * len(tensors))(
        *(t.data_ptr() for t in tensors))
    sizes = (ctypes.c_longlong * len(rows))(*(params[i].numel()
                                              for i in rows))
    schedule = isinstance(neg_lr, torch.Tensor)
    device = params[0].device
    lib = _library()
    with torch.cuda.device(device):
        err = lib.adamw(
            pointers, sizes, len(rows), bias1.data_ptr(), bias2.data_ptr(),
            neg_lr.data_ptr() if schedule else None,
            None if norm is None else norm.data_ptr(),
            None if keep is None else keep.data_ptr(), 1 - B1, B1, 1 - B2,
            B2, EPS, weight_decay, clip_norm, 0.0 if schedule else neg_lr,
            _DTYPE_CODES[params[0].dtype], vector_width(*tensors),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(err, lib.adamw_error_string, "adamw")
    adamw_update.launches += -(-len(rows) // MAX_LEAVES)
    return outs


def adamw_update(grads, state, params, *, lr, weight_decay, clip_norm=0.0,
                 norm=None):
    """``(new params, new state)`` after one AdamW step, with the
    arguments of :func:`adamw_update_reference`: the kernel for CUDA
    leaves (one dtype, float32 or bfloat16, contiguous), one launch for
    every ``MAX_LEAVES`` leaves, the plain version for CPU ones."""
    _check(grads, state, params, lr, clip_norm, norm)
    if params[0].device.type == "cpu":
        return adamw_update_reference(grads, state, params, lr=lr,
                                      weight_decay=weight_decay,
                                      clip_norm=clip_norm, norm=norm)
    count = state["count"] + 1
    new_params, mu, nu = launch(
        grads, state["mu"], state["nu"], params,
        **scalars(count, lr, params[0].dtype, clip_norm, norm),
        weight_decay=weight_decay, clip_norm=clip_norm)
    return new_params, {"count": count, "mu": mu, "nu": nu}


#: Kernel launches since the last reset (the plain CPU path adds none).
adamw_update.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"adamw": adamw_update}

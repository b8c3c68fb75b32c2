"""The ring-attention block fold: one block's attention output folded into
the running state of its query rows, in place.

Mirrors the online-softmax update of
``tpu_operator_libs/examples/ring_attention.py::_block_attention``
(``:25-57``), which XLA fuses on the TPU (no Pallas source). The port
computes each block as one launch of the flash forward kernel, which
returns the block's normalised output and log-sum-exp, so the state is
``(acc, lse)`` rather than the reference's ``(m, l, acc)``: ``lse = m +
log l`` and ``acc`` is the reference's ``acc / l``. The fold is::

    lse = logaddexp(lse_acc, lse_blk)
    acc = exp(lse_acc - lse) * acc + exp(lse_blk - lse) * o_blk

with the reference's ``-inf`` guard: a row that has seen nothing keeps
zero weight and never becomes NaN. :func:`attention_fold` launches
``csrc/attention_fold.cu`` for CUDA tensors and runs the plain version,
:func:`attention_fold_reference`, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_libs_torch.kernels._build import load, raise_on

#: the CUDA source under ``csrc/``
SOURCE = "attention_fold.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def attention_fold_reference(acc, lse, o_blk, lse_blk):
    """Plain PyTorch version: the fold in float32, written into ``acc``
    and ``lse``, which it returns."""
    new = torch.logaddexp(lse, lse_blk)
    safe = torch.where(torch.isneginf(new), 0.0, new)
    w_acc = torch.exp(lse - safe)[..., None]
    w_blk = torch.exp(lse_blk - safe)[..., None]
    acc.copy_(w_acc * acc + w_blk * o_blk.float())
    lse.copy_(new)
    return acc, lse


def _check(acc, lse, o_blk, lse_blk) -> None:
    tensors = {"acc": acc, "lse": lse, "o_blk": o_blk, "lse_blk": lse_blk}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor")
        if t.device != acc.device:
            raise ValueError(f"{name} is on {t.device}, acc on {acc.device}")
    for name in ("acc", "lse", "lse_blk"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    if o_blk.dtype not in _DTYPE_CODES:
        raise ValueError(f"o_blk has dtype {o_blk.dtype}; the kernel takes "
                         f"{sorted(str(d) for d in _DTYPE_CODES)}")
    if o_blk.shape != acc.shape or acc.dim() < 2 \
            or lse.shape != acc.shape[:-1] or lse_blk.shape != lse.shape:
        raise ValueError(
            f"acc {tuple(acc.shape)} and o_blk {tuple(o_blk.shape)} must be "
            f"(..., D) and lse {tuple(lse.shape)}, lse_blk "
            f"{tuple(lse_blk.shape)} their (...)")
    if acc.shape[-1] % 4:
        raise ValueError(f"head_dim {acc.shape[-1]} must be a multiple of 4")


def _library():
    global _lib
    if _lib is None:
        _lib = load(SOURCE, {
            "attention_fold": [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]}, "flash_attention_error_string")
    return _lib


def attention_fold(acc, lse, o_blk, lse_blk):
    """Fold ``(o_blk, lse_blk)`` into ``(acc, lse)`` in place and return
    them: the kernel for CUDA tensors, the plain version for CPU ones.
    ``acc`` (..., D) and ``lse`` (...) float32; ``o_blk`` like ``acc`` in
    float32 or bfloat16; ``lse_blk`` like ``lse``."""
    _check(acc, lse, o_blk, lse_blk)
    if acc.device.type == "cpu":
        return attention_fold_reference(acc, lse, o_blk, lse_blk)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    if acc.data_ptr() % 16 or o_blk.data_ptr() % (4 * o_blk.element_size()):
        raise ValueError("acc must be 16-byte and o_blk 4-element aligned")
    lib = _library()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.attention_fold(acc.data_ptr(), lse.data_ptr(),
                                 o_blk.data_ptr(), lse_blk.data_ptr(),
                                 lse.numel(), acc.shape[-1],
                                 _DTYPE_CODES[o_blk.dtype], stream)
    raise_on(err, lib.flash_attention_error_string, "attention_fold")
    attention_fold.launches += 1
    return acc, lse


#: Kernel launches since the last reset (the plain CPU path adds none).
attention_fold.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"attention_fold": attention_fold}

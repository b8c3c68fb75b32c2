"""The next-token loss over the batch forward's logits, forward and
backward.

Mirrors ``tpu_operator_libs/examples/llama.py::next_token_loss``
(``:331-341``): ``log_softmax`` of the float32 logits, ``take_along_axis``
at the targets and the negative mean, which XLA fuses on the TPU (no
Pallas source), and its gradient under ``jax.grad``.

:func:`cross_entropy` takes the whole (B, S, V) logits and the int64
targets (B, S_used) of the first S_used positions (``tokens[:, 1:]`` for
the next-token loss, S_used = S - 1; a ring block's targets, S_used = S
but on the last block) and returns the float32 mean over the B * S_used
rows through :class:`NextTokenLoss`. On the card it launches
``csrc/cross_entropy.cu``: :func:`cross_entropy_fwd` (one launch: each
row's max and log of its sum of exps, kept for the backward, its picked
log-probability, and the mean, added in a fixed order inside the launch)
and :func:`cross_entropy_bwd` (one launch: dlogits for the whole (B, S,
V), zero at the positions without a target), so neither the sliced
logits, their float32 copies nor the zero-padded gradient are made. On
the CPU it runs the plain versions, :func:`next_token_loss_reference`
(the port's former ops, op for op; also the kernels' oracle) and
:func:`next_token_loss_backward_reference` (its gradient's formula).
The row sums take another order than PyTorch's, so the kernels are held
to the plain versions within a tolerance (the loss 1e-5 relative,
bfloat16 dlogits one ulp), not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_libs_torch.kernels._build import (
    load,
    raise_on,
    zeroed_counters,
)

#: the CUDA source under ``csrc/``
SOURCE = "cross_entropy.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
#: the forward's ticket counter by (device index, stream), 0 between
#: launches
_counters: "dict[tuple[int, int], torch.Tensor]" = {}


def next_token_loss_reference(logits, targets):
    """Plain version: the mean of ``-log_softmax(logits.float())`` at
    ``targets`` (B, S_used) over the first S_used positions of ``logits``
    (B, S, V), as the port computed it before the kernels."""
    logp = torch.log_softmax(logits[:, :targets.shape[1], :].float(), dim=-1)
    picked = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -torch.mean(picked)


def next_token_loss_backward_reference(logits, targets, grad):
    """Plain version of the gradient: dlogits (B, S, V) in the logits'
    dtype for the loss's 0-d float32 gradient ``grad``:
    ``onehot * gp - exp(log p) * gp`` with ``gp = -grad / (B * S_used)``
    at the first S_used positions (what the gather's backward and the
    log-softmax's give), rounded to the logits' dtype, and 0 past them."""
    used = targets.shape[1]
    logp = torch.log_softmax(logits[:, :used, :].float(), dim=-1)
    gp = -grad / targets.numel()
    onehot = torch.zeros_like(logp).scatter_(-1, targets[..., None], 1.0)
    out = torch.zeros_like(logits)
    out[:, :used, :] = (onehot * gp - torch.exp(logp) * gp).to(logits.dtype)
    return out


def _check(logits, targets) -> None:
    """(B, S, V) logits, float32 or bfloat16, contiguous; int64 targets
    (B, S_used), 1 <= S_used <= S, on the logits' device, contiguous; on
    the CPU every target in [0, V) (on the card one outside it makes the
    loss NaN: checking would read the targets back)."""
    if not isinstance(logits, torch.Tensor) or logits.dim() != 3:
        raise ValueError("logits must be a (B, S, V) tensor")
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"logits have dtype {logits.dtype}; the loss takes "
                         "float32 or bfloat16")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {logits.device}")
    batch, seq, vocab = logits.shape
    if not isinstance(targets, torch.Tensor) or targets.dtype != torch.int64:
        raise ValueError("targets must be an int64 tensor")
    if targets.dim() != 2 or targets.shape[0] != batch \
            or not 1 <= targets.shape[1] <= seq:
        raise ValueError(f"targets {tuple(targets.shape)} must be (B, S_used) "
                         f"with B = {batch} and 1 <= S_used <= {seq}")
    if targets.device != logits.device:
        raise ValueError(f"targets are on {targets.device}, the logits on "
                         f"{logits.device}")
    if not targets.is_contiguous():
        raise ValueError("targets must be contiguous")
    if logits.device.type == "cpu" and targets.numel() and (
            int(targets.min()) < 0 or int(targets.max()) >= vocab):
        raise ValueError(f"targets must lie in [0, {vocab})")


def vector_width(*tensors) -> int:
    """Elements a load: 16 bytes' worth where the vocabulary is a
    multiple of it and every buffer is 16-byte aligned, else 1. The C
    entries check it."""
    vec = 16 // tensors[0].element_size()
    if tensors[0].shape[-1] % vec == 0 and all(
            t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def _library():
    global _lib
    if _lib is None:
        _lib = load(SOURCE, {
            "cross_entropy_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            "cross_entropy_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_void_p],
            "cross_entropy_fwd_blocks": [ctypes.c_longlong, ctypes.c_int]},
            "cross_entropy_error_string")
        _lib.cross_entropy_fwd_blocks.restype = ctypes.c_longlong
    return _lib


def cross_entropy_fwd(logits, targets):
    """``(loss, stats)`` from one launch of the forward kernel on CUDA
    ``logits`` and ``targets`` (checked by the caller): the 0-d float32
    loss and each row's (max, log of its sum of exps), (B * S_used, 2)
    float32, which the backward reads."""
    batch, seq, vocab = logits.shape
    used = targets.shape[1]
    lib = _library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device)
        counter = zeroed_counters(_counters, logits.device, stream, 1,
                                  "cross_entropy")
        blocks = lib.cross_entropy_fwd_blocks(batch * used, vocab)
        # allocated here, so inside a captured graph from the graph's pool
        stats = torch.empty((batch * used, 2), dtype=torch.float32,
                            device=logits.device)
        partials = torch.empty(blocks, dtype=torch.float32,
                               device=logits.device)
        loss = torch.empty((), dtype=torch.float32, device=logits.device)
        err = lib.cross_entropy_fwd(
            logits.data_ptr(), targets.data_ptr(), stats.data_ptr(),
            partials.data_ptr(), blocks, loss.data_ptr(), counter.data_ptr(),
            batch, seq, used, vocab, _DTYPE_CODES[logits.dtype],
            vector_width(logits), stream.cuda_stream)
    raise_on(err, lib.cross_entropy_error_string, "cross_entropy")
    cross_entropy_fwd.launches += 1
    return loss, stats


def cross_entropy_bwd(logits, targets, stats, grad):
    """dlogits (B, S, V) in the logits' dtype from one launch of the
    backward kernel: CUDA ``logits`` and ``targets`` (checked by the
    caller), the forward's ``stats`` and the loss's 0-d gradient ``grad``
    (read on the card, cast to float32 there if it is not)."""
    batch, seq, vocab = logits.shape
    if stats.shape != (targets.numel(), 2) or stats.dtype != torch.float32 \
            or not stats.is_contiguous() or stats.device != logits.device:
        raise ValueError("stats must be the forward's (B * S_used, 2) "
                         "float32 on the logits' device")
    if grad.dim() != 0 or grad.device != logits.device:
        raise ValueError("grad must be a 0-d tensor on the logits' device")
    grad = grad.float()
    dlogits = torch.empty_like(logits)
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.cross_entropy_bwd(
            logits.data_ptr(), targets.data_ptr(), stats.data_ptr(),
            grad.data_ptr(), dlogits.data_ptr(), batch, seq,
            targets.shape[1], vocab, _DTYPE_CODES[logits.dtype],
            vector_width(logits, dlogits),
            torch.cuda.current_stream(logits.device).cuda_stream)
    raise_on(err, lib.cross_entropy_error_string, "cross_entropy_bwd")
    cross_entropy_bwd.launches += 1
    return dlogits


class NextTokenLoss(torch.autograd.Function):
    """The loss of :func:`cross_entropy` with its backward: on the card
    the two kernels (it saves the logits, the targets and the rows'
    stats), on the CPU the plain versions (it saves the logits and the
    targets)."""

    @staticmethod
    def forward(ctx, logits, targets):
        if logits.device.type == "cpu":
            ctx.save_for_backward(logits, targets)
            return next_token_loss_reference(logits, targets)
        loss, stats = cross_entropy_fwd(logits, targets)
        ctx.save_for_backward(logits, targets, stats)
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, targets, *stats = ctx.saved_tensors
        if logits.device.type == "cpu":
            return next_token_loss_backward_reference(logits, targets,
                                                      grad), None
        return cross_entropy_bwd(logits, targets, stats[0], grad), None


def cross_entropy(logits, targets):
    """The float32 mean of ``-log softmax(logits)`` at ``targets`` over
    the first S_used positions: ``logits`` (B, S, V), float32 or
    bfloat16, contiguous; ``targets`` (B, S_used) int64. The kernels for
    CUDA tensors (one launch forward, one backward), the plain versions
    for CPU ones; differentiable in the logits."""
    _check(logits, targets)
    return NextTokenLoss.apply(logits, targets)


#: Kernel launches since the last reset (the plain CPU path adds none).
cross_entropy_fwd.launches = 0
cross_entropy_bwd.launches = 0
#: the kernels' wrappers, by the name each launch count reports under
WRAPPERS = {"cross_entropy": cross_entropy_fwd,
            "cross_entropy_bwd": cross_entropy_bwd}

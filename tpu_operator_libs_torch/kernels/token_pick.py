"""The decode step's token pick: greedy argmax, or a draw from the
tempered distribution truncated to top-k and the top-p nucleus, and the
chosen token's log-probability, in one launch a pick.

Mirrors ``tpu_operator_libs/examples/llama_decode.py::_pick_next``
(``:288-333``), which XLA fuses into the jitted decode loop on the TPU
(no Pallas source). The noise of the draw is an argument here: the
caller draws ``u`` (B, V) float32 uniforms (``torch.rand`` from its
generator; a test passes ``jax.random.uniform``'s), and the draw is the
Gumbel-max trick ``jax.random.categorical`` takes, ``argmax(l / T -
log(-log(max(u, tiny))))``.

:func:`pick` launches ``csrc/token_pick.cu`` for a CUDA tensor (the row
in shared memory: a block a row up to 2,048 columns; past that, up to
458,752, a cluster of eight blocks a row, each holding an eighth of it;
no sort: top-k's threshold and the nucleus's smallest kept probability
are found by bisection over the float32 bit patterns) and runs
:func:`pick_reference` (the port's former ops, op for op; the kernel's
oracle) for a CPU one. Greedy tokens are the plain version's bit for
bit; sampled tokens too, but where a row's nucleus boundary lies within
float32 rounding of ``top_p`` (the kernel sums the probabilities in
another order than ``torch.cumsum``); logprobs within 1e-5 relative plus
1e-6 (the row's sum of exps in another order).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_libs_torch.kernels._build import load, raise_on

#: the CUDA source under ``csrc/``
SOURCE = "token_pick.cu"
#: the widest row one block holds (``kRowElems`` in the source)
ROW_ELEMS = 2048
#: the blocks of a wider row's cluster (``kClusterBlocks``), and the
#: widest row the cluster holds in shared memory (``kClusterBlocks *
#: kSliceElems``)
CLUSTER_BLOCKS = 8
WIDE_ELEMS = CLUSTER_BLOCKS * 56 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def pick_reference(logits, u, temperature: float, top_k=None, top_p=None,
                   want_logprob: bool = False):
    """Plain version: ``(tokens (B,) int64, logprobs (B,) float32 or
    None)`` from ``logits`` (B, V) and the noise ``u`` (B, V) float32 (not
    read when ``temperature <= 0``). Greedy is the first index of the
    row's maximum (a NaN wins). Sampling masks the logits below the k-th
    largest (counted with multiplicity, ties kept), then the tokens whose
    tempered probability lies below the nucleus's smallest kept one p*
    (the smallest probability whose exclusive cumulative mass in
    descending order is below ``top_p``; ties kept), then draws by the
    Gumbel-max trick. The logprob is the untempered, untruncated
    log-softmax at the chosen token."""
    if temperature <= 0.0:
        choice = torch.argmax(logits, dim=-1)
    else:
        logits_f = logits.float()
        if top_k is not None:
            logits_f = top_k_masked(logits_f, top_k)
        if top_p is not None:
            # find the smallest kept probability p* (sorted cumulative
            # mass exclusive of self < top_p), then mask below it
            probs, sp, exclusive = descending_masses(logits_f, temperature)
            kept = exclusive < top_p  # first token always kept
            pstar = torch.where(kept, sp, float("inf")) \
                .amin(dim=-1, keepdim=True)
            logits_f = logits_f.masked_fill(probs < pstar, float("-inf"))
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        choice = torch.argmax(logits_f / temperature
                              - torch.log(-torch.log(u)), dim=-1)
    if not want_logprob:
        return choice, None
    lp = torch.log_softmax(logits.float(), dim=-1)
    return choice, torch.gather(lp, -1, choice[:, None])[:, 0]


def top_k_masked(logits_f, top_k: int):
    """``logits_f`` (B, V) float32 with every value below the row's k-th
    largest (counted with multiplicity) set to -inf; ties kept."""
    kth = torch.sort(logits_f, dim=-1).values[:, -top_k][:, None]
    return logits_f.masked_fill(logits_f < kth, float("-inf"))


def descending_masses(logits_f, temperature: float):
    """The nucleus's quantities of :func:`pick_reference`: ``(probs``
    (B, V), the tempered softmax of ``logits_f``; the probabilities in
    descending order; ``the exclusive cumulative mass in that order)``."""
    probs = torch.softmax(logits_f / temperature, dim=-1)
    sp = torch.flip(torch.sort(probs, dim=-1).values, dims=[-1])
    csum = torch.cumsum(sp, dim=-1)
    return probs, sp, csum - sp


def _check(logits, u, temperature, top_k, top_p) -> None:
    """(B, V) logits, float32 or bfloat16, each row's elements adjacent
    (rows may lie any stride apart: a ``[:, -1, :]`` view); a sampled
    pick's ``u`` (B, V) float32 on the logits' device, contiguous,
    ``top_k`` None or in [1, V] and ``top_p`` None or in (0, 1] (a greedy
    pick reads none of the three)."""
    if not isinstance(logits, torch.Tensor) or logits.dim() != 2:
        raise ValueError("logits must be a (B, V) tensor")
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"logits have dtype {logits.dtype}; the pick takes "
                         "float32 or bfloat16")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {logits.device}")
    batch, vocab = logits.shape
    if batch < 1 or vocab < 1:
        raise ValueError(f"logits {tuple(logits.shape)} are empty")
    if logits.stride(1) != 1:
        raise ValueError("each row of the logits must be contiguous")
    if temperature <= 0.0:
        return
    if top_k is not None and not (isinstance(top_k, int)
                                  and 1 <= top_k <= vocab):
        raise ValueError(f"top_k must be None or an int in [1, {vocab}], "
                         f"got {top_k!r}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if not isinstance(u, torch.Tensor) or u.dtype != torch.float32 \
            or tuple(u.shape) != (batch, vocab):
        raise ValueError(f"sampling takes u, ({batch}, {vocab}) float32 "
                         "uniforms")
    if u.device != logits.device:
        raise ValueError(f"u is on {u.device}, the logits on "
                         f"{logits.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def vector_width(logits, u=None) -> int:
    """Elements a load: 16 bytes' worth of the logits' dtype where the
    vocabulary and the row stride are multiples of it and the logits (and
    the noise) are 16-byte aligned, else 1. The C entry checks it."""
    vec = 16 // logits.element_size()
    if logits.shape[1] % vec == 0 and logits.stride(0) % vec == 0 and all(
            t.data_ptr() % 16 == 0 for t in (logits, u) if t is not None):
        return vec
    return 1


def _library():
    global _lib
    if _lib is None:
        _lib = load(SOURCE, {
            "token_pick": [ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p]}, "token_pick_error_string")
    return _lib


def _launch(logits, u, temperature, top_k, top_p, want_logprob):
    """One launch of the kernel on checked CUDA tensors."""
    batch, vocab = logits.shape
    if vocab > WIDE_ELEMS:
        raise ValueError(f"the kernel takes rows of up to {WIDE_ELEMS:,} "
                         f"columns, got {vocab:,}")
    sample = temperature > 0.0
    tokens = torch.empty(batch, dtype=torch.long, device=logits.device)
    logprobs = (torch.empty(batch, dtype=torch.float32, device=logits.device)
                if want_logprob else None)
    # as PyTorch divides by a Python number on the card: a product with
    # the float32 reciprocal of the float32 temperature (a float32
    # quotient rounded once from a double one is the float32 quotient)
    inv_t = 1.0 / ctypes.c_float(temperature).value if sample else 0.0
    lib = _library()
    with torch.cuda.device(logits.device):
        err = lib.token_pick(
            logits.data_ptr(), logits.stride(0),
            u.data_ptr() if sample else None, tokens.data_ptr(),
            logprobs.data_ptr() if want_logprob else None, batch, vocab,
            _DTYPE_CODES[logits.dtype],
            vector_width(logits, u if sample else None), inv_t,
            top_k if sample and top_k is not None else 0,
            top_p if sample and top_p is not None else 1.0,
            int(sample and top_p is not None),
            torch.cuda.current_stream(logits.device).cuda_stream)
    raise_on(err, lib.token_pick_error_string, "token_pick")
    pick.launches += 1
    return tokens, logprobs


def pick(logits, u, temperature: float, top_k=None, top_p=None,
         want_logprob: bool = False):
    """``(tokens (B,) int64, logprobs (B,) float32 or None)``: the
    function of :func:`pick_reference`, one kernel launch for CUDA
    tensors, the plain version for CPU ones. ``u`` is read only when
    ``temperature > 0``."""
    _check(logits, u, temperature, top_k, top_p)
    if logits.device.type == "cpu":
        return pick_reference(logits, u, temperature, top_k, top_p,
                              want_logprob)
    return _launch(logits, u, temperature, top_k, top_p, want_logprob)


#: Kernel launches since the last reset (the plain CPU path adds none).
pick.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"token_pick": pick}

"""The cached step's cache write: RoPE of the step's queries and keys,
and the new keys and values quantized for an int8 cache, written at the
step's position.

Mirrors ``tpu_operator_libs/examples/llama_decode.py::forward_with_cache``
``:174, 190-214``, which XLA fuses on the TPU (no Pallas source): the
positions ``start_pos + arange(T)``, ``_rope`` of q and k, then for an
int8 cache ``_quantize_kv_block`` after RoPE and ``dynamic_update_slice``
of the codes and the scales at ``start_pos``; for a float cache the cast
to the cache's dtype and the same update. :func:`rope_kv_append` launches
``csrc/kv_append.cu`` for CUDA tensors, all of a layer's rows in one
launch, and runs the plain version, :func:`rope_kv_append_reference`, for
CPU ones. :func:`kv_append` is the same write without the rotation (the
same kernel body). Kernel and plain version write the same bits: the
rotation rounds each product, sum and difference on its own with the
same ``cosf`` / ``sinf``, and the quantization uses only exact float32
operations (a max, IEEE divisions, round half to even).

The port's int8 recipe, :func:`_sym_int8`, lives here too: the weight
quantizer (``examples/llama_decode.py``) shares it. ``_rope`` and
``rope_freqs`` are ``kernels/rope.py``'s, imported back under the names
the decode path has used.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from tpu_operator_libs_torch.kernels._build import load, raise_on
from tpu_operator_libs_torch.kernels.rope import (  # noqa: F401
    _freqs,  # the frequencies on the card, shared with kernels/rope.py
    _freqs_on,
    rope_freqs,
    rope_reference as _rope,  # the port's name for the plain rotation
)

#: the CUDA source under ``csrc/``
SOURCE = "kv_append.cu"
#: input and cache dtypes by the code the C entry takes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _sym_int8(x, axis, group=None):
    """Symmetric int8 quantization along ``axis``: ``s = max|x| / 127``
    (floored at 1e-8 so all-zero slices don't divide by zero), ``q =
    clip(round(x / s))`` with round-half-to-even, as ``jnp.round``.
    With a ``group``, ``x`` is one shard of a tensor split along ``axis``
    and the max is taken over the whole of it (all-reduce max), so the
    scales are those of the unsplit tensor.
    Both divisions are IEEE divisions by a tensor on x's device: on CUDA,
    PyTorch divides by a Python number as a product with its float32
    reciprocal, which can round one ulp away from the quotient that the
    JAX package (and the CPU) computes.
    Returns (int8 codes, float32 scales with ``axis`` removed)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s = torch.clamp_min(amax, 1e-8) \
        / torch.full((), 127.0, device=amax.device)
    q = torch.clamp(torch.round(xf / s.unsqueeze(axis)), -127, 127) \
        .to(torch.int8)
    return q, s


def _quantize_kv_block(x):
    """(B, T, n_kv, head_dim) activations -> (int8 codes, (B, T, n_kv)
    float32 scales), symmetric per-(token, kv-head) over head_dim."""
    return _sym_int8(x, axis=-1)


def kv_append_reference(entry, k, v, start_pos):
    """Plain PyTorch version: for an int8 cache the codes and scales of
    ``k`` and ``v`` (quantized after RoPE, so the cache holds exactly what
    dense attention would read), for a float cache ``k`` and ``v`` cast
    to its dtype, written at positions ``start_pos .. start_pos + T - 1``
    along the sequence axis (the counterpart of JAX's
    ``dynamic_update_slice`` at a traced start). Returns ``entry``."""
    positions = torch.arange(k.shape[1], device=k.device) + start_pos
    if "k_s" in entry:
        k_q, k_s = _quantize_kv_block(k)
        v_q, v_s = _quantize_kv_block(v)
        new = {"k": k_q, "k_s": k_s, "v": v_q, "v_s": v_s}
    else:
        new = {"k": k.to(entry["k"].dtype), "v": v.to(entry["v"].dtype)}
    for name, block in new.items():
        entry[name].index_copy_(1, positions, block)
    return entry


def rope_kv_append_reference(entry, q, k, v, start_pos, theta):
    """Plain PyTorch version of :func:`rope_kv_append`: ``_rope`` of ``q``
    and ``k`` at positions ``start_pos .. start_pos + T - 1``, then
    :func:`kv_append_reference` of the rotated ``k`` and ``v``. Returns
    the rotated ``q``."""
    positions = torch.arange(q.shape[1], device=q.device) + start_pos
    q = _rope(q, theta, positions)
    k = _rope(k, theta, positions)
    kv_append_reference(entry, k, v, start_pos)
    return q


def check_cache_entry(entry) -> None:
    """One layer's cache as ``init_kv_cache`` makes it: ``{"k", "v"}``
    float32 or bfloat16 (B, S, n_kv, head_dim), or ``{"k", "k_s", "v",
    "v_s"}`` with int8 codes and float32 (B, S, n_kv) scales; contiguous,
    on one device."""
    if not isinstance(entry, dict) or set(entry) not in (
            {"k", "v"}, {"k", "k_s", "v", "v_s"}):
        raise ValueError("a cache entry is {'k', 'v'} or {'k', 'k_s', 'v', "
                         "'v_s'}")
    k = entry["k"]
    for name, t in entry.items():
        if not isinstance(t, torch.Tensor) or not t.is_contiguous():
            raise ValueError(f"cache {name!r} must be a contiguous tensor")
        if t.device != k.device:
            raise ValueError(f"cache {name!r} is on {t.device}, 'k' on "
                             f"{k.device}")
    v = entry["v"]
    if k.dim() != 4 or v.shape != k.shape or 0 in k.shape:
        raise ValueError(f"cache k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must both be (B, S, n_kv, head_dim)")
    if v.dtype != k.dtype:
        raise ValueError(f"cache k is {k.dtype} and v {v.dtype}")
    if "k_s" in entry:
        if k.dtype != torch.int8:
            raise ValueError(f"a cache with scales holds int8 codes, not "
                             f"{k.dtype}")
        for name in ("k_s", "v_s"):
            s = entry[name]
            if s.dtype != torch.float32 or s.shape != k.shape[:3]:
                raise ValueError(f"cache {name!r} must be float32 "
                                 f"{tuple(k.shape[:3])}, got {s.dtype} "
                                 f"{tuple(s.shape)}")
    elif k.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"a float cache is float32 or bfloat16, not "
                         f"{k.dtype}")
    if k.shape[-1] % 2:
        raise ValueError(f"head_dim {k.shape[-1]} must be even")


def check_start_pos(start_pos, device) -> None:
    """A Python int >= 0, or a 0-d int64 tensor on ``device``."""
    if isinstance(start_pos, torch.Tensor):
        if start_pos.dim() != 0 or start_pos.dtype != torch.int64:
            raise ValueError(f"a tensor start_pos must be 0-d int64, got "
                             f"{start_pos.dtype} {tuple(start_pos.shape)}")
        if start_pos.device != device:
            raise ValueError(f"start_pos is on {start_pos.device}, the "
                             f"cache on {device}")
    elif not isinstance(start_pos, int) or isinstance(start_pos, bool) \
            or start_pos < 0:
        raise ValueError(f"start_pos must be an int >= 0 or a 0-d int64 "
                         f"tensor, got {start_pos!r}")


def _check(entry, k, v, start_pos) -> None:
    check_cache_entry(entry)
    batch, seq, kv_heads, dim = entry["k"].shape
    for name, t in (("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor")
        if t.device != entry["k"].device:
            raise ValueError(f"{name} is on {t.device}, the cache on "
                             f"{entry['k'].device}")
        if t.dtype not in _FLOAT_DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; float32 or "
                             "bfloat16 expected")
        if t.dim() != 4 or t.shape[0] != batch or t.shape[2:] != (
                kv_heads, dim) or not 1 <= t.shape[1] <= seq:
            raise ValueError(
                f"{name} {tuple(t.shape)} must be (B, T, n_kv, head_dim) "
                f"with 1 <= T <= S against the cache's "
                f"{tuple(entry['k'].shape)}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    check_start_pos(start_pos, entry["k"].device)
    if isinstance(start_pos, int) and start_pos + k.shape[1] > seq:
        raise ValueError(f"positions {start_pos} .. {start_pos + k.shape[1]}"
                         f" run past the cache's {seq}")


def _check_rope(entry, q, k, v, start_pos, theta) -> None:
    _check(entry, k, v, start_pos)
    if not isinstance(q, torch.Tensor) or not q.is_contiguous():
        raise ValueError("q must be a contiguous tensor")
    if q.device != k.device:
        raise ValueError(f"q is on {q.device}, the cache on {k.device}")
    if q.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; float32 or bfloat16 "
                         "expected")
    if q.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3] or q.shape[2] < 1 \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} must be (B, T, H, head_dim) "
                         f"with H a multiple of k's {tuple(k.shape)} n_kv")
    if isinstance(theta, bool) or not isinstance(theta, (int, float)) \
            or not theta > 0:
        raise ValueError(f"theta must be a number > 0, got {theta!r}")


def vector_width(*tensors) -> int:
    """Pairs a lane takes at once: 2 where every row's halves split into
    aligned pairs (head_dim % 4 == 0, every buffer 8-byte aligned), else
    1. The C entry checks it."""
    dim = tensors[0].shape[-1]
    if dim % 4 == 0 and all(t.data_ptr() % 8 == 0 for t in tensors):
        return 2
    return 1


def _library():
    global _lib
    if _lib is None:
        append = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        _lib = load(SOURCE, {
            "kv_append": append,
            "rope_kv_append": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + append}, "kv_append_error_string")
    return _lib


def kv_append(entry, k, v, start_pos):
    """Write ``k`` and ``v`` (B, T, n_kv, head_dim), float32 or bfloat16,
    into one layer's cache at positions ``start_pos .. start_pos + T - 1``
    (quantized for an int8 cache) and return ``entry``: the kernel for
    CUDA tensors, one launch for both, the plain version for CPU ones.
    ``start_pos`` is an int or a 0-d int64 tensor on the cache's device,
    which the kernel reads there (a captured step advances it in place);
    an int goes to the kernel as an argument. Rows whose position lies
    outside the cache are not written."""
    _check(entry, k, v, start_pos)
    device = entry["k"].device
    if device.type == "cpu":
        return kv_append_reference(entry, k, v, start_pos)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = _library()
    with torch.cuda.device(device):
        err = lib.kv_append(*_cache_args(entry, k, v, start_pos),
                            vector_width(k, v, entry["k"], entry["v"]),
                            torch.cuda.current_stream(device).cuda_stream)
    raise_on(err, lib.kv_append_error_string, "kv_append")
    kv_append.launches += 1
    return entry


def _cache_args(entry, k, v, start_pos):
    """The C entries' arguments from k to cache_dtype."""
    batch, seq, kv_heads, dim = entry["k"].shape
    quant = "k_s" in entry
    on_device = isinstance(start_pos, torch.Tensor)
    return (k.data_ptr(), v.data_ptr(), entry["k"].data_ptr(),
            entry["v"].data_ptr(),
            entry["k_s"].data_ptr() if quant else None,
            entry["v_s"].data_ptr() if quant else None,
            start_pos.data_ptr() if on_device else None,
            0 if on_device else start_pos, batch, k.shape[1], seq,
            kv_heads, dim, _DTYPE_CODES[k.dtype], _DTYPE_CODES[v.dtype],
            _DTYPE_CODES[entry["k"].dtype])


def rope_kv_append(entry, q, k, v, start_pos, theta):
    """RoPE of ``q`` (B, T, H, head_dim) and ``k`` (B, T, n_kv, head_dim)
    at positions ``start_pos .. start_pos + T - 1``, and the rotated
    ``k`` and ``v`` written into one layer's cache there (quantized for an
    int8 cache); returns the rotated ``q`` in q's dtype. All three are
    float32 or bfloat16, H a multiple of n_kv. The kernel for CUDA
    tensors, one launch for all of it, the plain version for CPU ones.
    ``start_pos`` is an int or a 0-d int64 tensor on the cache's device,
    which the kernel reads there (a captured step advances it in place).
    Rows of k and v whose position lies outside the cache are not
    written; rotated q is returned for every row. The frequencies are
    made on the device at the first eager call for a (theta, head_dim)."""
    _check_rope(entry, q, k, v, start_pos, theta)
    device = entry["k"].device
    if device.type == "cpu":
        return rope_kv_append_reference(entry, q, k, v, start_pos, theta)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = _library()
    q_out = torch.empty_like(q)
    with torch.cuda.device(device):
        err = lib.rope_kv_append(
            q.data_ptr(), q_out.data_ptr(),
            _freqs_on(theta, q.shape[-1], device).data_ptr(), q.shape[2],
            _DTYPE_CODES[q.dtype], *_cache_args(entry, k, v, start_pos),
            vector_width(q, q_out, k, v, entry["k"], entry["v"]),
            torch.cuda.current_stream(device).cuda_stream)
    raise_on(err, lib.kv_append_error_string, "rope_kv_append")
    rope_kv_append.launches += 1
    return q_out


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph a wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
kv_append.launches = 0
rope_kv_append.launches = 0
#: the kernels' wrappers, by the name each launch count reports under
WRAPPERS = {"kv_append": kv_append, "rope_kv_append": rope_kv_append}

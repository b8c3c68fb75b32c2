"""The cached step's attention: new queries against one layer's whole
KV cache, float or int8 with per-(token, kv-head) scales, under the mask
of the step's position.

Mirrors ``tpu_operator_libs/examples/llama_decode.py::forward_with_cache``
``:216-246`` (with the mask of ``:181-182``), which XLA fuses on the TPU
(no Pallas source): a grouped einsum of the queries over (kv-head, group)
against the ``max_seq`` cache, scaled by ``head_dim ** -0.5``, float32
scores with keys past each query's position masked, a softmax, and the
value einsum. For an int8 cache the K scale rescales the scores after the
code contraction and the V scale the weights before the value
contraction, so nothing widens the cache.

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors, which reads the cache in place in its ``(B, S, n_kv, head_dim)``
layout and folds the scales, and runs the plain version,
:func:`decode_attention_reference`, for CPU ones. :func:`plan` picks the
launch from the shapes alone; the C entry checks it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu_operator_libs_torch.kernels.kv_append import (
    check_cache_entry,
    check_start_pos,
)

#: the CUDA source under ``csrc/``
SOURCE = "decode_attention.cu"
#: threads of a block and query rows (``(t, g)`` pairs of one kv head) a
#: block takes (``kThreads``, ``kMaxRows`` in the source)
THREADS = 128
MAX_ROWS = 16
#: keys a tile at most and at least; a tile's keys and values are staged
#: in shared memory twice over (two stages), so long rows take fewer
KEY_TILE = 64
MIN_KEY_TILE = 8
#: dynamic shared memory a block may take on an H100 (227 KB)
MAX_SMEM = 232448
#: the largest head_dim the kernel takes (its tiles fit shared memory)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None


def _promoted(a, b):
    """Both operands in their promoted dtype: JAX promotes mixed-dtype
    matmuls and einsums (a float32 cache under bfloat16 activations),
    where PyTorch's refuse them."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def decode_attention_reference(q, entry, start_pos):
    """Plain PyTorch version: ``q`` (B, T, nh, hd) after RoPE at positions
    ``start_pos .. start_pos + T - 1`` against the whole cache ``entry``;
    (B, T, nh, hd) in ``q``'s dtype for an int8 cache, else in the
    promoted dtype of ``q`` and the cache."""
    batch, t_new, heads, dim = q.shape
    max_seq, kv_heads = entry["k"].shape[1:3]
    group = heads // kv_heads
    quant_kv = "k_s" in entry
    positions = torch.arange(t_new, device=q.device) + start_pos
    # key validity: cached positions < start_pos+T, and causality
    # within the new block
    kv_pos = torch.arange(max_seq, device=q.device)
    mask = kv_pos[None, :] <= positions[:, None]  # (T, max_seq)
    # grouped einsum over (kv-head, group) — never materializes a
    # group-times-repeated copy of the cache
    q_g = q.reshape(batch, t_new, kv_heads, group, dim)
    # int8 codes are widened to the compute dtype; a float cache is left
    # as it is and the einsum promotes
    k_op = entry["k"].to(q.dtype) if quant_kv else entry["k"]
    scores = torch.einsum("bqkgd,bskd->bkgqs",
                          *_promoted(q_g, k_op)) * (dim ** -0.5)
    scores = scores.float()
    if quant_kv:
        # K dequant: one rank-1 rescale of the score matrix
        scores = scores \
            * entry["k_s"].permute(0, 2, 1)[:, :, None, None, :]
    scores = scores.masked_fill(~mask, -1e30)
    attn = torch.softmax(scores, dim=-1)
    if quant_kv:
        # V dequant: fold the per-(s, k) scale into the attention
        # weights BEFORE the value einsum (s is the contraction)
        attn = attn \
            * entry["v_s"].permute(0, 2, 1)[:, :, None, None, :]
    attn = attn.to(q.dtype)
    v_op = entry["v"].to(q.dtype) if quant_kv else entry["v"]
    ctx = torch.einsum("bkgqs,bskd->bqkgd", *_promoted(attn, v_op))
    return ctx.reshape(batch, t_new, heads, dim)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one call."""

    #: 16-byte ``cp.async`` loads of the cache's rows (their bytes a
    #: multiple of 16 and K, V 16-byte aligned), else element loads
    vec: bool
    #: keys a tile and bytes between two keys' rows in a staged tile
    key_tile: int
    row_stride: int
    smem_bytes: int
    #: (query-row tiles, kv heads, batch)
    grid: tuple


def smem_bytes(dim: int, key_tile: int, row_stride: int) -> int:
    """Dynamic shared memory of a block (the source's layout): the block's
    queries and output sums in float32, its scores, the key-split partial
    sums, the rows' running max, sum and rescale, and two stages of K and
    V tiles with their scales."""
    return (2 * MAX_ROWS * dim * 4 + MAX_ROWS * key_tile * 4
            + THREADS * 16 * 4 + 3 * MAX_ROWS * 4
            + 2 * 2 * key_tile * 4 + 2 * 2 * key_tile * row_stride)


def plan(batch: int, t_new: int, heads: int, kv_heads: int, dim: int,
         cache_dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The launch of a call with these shapes and cache dtype; ``aligned``
    says whether K and V start on 16-byte addresses."""
    row_bytes = dim * cache_dtype.itemsize
    vec = aligned and row_bytes % 16 == 0
    # a 16-byte pad between staged rows spreads a warp's reads of
    # neighbouring keys over the banks
    row_stride = -(-row_bytes // 16) * 16 + 16
    key_tile = KEY_TILE
    while key_tile > MIN_KEY_TILE \
            and smem_bytes(dim, key_tile, row_stride) > MAX_SMEM:
        key_tile //= 2
    rows = t_new * (heads // kv_heads)
    return Plan(vec, key_tile, row_stride,
                smem_bytes(dim, key_tile, row_stride),
                (-(-rows // MAX_ROWS), kv_heads, batch))


def _check(q, entry, start_pos) -> None:
    if not isinstance(q, torch.Tensor) or not q.is_contiguous():
        raise ValueError("q must be a contiguous tensor")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q has dtype {q.dtype}; float32 or bfloat16 "
                         "expected")
    check_cache_entry(entry)
    k = entry["k"]
    if k.device != q.device:
        raise ValueError(f"the cache is on {k.device}, q on {q.device}")
    batch, _, kv_heads, dim = k.shape
    if q.dim() != 4 or q.shape[0] != batch or q.shape[3] != dim \
            or q.shape[1] < 1 or q.shape[2] < 1 or q.shape[2] % kv_heads:
        raise ValueError(
            f"q {tuple(q.shape)} must be (B, T, n_heads, head_dim) with "
            f"n_kv_heads dividing n_heads, against the cache's "
            f"{tuple(k.shape)}")
    check_start_pos(start_pos, q.device)


def _library():
    global _lib
    if _lib is None:
        from tpu_operator_libs_torch.kernels._build import build_all

        lib = build_all([SOURCE])[0].lib
        lib.decode_attention.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong] + [ctypes.c_int] * 12 + [ctypes.c_float,
                                                        ctypes.c_void_p]
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def output_dtype(q_dtype, cache_dtype) -> torch.dtype:
    """The plain version's output dtype: q's for an int8 cache, else the
    promoted dtype of q and the cache."""
    if cache_dtype == torch.int8:
        return q_dtype
    return torch.promote_types(q_dtype, cache_dtype)


def decode_attention(q, entry, start_pos):
    """Attention of ``q`` (B, T, n_heads, head_dim), float32 or bfloat16,
    at positions ``start_pos .. start_pos + T - 1`` over one layer's whole
    cache ``entry`` (float32 or bfloat16, or int8 with its scales): the
    kernel for CUDA tensors, the plain version for CPU ones. ``start_pos``
    is an int or a 0-d int64 tensor on the cache's device, which the
    kernel reads there; an int goes to the kernel as an argument. Returns
    (B, T, n_heads, head_dim) in :func:`output_dtype`."""
    _check(q, entry, start_pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, entry, start_pos)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    k, v = entry["k"], entry["v"]
    batch, seq, kv_heads, dim = k.shape
    if dim > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dim} is above the kernel's "
                         f"{MAX_HEAD_DIM}")
    t_new, heads = q.shape[1:3]
    p = plan(batch, t_new, heads, kv_heads, dim, k.dtype,
             aligned=k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    if max(p.grid[1:]) > 65535:
        raise ValueError(f"grid {p.grid}: batch and n_kv_heads must be at "
                         "most 65535")
    quant = "k_s" in entry
    out = torch.empty(q.shape, dtype=output_dtype(q.dtype, k.dtype),
                      device=q.device)
    on_device = isinstance(start_pos, torch.Tensor)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            entry["k_s"].data_ptr() if quant else None,
            entry["v_s"].data_ptr() if quant else None, out.data_ptr(),
            start_pos.data_ptr() if on_device else None,
            0 if on_device else start_pos, batch, t_new, heads, kv_heads,
            seq, dim, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
            _DTYPE_CODES[out.dtype], int(p.vec), p.key_tile, p.row_stride,
            dim ** -0.5, stream)
    if err != 0:
        message = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed ({p}): "
                           f"{message} ({err})")
    decode_attention.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph the wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
decode_attention.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"decode_attention": decode_attention}

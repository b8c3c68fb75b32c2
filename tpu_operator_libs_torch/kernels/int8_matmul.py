"""The int8-weight matmul (W8A16): ``(x @ q) * s`` with int8 codes ``q``
that stay int8 in device memory.

Mirrors ``tpu_operator_libs/examples/llama_decode.py::_mm`` (``:135-143``)
for a quantized weight, which XLA fuses on the TPU (no Pallas source):
``(x @ q.astype(x.dtype)) * s.astype(x.dtype)``, x (M, K), q (K, N) int8
as ``quantize_params_int8`` stores it, s the float32 per-output-channel
scale (N,). :func:`int8_matmul` launches ``csrc/int8_matmul.cu`` for CUDA
tensors (float32 or bfloat16 x) and runs the plain version,
:func:`int8_matmul_reference`, for CPU ones.

The kernel splits K over blocks when the output has too few column
strips to fill the card (:func:`split_plan`) and adds the splits' f32
sums in a fixed order in a second pass, so two launches are bit-equal.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: the CUDA source under ``csrc/``
SOURCE = "int8_matmul.cu"
#: columns a block owns, rows of K it stages at a time and the most
#: splits of K (``kBlockN``, ``kChunkK``, ``kMaxSplits`` in the source)
BLOCK_N = 128
CHUNK_K = 256
MAX_SPLITS = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def int8_matmul_reference(x, q, s):
    """Plain PyTorch version: the product in x's dtype, rounded, times
    the scale rounded to x's dtype."""
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


def m_tile(m: int) -> int:
    """Rows of x a block takes (``m_tile`` in the source)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


def split_plan(m: int, n: int, k: int, sms: int) -> "tuple[int, int]":
    """(splits, rows of K a split) for an (m, k) x (k, n) product on a
    card of ``sms`` SMs: as many K splits as keep the blocks within one
    wave (at least one, at most ``MAX_SPLITS`` and one a staged chunk of
    K), each a whole number of chunks. A function of the shape and the
    card alone, so a shape always runs the same sums in the same order."""
    tiles = -(-n // BLOCK_N) * -(-m // m_tile(m))
    chunks = -(-k // CHUNK_K)
    splits = max(1, min(sms // tiles, chunks, MAX_SPLITS))
    k_per_split = -(-chunks // splits) * CHUNK_K
    return -(-k // k_per_split), k_per_split


def _check(x, q, s) -> None:
    for name, t in (("x", x), ("q", q), ("s", s)):
        if not isinstance(t, torch.Tensor) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"q must be int8 and s float32, got {q.dtype} "
                         f"and {s.dtype}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or s.shape != (q.shape[1],) or 0 in x.shape or 0 in q.shape:
        raise ValueError(
            f"x {tuple(x.shape)}, q {tuple(q.shape)} and s "
            f"{tuple(s.shape)} must be (M, K), (K, N) and (N,)")


def _library():
    global _lib
    if _lib is None:
        from tpu_operator_libs_torch.kernels._build import build_all

        lib = build_all([SOURCE])[0].lib
        lib.int8_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.int8_matmul.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_matmul(x, q, s):
    """``(x @ q) * s`` in x's dtype: the kernel for CUDA tensors, the plain
    version for CPU ones. x (M, K) float32 or bfloat16, q (K, N) int8, s
    (N,) float32, all contiguous."""
    _check(x, q, s)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes "
                         f"{sorted(str(d) for d in _DTYPE_CODES)}")
    (m, k), n = x.shape, q.shape[1]
    splits, k_per_split = split_plan(m, n, k, _sm_count(x.device.index))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # the split-K workspace; allocated here, so inside a captured graph
    # it comes from the graph's pool
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                              out.data_ptr(),
                              None if partial is None else partial.data_ptr(),
                              m, k, n, splits, k_per_split,
                              _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        message = lib.int8_matmul_error_string(err).decode()
        raise RuntimeError(f"int8_matmul launch failed: {message} ({err})")
    int8_matmul.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph the wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
int8_matmul.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"int8_matmul": int8_matmul}

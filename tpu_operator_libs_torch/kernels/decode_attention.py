"""The cached step's attention: new queries against one layer's KV
cache, float or int8 with per-(token, kv-head) scales, under the mask of
the step's position.

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
layout only up to the step's last visible key, splits the keys over
blocks and combines the splits in the same launch, and runs the plain
version, :func:`decode_attention_reference`, for CPU ones. :func:`plan`
picks the launch from the shapes and dtypes alone, never from the
position's value, so that prefill, the eager step and every replay of a
captured step run the same grid; the C entry checks it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu_operator_libs_torch.kernels import _build
from tpu_operator_libs_torch.kernels.kv_append import (
    check_cache_entry,
    check_start_pos,
)

#: the CUDA source under ``csrc/``
SOURCE = "decode_attention.cu"
#: threads of a block and query rows (``(t, g)`` pairs of one kv head) a
#: block takes (``kThreads``, ``kMaxRows`` in the source)
THREADS = 128
WARPS = THREADS // 32
MAX_ROWS = 16
#: keys a tile at most and at least; on the CUDA cores long rows take
#: fewer, the tensor cores always 64 (16 for each warp)
KEY_TILE = 64
MIN_KEY_TILE = 8
#: key tiles in a block's ring of shared memory, most and fewest
MAX_STAGES = 4
MIN_STAGES = 2
#: dynamic shared memory a block may take on an H100 (227 KB); an SM's
#: shared memory (228 KB) and what it keeps for each block (1 KB, and room
#: for the static ticket)
MAX_SMEM = 232448
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024 + 16
#: blocks an SM that the stages are traded for (the card measured three
#: two-stage blocks of the bench decode faster than two of three stages)
BLOCKS_PER_SM = 3
#: blocks a call aims at: two on each of an H100's 132 SMs, one wave (the
#: card measured one wave of long splits faster than two of short ones:
#: each block pays the position's read, its first tile's latency and the
#: combine once); the key splits of a call with fewer (b, kv head, row
#: tile) groups make up the rest, at most MAX_SPLITS of them
TARGET_BLOCKS = 264
MAX_SPLITS = 32
#: ticket counters a stream keeps: a call splits its keys only when it has
#: at most TARGET_BLOCKS / 2 groups
COUNTERS = TARGET_BLOCKS // 2
#: the largest head_dim the kernel takes (its tiles fit shared memory)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib = None
#: ticket counters by (device index, stream): COUNTERS ints, 0 between
#: launches
_counters: "dict[tuple[int, int], torch.Tensor]" = {}


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

    #: "tensor_cores" (mma.sync, bf16 q over a bf16 or int8 cache) or
    #: "cuda_cores" (float32 FMAs)
    route: str
    #: 16-byte ``cp.async`` loads of the cache's rows (their bytes a
    #: multiple of 16 and K, V 16-byte aligned), else element loads
    vec: bool
    #: keys a tile and bytes between two keys' rows in a staged tile
    key_tile: int
    row_stride: int
    #: key tiles in a block's ring
    stages: int
    #: blocks that share a (b, kv head, row tile) group's visible keys
    #: (:func:`split_ranges`)
    splits: int
    smem_bytes: int
    #: (row tiles x splits, kv heads, batch)
    grid: tuple

    @property
    def groups(self) -> int:
        """(b, kv head, row tile) groups: the ticket counters it takes."""
        return self.grid[0] // self.splits * self.grid[1] * self.grid[2]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def design(self) -> str:
        route = ("tensor cores (mma.sync m16n8k16 bf16, f32 sums)"
                 if self.route == "tensor_cores" else
                 "CUDA cores (f32 FMAs)")
        loads = "16-byte cp.async" if self.vec else "element loads"
        return (f"{route}, {self.blocks} blocks: (b, kv head, 16 query rows)"
                f" x {self.splits} split(s) of the visible keys, combined "
                f"in split order in the launch; a ring of {self.stages} "
                f"{self.key_tile}-key tiles by {loads}; stops at the last "
                "visible key")


def split_ranges(p: Plan, vis_end: int) -> "list[tuple[int, int]]":
    """The key ranges [begin, end) of a group's splits that hold a key,
    in split order, when keys 0 .. vis_end - 1 are visible to some row of
    it (the source's ``find_keys``): the visible key tiles dealt in equal
    runs of whole tiles; the splits past the last run exit. At least one
    range, empty when nothing is visible."""
    tiles = -(-vis_end // p.key_tile)
    per = max(1, -(-tiles // p.splits))
    nonempty = max(1, -(-tiles // per))
    return [(i * per * p.key_tile, min(vis_end, (i + 1) * per * p.key_tile))
            for i in range(nonempty)]


def _small_bytes() -> int:
    return (2 + WARPS) * MAX_ROWS * 4 + MAX_ROWS * 8


def _stage_bytes(key_tile: int, row_stride: int) -> int:
    return 2 * key_tile * row_stride + 2 * key_tile * 4


def smem_bytes(route: str, dim: int, cache_dtype: torch.dtype,
               key_tile: int, row_stride: int, stages: int) -> int:
    """Dynamic shared memory of a block (the source's layout). Both routes
    start with the combine's row sums and part weights and the rows'
    offsets, and end with the ring of key tiles (K and V rows, their
    scales). The CUDA cores keep the block's queries and output sums in
    float32, its scores, the key-share partial sums and the rows' running
    max, sum and rescale; the tensor cores the queries in bf16, the warps'
    max and sum and, for an int8 cache, the tile's codes converted to
    bf16."""
    if route == "tensor_cores":
        bf16_stride = 2 * dim + 16
        return (_small_bytes() + MAX_ROWS * bf16_stride
                + 2 * WARPS * MAX_ROWS * 4
                + (2 * KEY_TILE * bf16_stride
                   if cache_dtype == torch.int8 else 0)
                + stages * _stage_bytes(KEY_TILE, row_stride))
    return (_small_bytes() + 2 * MAX_ROWS * dim * 4 + MAX_ROWS * key_tile * 4
            + THREADS * 16 * 4 + 3 * MAX_ROWS * 4
            + stages * _stage_bytes(key_tile, row_stride))


def blocks_that_fit(smem: int) -> int:
    """Blocks of ``smem`` dynamic shared memory that share an SM."""
    return SM_SMEM // (smem + BLOCK_RESERVED_SMEM)


def plan(batch: int, t_new: int, heads: int, kv_heads: int, seq: int,
         dim: int, q_dtype: torch.dtype, cache_dtype: torch.dtype,
         aligned: bool = True) -> Plan:
    """The launch of a call with these shapes and dtypes; ``aligned``
    says whether K and V start on 16-byte addresses."""
    row_bytes = dim * cache_dtype.itemsize
    vec = aligned and row_bytes % 16 == 0
    tensor = (q_dtype == torch.bfloat16 and cache_dtype != torch.float32
              and dim % 16 == 0 and vec)
    route = "tensor_cores" if tensor else "cuda_cores"
    # a 16-byte pad between staged rows spreads the rows that a warp reads
    # at once (ldmatrix's eight, or neighbouring keys) over the banks; the
    # tensor cores' int8 rows are read only by the conversion to bf16,
    # 16 bytes a thread along the row, and take none
    row_stride = -(-row_bytes // 16) * 16 + (
        0 if tensor and cache_dtype == torch.int8 else 16)
    key_tile = KEY_TILE
    while not tensor and key_tile > MIN_KEY_TILE and smem_bytes(
            route, dim, cache_dtype, key_tile, row_stride,
            MIN_STAGES) > MAX_SMEM:
        key_tile //= 2

    def smem(stages):
        return smem_bytes(route, dim, cache_dtype, key_tile, row_stride,
                          stages)

    # the most blocks an SM (up to BLOCKS_PER_SM), then the most stages
    stages = max((s for s in range(MIN_STAGES, MAX_STAGES + 1)
                  if smem(s) <= MAX_SMEM),
                 key=lambda s: (min(blocks_that_fit(smem(s)),
                                    BLOCKS_PER_SM), s),
                 default=MIN_STAGES)
    row_tiles = -(-t_new * (heads // kv_heads) // MAX_ROWS)
    groups = row_tiles * kv_heads * batch
    splits = min(max(1, TARGET_BLOCKS // groups), -(-seq // key_tile),
                 MAX_SPLITS)
    return Plan(route, vec, key_tile, row_stride, stages, splits,
                smem(stages), (row_tiles * splits, kv_heads, batch))


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``SOURCE``) with its C entries' signatures."""
    return _build.bind(lib, {
        "decode_attention": [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 16
        + [ctypes.c_float, ctypes.c_void_p]}, "decode_attention_error_string")


def _library():
    global _lib
    if _lib is None:
        _lib = bind(_build.build_all([SOURCE])[0].lib)
    return _lib


def output_dtype(q_dtype, cache_dtype) -> torch.dtype:
    """The plain version's output dtype: q's for an int8 cache, else the
    promoted dtype of q and the cache."""
    if cache_dtype == torch.int8:
        return q_dtype
    return torch.promote_types(q_dtype, cache_dtype)


def decode_attention(q, entry, start_pos):
    """Attention of ``q`` (B, T, n_heads, head_dim), float32 or bfloat16,
    at positions ``start_pos .. start_pos + T - 1`` over one layer's
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
    p = plan(batch, t_new, heads, kv_heads, seq, dim, q.dtype, k.dtype,
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
        stream = torch.cuda.current_stream(q.device)
        ws = counters = None
        if p.splits > 1:
            # the splits' (m, l, acc); allocated here, so inside a captured
            # graph it comes from the graph's pool
            ws = torch.empty(p.groups * p.splits * (2 + dim) * MAX_ROWS,
                             dtype=torch.float32, device=q.device)
            counters = _build.zeroed_counters(
                _counters, q.device, stream, COUNTERS, "decode_attention")
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            entry["k_s"].data_ptr() if quant else None,
            entry["v_s"].data_ptr() if quant else None, out.data_ptr(),
            start_pos.data_ptr() if on_device else None,
            0 if on_device else start_pos,
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), COUNTERS,
            batch, t_new, heads, kv_heads, seq, dim, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k.dtype], _DTYPE_CODES[out.dtype],
            int(p.route == "tensor_cores"), int(p.vec), p.key_tile,
            p.row_stride, p.stages, p.splits, dim ** -0.5,
            stream.cuda_stream)
    _build.raise_on(err, lib.decode_attention_error_string,
                    "decode_attention", f" ({p})")
    decode_attention.launches += 1
    return out


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph the wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
decode_attention.launches = 0
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"decode_attention": decode_attention}

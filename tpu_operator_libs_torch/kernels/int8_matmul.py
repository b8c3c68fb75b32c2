"""The int8-weight matmul (W8A16): ``(x @ q) * s`` with int8 codes ``q``
that stay int8 in device memory.

Mirrors ``tpu_operator_libs/examples/llama_decode.py::_mm`` (``:135-143``)
for a quantized weight, which XLA fuses on the TPU (no Pallas source):
``(x @ q.astype(x.dtype)) * s.astype(x.dtype)``, x (M, K), q (K, N) int8
as ``quantize_params_int8`` stores it, s the float32 per-output-channel
scale (N,). :func:`int8_matmul` launches ``csrc/int8_matmul.cu`` for CUDA
tensors (float32 or bfloat16 x) and runs the plain version,
:func:`int8_matmul_reference`, for CPU ones.

:func:`plan` picks one of the source's four kernels from the shape, x's
dtype and the card's SM count alone: bf16 prefill (M at or above
:data:`WGMMA_MIN_M`, N and K aligned for TMA, output tiles enough for a
quarter of the card) runs ``wgmma``, a persistent warp-specialised GEMM
that converts the codes in registers (:func:`wgmma_tile` sizes its tiles,
:func:`wgmma_raster` orders them); the rest of bf16 with N and K aligned
for TMA (decode, short
prefill) runs ``stream_k``, a persistent grid of one block an SM over
equal runs of (tile, stage of K) units, the weight as ``mma.sync``'s A
operand; unaligned bf16 runs ``mma_sync`` over a ``cp.async`` ring, and
f32 runs f32 FMAs on the CUDA cores. The last three add the f32 sums of
a tile cut between blocks in a fixed order inside the one launch, so two
launches are bit-equal.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu_operator_libs_torch.kernels._build import (
    load,
    sm_count,
    zeroed_counters,
)

#: the CUDA source under ``csrc/``
SOURCE = "int8_matmul.cu"
#: columns a block owns and the most splits of K of the split-K designs
#: (``kBlockN``, ``kMaxSplits`` in the source)
BLOCK_N = 128
MAX_SPLITS = 16
#: rows of K a ring stage holds, by design: a split is a whole number of
#: stages (``mma::kStageK``, ``f32::kChunkK``)
STAGE_K = {"mma_sync": 128, "cuda_cores": 64}
#: bytes of codes a stage of the stream-K design holds: a tile's columns
#: by ``STREAM_K_STAGE_BYTES // block_n`` rows of K (``sk::kCodeBytes``)
STREAM_K_STAGE_BYTES = 16384
#: the stream-K design's consumer warps: one ticket counter each for
#: every block that a cut tile starts in (``sk::kWarps``)
STREAM_K_WARPS = 8
#: the fewest rows of bf16 x that the wgmma design takes, and the fewest
#: of its 64-row output tiles per SM: it does not split K, so with fewer
#: tiles the split-K mma.sync design was the faster of the two on an H100
#: (PERF.md, the int8 kernel's findings)
WGMMA_MIN_M = 64
WGMMA_MIN_TILES_PER_SM = 0.25
#: the wgmma design's tiles by their rows of x (each ``BLOCK_N`` output
#: columns), each with the share of the tensor cores' peak it ran a
#: (4096, 4096) x (4096, 4096) product at on an H100 (PERF.md, the int8
#: kernel's findings), which :func:`wgmma_tile` weighs against the waves
#: of tiles a shape takes
WGMMA_TILES = {256: 0.650, 128: 0.514, 64: 0.362}
#: row tiles a group of the wgmma design's raster (``wg::kGroupM``)
WGMMA_GROUP_M = 8
#: the designs, by the code the C entry takes
DESIGNS = {"wgmma": 1, "mma_sync": 2, "cuda_cores": 3, "stream_k": 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
#: split-K and stream-K ticket counters by (device index, stream):
#: STREAM_K_WARPS ints per SM, 0 between launches
_counters: "dict[tuple[int, int], torch.Tensor]" = {}


def int8_matmul_reference(x, q, s):
    """Plain PyTorch version: the product in x's dtype, rounded, times
    the scale rounded to x's dtype."""
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


def m_tile(m: int) -> int:
    """Rows of x a block of the CUDA-core design takes (``f32::m_tile``
    in the source)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


def mma_rows(m: int) -> int:
    """Rows of x a block of the mma.sync design takes: one mma's n of 8
    at decode, else 32, so that each converted code serves 32 rows of x
    (``mma::launch`` in the source)."""
    return 8 if m <= 8 else 32


def stream_k_rows(m: int) -> int:
    """Rows of x a tile of the stream-K design holds: the fewest of 8, 16
    and 32 that hold m (each converted code serves that many), 32 above
    (``sk::launch_boxes`` in the source)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs an (m, k) x (k, n) product."""

    #: "wgmma", "stream_k", "mma_sync" or "cuda_cores"
    design: str
    #: rows of x a tile takes: of :data:`WGMMA_TILES` (wgmma),
    #: :func:`stream_k_rows` (stream_k), :func:`mma_rows` (mma_sync),
    #: :func:`m_tile` (cuda_cores)
    block_m: int
    #: blocks that K is split over (1 for wgmma and stream_k) and rows of
    #: K each
    splits: int
    k_per_split: int
    #: the persistent grid of the wgmma and stream_k designs (0 for the
    #: others)
    blocks: int = 0
    #: columns a tile: 128, or 256 for a stream_k plan whose stages read
    #: two code boxes side by side
    block_n: int = BLOCK_N


def plan(m: int, k: int, n: int, dtype: torch.dtype, sms: int) -> Plan:
    """The design and tiling of an (m, k) x (k, n) product with x of
    ``dtype`` on a card of ``sms`` SMs; a function of these alone, so a
    shape always runs the same sums in the same order.

    bf16 x with m >= :data:`WGMMA_MIN_M`, n % 16 == 0 and k % 8 == 0 (the
    16-byte row strides TMA needs) and 64-row output tiles for at least
    :data:`WGMMA_MIN_TILES_PER_SM` of the SMs takes the wgmma design: the
    tile of :func:`wgmma_tile`, a persistent grid of one block an SM (or
    a tile, where the tiles are fewer); no split-K. Unaligned bf16 takes
    the mma.sync design (:func:`mma_rows` rows a block), f32 the CUDA
    cores (:func:`m_tile` rows a block); both with as many K splits as
    keep the blocks within one wave (at least one, at most ``MAX_SPLITS``
    and one a ring stage of K), each a whole number of stages.

    The rest of bf16 with n % 16 == 0 and k % 8 == 0 takes the stream-K
    design: :func:`stream_k_rows` rows a tile, 128 columns where the grid
    of :func:`stream_k_grid` is tile-aligned at that width, else 256
    (every row of K read 256 contiguous bytes at a time: the wide
    products, gate and up and the head, measured faster so on an H100,
    PERF.md's int8 findings); :func:`stream_ranges` gives each block's
    units. Only unaligned bf16 takes mma.sync."""
    aligned = n % 16 == 0 and k % 8 == 0
    if dtype == torch.bfloat16 and aligned and m >= WGMMA_MIN_M \
            and -(-m // 64) * -(-n // BLOCK_N) \
            >= WGMMA_MIN_TILES_PER_SM * sms:
        block_m = wgmma_tile(m, n, sms)
        tiles = -(-m // block_m) * -(-n // BLOCK_N)
        return Plan("wgmma", block_m, 1, k, min(tiles, sms))
    if dtype == torch.bfloat16 and aligned:
        block_m = stream_k_rows(m)
        blocks, tile_aligned = stream_k_grid(m, k, n, block_m, BLOCK_N, sms)
        if tile_aligned:
            return Plan("stream_k", block_m, 1, k, blocks, BLOCK_N)
        blocks, _ = stream_k_grid(m, k, n, block_m, 2 * BLOCK_N, sms)
        return Plan("stream_k", block_m, 1, k, blocks, 2 * BLOCK_N)
    return split_plan(m, k, n, dtype, sms)


def wgmma_tile(m: int, n: int, sms: int) -> int:
    """The rows of x of the wgmma design's tile (by ``BLOCK_N`` columns)
    for an (m, k) x (k, n) product on a card of ``sms`` SMs: of
    :data:`WGMMA_TILES`, the one whose waves of tiles (one a block, one
    block an SM) cost the least time, a wave's time its tile's rows over
    its share of the peak; the first in the table where two tie. K does
    not enter: every tile walks all of it."""
    def cost(rows):
        tiles = -(-m // rows) * -(-n // BLOCK_N)
        return -(-tiles // sms) * rows / WGMMA_TILES[rows]
    return min(WGMMA_TILES, key=cost)


def wgmma_raster(m: int, n: int, block_m: int) -> "list[tuple[int, int]]":
    """The wgmma design's tiles in the order the grid takes them, as (row
    tile, column tile) (``wg::Raster`` in the source): groups of
    :data:`WGMMA_GROUP_M` row tiles (fewer in the last), each walked
    column tile by column tile, so that the tiles the card runs at once
    share rows of x and columns of codes in L2. Block b of a grid of G
    takes tiles b, b + G, b + 2G, ..."""
    m_tiles, n_tiles = -(-m // block_m), -(-n // BLOCK_N)
    order = []
    for u in range(m_tiles * n_tiles):
        group, r = divmod(u, WGMMA_GROUP_M * n_tiles)
        first = group * WGMMA_GROUP_M
        rows = min(m_tiles - first, WGMMA_GROUP_M)
        order.append((first + r % rows, r // rows))
    return order


def split_plan(m: int, k: int, n: int, dtype: torch.dtype,
               sms: int) -> Plan:
    """The split-K plan of the mma.sync design (bf16) or the CUDA-core
    design (f32): as many K splits as keep the blocks within one wave,
    each a whole number of ring stages. :func:`plan` gives it to
    unaligned bf16 and to f32."""
    design, block_m = (("mma_sync", mma_rows(m)) if dtype == torch.bfloat16
                       else ("cuda_cores", m_tile(m)))
    tiles = -(-n // BLOCK_N) * -(-m // block_m)
    stages = -(-k // STAGE_K[design])
    splits = max(1, min(sms // tiles, stages, MAX_SPLITS))
    k_per_split = -(-stages // splits) * STAGE_K[design]
    return Plan(design, block_m, -(-k // k_per_split), k_per_split)


def stream_k_stage_k(block_n: int) -> int:
    """Rows of K a stage of a stream-K tile ``block_n`` columns wide
    holds (``sk::Tile::kStageK``)."""
    return STREAM_K_STAGE_BYTES // block_n


def stream_k_units(m: int, k: int, n: int, block_m: int,
                   block_n: int) -> int:
    """The stream-K design's units of work: output tiles (``block_n``
    columns by ``block_m`` rows) times stages of K."""
    return (-(-n // block_n) * -(-m // block_m)
            * -(-k // stream_k_stage_k(block_n)))


def stream_k_grid(m: int, k: int, n: int, block_m: int, block_n: int,
                  sms: int) -> "tuple[int, bool]":
    """The stream-K design's grid at a tile width, and whether it is
    tile-aligned: one block an SM (or a unit, where the units are fewer),
    each taking an equal run of units; or, where the tiles are no more
    than the SMs, ``tiles * (sms // tiles)`` blocks, whose runs then
    start at tile boundaries (every block one tile, so no block takes a
    second ticket), unless that leaves a block more than an eighth more
    stages than one an SM would. On an H100 the tile-aligned grid
    measured up to 2.4 us faster a launch at the decode shapes where both
    take about as many stages a block (PERF.md's int8 findings)."""
    tiles = -(-n // block_n) * -(-m // block_m)
    stages = -(-k // stream_k_stage_k(block_n))
    units = tiles * stages
    streamed = min(sms, units)
    if tiles <= sms:
        per = min(sms // tiles, stages)
        if 8 * -(-stages // per) <= 9 * -(-units // streamed):
            return tiles * per, True
    return streamed, False


def stream_ranges(p: Plan, m: int, k: int, n: int) -> "list[range]":
    """The units each block of a stream-K plan takes, in block order
    (``sk::Split`` in the source): contiguous runs, tile-major (tile =
    column tile * row tiles + row tile, stages of K inside), from
    ``units * b // blocks`` to ``units * (b + 1) // blocks``."""
    units = stream_k_units(m, k, n, p.block_m, p.block_n)
    return [range(units * b // p.blocks, units * (b + 1) // p.blocks)
            for b in range(p.blocks)]


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
        _lib = load(SOURCE, {
            "int8_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
            + [ctypes.c_void_p]}, "int8_matmul_error_string")
    return _lib


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
    sms = sm_count(x.device.index)
    p = plan(m, k, n, x.dtype, sms)
    if p.design == "stream_k" and (x.data_ptr() % 16 or q.data_ptr() % 16):
        # TMA takes 16-byte aligned bases; a view that starts elsewhere
        # takes the cp.async design, which loads bytewise where it must
        p = split_plan(m, k, n, x.dtype, sms)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        partial = counters = None
        if p.design == "stream_k":
            # a slot of a tile's f32 sums for the first and the last tile
            # of every block; allocated here, so inside a captured graph
            # it comes from the graph's pool
            partial = torch.empty((2 * p.blocks, p.block_m, p.block_n),
                                  dtype=torch.float32, device=x.device)
        elif p.splits > 1:
            # the split-K workspace
            partial = torch.empty((p.splits, m, n), dtype=torch.float32,
                                  device=x.device)
        if partial is not None:
            # a product that splits K has at most sms / 2 tiles; a
            # stream-K grid at most sms blocks of STREAM_K_WARPS warps
            counters = zeroed_counters(_counters, x.device, stream,
                                       STREAM_K_WARPS * sms, "int8_matmul")
        err = lib.int8_matmul(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(),
            0 if counters is None else counters.numel(), m, k, n,
            DESIGNS[p.design], p.block_m, p.block_n, p.splits,
            p.k_per_split, p.blocks, _DTYPE_CODES[x.dtype],
            stream.cuda_stream)
    if err != 0:
        message = lib.int8_matmul_error_string(err).decode()
        hint = ("; the tensor-core design needs x and q 16-byte aligned"
                if p.design == "wgmma" else "")
        raise RuntimeError(f"int8_matmul launch failed ({p}): {message} "
                           f"({err}){hint}")
    int8_matmul.launches += 1
    int8_matmul.launches_by_design[p.design] = \
        int8_matmul.launches_by_design.get(p.design, 0) + 1
    return out


#: Kernel launches since the last reset (the plain CPU path adds none).
#: Inside a captured CUDA graph the wrapper runs once, at capture; the
#: graph's caller adds its replays (``llama_decode.generate_on_device``).
int8_matmul.launches = 0
#: the same launches by :class:`Plan` design
int8_matmul.launches_by_design = {}
#: the kernel's wrapper, by the name its launch count reports under
WRAPPERS = {"int8_matmul": int8_matmul}

"""The int8-weight matmul's plain version against the JAX package's
``_mm`` on the CPU, its wrapper's checks, its plan (which design and
tiling a shape takes) and emulations of the split-K designs' sums in
their order. The CUDA kernel itself is held to the plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 3d)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import INT8_SHAPES, KERNEL_TOL, int8_limit
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.kernels import int8_matmul as kmod
from tpu_operator_libs_torch.kernels.int8_matmul import (
    Plan,
    int8_matmul,
    plan,
)

#: f32 on both sides: the products are exact, the sums differ in order
F32_TOL = {"rtol": 1e-5, "atol": 1e-6}
#: bf16: both sum in f32 and round to bf16 at the same two points; one
#: bf16 ulp, at most 2^-7 of the value
BF16_RTOL = 2.0 ** -7

#: (M, K, N): decode rows, prefill rows, tp shards (a column-parallel
#: weight's N and a row-parallel one's K halved) and a ragged shape
SHAPES = [(1, 256, 128), (8, 256, 128), (512, 256, 128), (8, 256, 64),
          (8, 128, 128), (3, 200, 100)]
SHAPE_IDS = ["m1", "m8", "m512", "tp2_column", "tp2_row", "ragged"]


def operands(m, k, n, seed=0):
    """x, and a weight quantized as ``quantize_params_int8`` does, from a
    numpy generator: (x f32, q int8, s f32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    q, s = tdecode._sym_int8(torch.from_numpy(w), axis=0)
    return x, q.numpy(), s.numpy()


def jax_mm(x, q, s, dtype):
    return np.asarray(jdecode._mm(jnp.asarray(x).astype(dtype),
                                  {"q": jnp.asarray(q), "s": jnp.asarray(s)})
                      .astype(jnp.float32))


@pytest.mark.parametrize("m,k,n", SHAPES, ids=SHAPE_IDS)
def test_f32_matches_jax(m, k, n):
    x, q, s = operands(m, k, n)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), jax_mm(x, q, s, jnp.float32),
                               **F32_TOL)


@pytest.mark.parametrize("m,k,n", SHAPES, ids=SHAPE_IDS)
def test_bf16_matches_jax_within_one_ulp(m, k, n):
    x, q, s = operands(m, k, n, seed=1)
    got = int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = jax_mm(x, q, s, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=0)


def test_mm_runs_it_over_leading_axes():
    x, q, s = operands(6, 64, 32, seed=2)
    w = {"q": torch.from_numpy(q), "s": torch.from_numpy(s)}
    x3 = torch.from_numpy(x).reshape(2, 3, 64)
    got = tdecode._mm(x3, w)
    assert got.shape == (2, 3, 32)
    want = int8_matmul(torch.from_numpy(x), w["q"], w["s"])
    assert torch.equal(got.reshape(6, 32), want)


def test_cpu_calls_count_no_launch():
    x, q, s = operands(2, 64, 32)
    before = int8_matmul.launches
    int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert int8_matmul.launches == before


class TestRejects:
    def args(self):
        x, q, s = operands(4, 64, 32)
        return torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s)

    @pytest.mark.parametrize("which,bad", [
        ("q", lambda q: q.to(torch.int16)),
        ("q", lambda q: q.float()),
        ("s", lambda s: s.double()),
    ], ids=["q_int16", "q_float", "s_double"])
    def test_wrong_dtype(self, which, bad):
        x, q, s = self.args()
        kw = {"x": x, "q": q, "s": s}
        kw[which] = bad(kw[which])
        with pytest.raises(ValueError, match="int8|float32"):
            int8_matmul(**kw)

    @pytest.mark.parametrize("which,bad", [
        ("x", lambda x: x[:, :32].contiguous()),
        ("x", lambda x: x[None]),
        ("s", lambda s: s[:16].contiguous()),
        ("q", lambda q: q[None]),
    ], ids=["x_k", "x_3d", "s_n", "q_3d"])
    def test_wrong_shape(self, which, bad):
        x, q, s = self.args()
        kw = {"x": x, "q": q, "s": s}
        kw[which] = bad(kw[which])
        with pytest.raises(ValueError, match=r"\(M, K\)"):
            int8_matmul(**kw)

    def test_non_contiguous(self):
        x, q, s = self.args()
        with pytest.raises(ValueError, match="contiguous"):
            int8_matmul(x, q.t().contiguous().t(), s)


#: an H100's SMs
H100_SMS = 132


def check_plan(p, m, k, n, sms):
    """The invariants of a plan: the split-K designs cover K once with
    whole ring stages within one wave of blocks; the wgmma design takes
    all of K in 64- or 128-row tiles; the stream-K design's blocks take
    every (tile, stage) unit once, in contiguous runs in block order,
    equal to within one stage, within one wave."""
    if p.design == "wgmma":
        assert (p.splits, p.k_per_split) == (1, k)
        assert p.block_n == kmod.BLOCK_N
        assert p.block_m == kmod.wgmma_tile(m, n, sms)
        tiles = -(-m // p.block_m) * -(-n // p.block_n)
        assert p.blocks == min(tiles, sms)
        return
    if p.design == "stream_k":
        assert (p.splits, p.k_per_split) == (1, k)
        assert p.block_m == kmod.stream_k_rows(m)
        assert p.block_n in (128, 256)
        units = kmod.stream_k_units(m, k, n, p.block_m, p.block_n)
        ranges = kmod.stream_ranges(p, m, k, n)
        assert [u for r in ranges for u in r] == list(range(units))
        assert all(len(r) >= 1 for r in ranges)
        assert max(map(len, ranges)) - min(map(len, ranges)) <= 1
        assert 1 <= p.blocks <= min(sms, units)
        return
    assert p.block_m == {"mma_sync": kmod.mma_rows(m),
                         "cuda_cores": kmod.m_tile(m)}[p.design]
    assert p.k_per_split % kmod.STAGE_K[p.design] == 0
    # every row of K in exactly one split, none empty
    assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
    assert 1 <= p.splits <= kmod.MAX_SPLITS
    tiles = -(-n // kmod.BLOCK_N) * -(-m // p.block_m)
    assert p.splits == 1 or tiles * p.splits <= sms
    # the split-K counters hold one int an SM
    assert p.splits == 1 or tiles <= sms // 2


class TestSplitPlan:
    @pytest.mark.parametrize("m,k,n", [
        (8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048), (2, 2048, 2048),
        (512, 2048, 2048), (512, 8192, 2048), (4, 1024, 2048),
        (4, 4096, 2048), (3, 2000, 1000), (1, 100, 10), (8, 257, 128)])
    @pytest.mark.parametrize("sms", [1, 132])
    def test_splits_cover_k_once_within_a_wave(self, m, k, n, sms):
        for dtype in (torch.bfloat16, torch.float32):
            check_plan(plan(m, k, n, dtype, sms), m, k, n, sms)

    @pytest.mark.parametrize("m,k,n,dtype,want", [
        # the bench shape's decode products have 16 or 64 column strips
        # for 132 SMs: 128 blocks, each a tile's run of K
        (8, 2048, 2048, torch.bfloat16,
         Plan("stream_k", 8, 1, 2048, 128, 128)),
        (8, 2048, 8192, torch.bfloat16,
         Plan("stream_k", 8, 1, 2048, 128, 128)),
        (8, 8192, 2048, torch.bfloat16,
         Plan("stream_k", 8, 1, 8192, 128, 128)),
        # the chat cell's products at 16 rows: q, k, v, o and down split
        # K over 4 and 8 blocks a 128-column tile; gate and up take
        # 256-column tiles, 3 blocks each; the head streams 800 tiles
        # over every SM
        (16, 4096, 4096, torch.bfloat16,
         Plan("stream_k", 16, 1, 4096, 128, 128)),
        (16, 4096, 11008, torch.bfloat16,
         Plan("stream_k", 16, 1, 4096, 129, 256)),
        (16, 11008, 4096, torch.bfloat16,
         Plan("stream_k", 16, 1, 11008, 128, 128)),
        (16, 4096, 102400, torch.bfloat16,
         Plan("stream_k", 16, 1, 4096, 132, 256)),
        # codes TMA cannot take still split K over the cp.async ring
        (8, 2048, 1000, torch.bfloat16, Plan("mma_sync", 8, 16, 128)),
        # prefill takes wgmma, f32 the CUDA cores
        (512, 2048, 2048, torch.bfloat16,
         Plan("wgmma", 64, 1, 2048, 128, 128)),
        (8, 2048, 2048, torch.float32, Plan("cuda_cores", 8, 8, 256))],
        ids=["bench_qkvo", "bench_gate_up", "bench_down", "chat_qkvo",
             "chat_gate_up", "chat_down", "chat_head", "unaligned_n",
             "prefill", "f32"])
    def test_decode_shapes_split_k_on_an_h100(self, m, k, n, dtype, want):
        p = plan(m, k, n, dtype, 132)
        assert p == want
        check_plan(p, m, k, n, 132)

    @pytest.mark.parametrize("m,want", [(1, 1), (2, 2), (3, 4), (4, 4),
                                        (5, 8), (512, 8)])
    def test_m_tile(self, m, want):
        assert kmod.m_tile(m) == want

    @pytest.mark.parametrize("m,want,tile", [
        (1, 8, 8), (8, 8, 8), (9, 32, 16), (16, 32, 16), (17, 32, 32),
        (32, 32, 32), (63, 32, 32), (512, 32, 32)])
    def test_mma_rows(self, m, want, tile):
        # the cp.async design: decode fills one mma's n of 8, more rows
        # share each converted code among 32; the stream-K design's tile
        # is the fewest of 8, 16 and 32 rows that hold m, so 16 rows run
        # 2 mma a converted fragment, not 4
        assert kmod.mma_rows(m) == want
        assert kmod.stream_k_rows(m) == tile


class TestPlan:
    @pytest.mark.parametrize("m,n,want", [
        (1, 2048, "stream_k"), (8, 2048, "stream_k"),
        (62, 8192, "stream_k"), (63, 8192, "stream_k"),
        (64, 8192, "wgmma"), (65, 8192, "wgmma"),
        # at N 2048 the 64-row tiles fill a quarter of 132 SMs from 129
        # rows on (3 x 16 of them)
        (64, 2048, "stream_k"), (100, 2048, "stream_k"),
        (128, 2048, "stream_k"), (129, 2048, "wgmma"),
        (500, 2048, "wgmma"), (512, 2048, "wgmma"), (4096, 2048, "wgmma"),
        # never below WGMMA_MIN_M rows, however wide
        (32, 65536, "stream_k")])
    def test_bf16_takes_wgmma_from_the_threshold(self, m, n, want):
        p = plan(m, 2048, n, torch.bfloat16, H100_SMS)
        assert p.design == want
        check_plan(p, m, 2048, n, H100_SMS)

    def test_the_threshold_scales_with_the_card(self):
        # a quarter of 66 SMs is 16.5 tiles: 2 x 16 at N 2048
        assert plan(65, 2048, 2048, torch.bfloat16, 66).design == "wgmma"
        assert plan(64, 2048, 2048, torch.bfloat16, 66).design \
            == "stream_k"

    @pytest.mark.parametrize("m", [1, 8, 64, 512])
    def test_f32_stays_on_the_cuda_cores(self, m):
        p = plan(m, 2048, 2048, torch.float32, H100_SMS)
        assert p.design == "cuda_cores"
        check_plan(p, m, 2048, 2048, H100_SMS)

    @pytest.mark.parametrize("k,n", [(2048, 1000), (2048, 1032),
                                     (2044, 2048), (2001, 2048), (13, 7)],
                             ids=["n_mod_16_is_8", "n_mod_16_is_8_wide",
                                  "k_mod_8_is_4", "k_odd", "both"])
    def test_shapes_tma_cannot_take_go_to_mma_sync(self, k, n):
        # TMA needs 16-byte row strides: n % 16 == 0 for the int8 codes,
        # k % 8 == 0 for bf16 x; decided from the shape, before a launch
        p = plan(512, k, n, torch.bfloat16, H100_SMS)
        assert p.design == "mma_sync"
        check_plan(p, 512, k, n, H100_SMS)

    @pytest.mark.parametrize("k,n", [(2040, 2048), (2048, 1040),
                                     (2040, 1040)],
                             ids=["k_mod_64_is_56", "n_mod_128_is_16",
                                  "both"])
    def test_ragged_tiles_stay_on_wgmma(self, k, n):
        # TMA takes rows 16-byte aligned but not whole tiles: it fills
        # the last K tile past K with zeros, the epilogue masks columns
        # past N, so these take the tensor cores
        p = plan(512, k, n, torch.bfloat16, H100_SMS)
        assert (p.design, p.splits, p.k_per_split) == ("wgmma", 1, k)

    @pytest.mark.parametrize("m,n,want", [
        (512, 2048, 64),     # 32 tiles of 256 rows, 128 of 64: one wave
        (512, 8192, 256),    # 128 tiles of 256 rows: one wave
        # one row tile: 256 tiles of 256 or 128 rows take two waves, so
        # the smaller wins
        (100, 32768, 128),
        # 64 tiles of 256 rows fill half the card, 96 of 128 rows more
        (384, 4096, 128),
        (4096, 2048, 256), (1024, 4096, 256)])
    def test_tensor_core_tile_rows(self, m, n, want):
        p = plan(m, 2048, n, torch.bfloat16, H100_SMS)
        assert (p.block_m, p.block_n) == (want, kmod.BLOCK_N)

    @pytest.mark.parametrize("shape", INT8_SHAPES,
                             ids=[shape[0] for shape in INT8_SHAPES])
    def test_every_chip_smoke_shape_on_an_h100(self, shape):
        _, m, k, n, dtype, _ = shape
        p = plan(m, k, n, dtype, H100_SMS)
        check_plan(p, m, k, n, H100_SMS)
        aligned = n % 16 == 0 and k % 8 == 0
        tiles = -(-m // 64) * -(-n // kmod.BLOCK_N)
        if dtype == torch.float32:
            assert p.design == "cuda_cores"
        else:
            assert p.design == ("wgmma" if m >= kmod.WGMMA_MIN_M and aligned
                                and 4 * tiles >= H100_SMS else "stream_k"
                                if aligned else "mma_sync")

    def test_a_function_of_the_shape_dtype_and_card_alone(self):
        args = (8, 2048, 2048, torch.bfloat16, H100_SMS)
        assert plan(*args) == plan(*args)
        assert plan(8, 2048, 2048, torch.bfloat16, 66) \
            == Plan("stream_k", 8, 1, 2048, 64, 128)
        assert kmod.split_plan(8, 2048, 2048, torch.bfloat16, 66) \
            == Plan("mma_sync", 8, 4, 512)


def mma_sums(x, q, p):
    """The mma.sync design's f32 sums of x @ q in the kernel's order
    (``csrc/int8_matmul.cu::int8_matmul_mma_kernel``), in numpy: x as f32
    (bf16 values), q int8, ``p`` its plan. In each split, warp w (of 8)
    of a block adds rows [16 w, 16 w + 16) of every 128-row stage of K in
    turn, one mma each: the 16 exact products are summed and added to the
    warp's f32 sums (here with one rounding each; the tensor cores' own
    order within an mma is not the CPU's); the eight warps add in order,
    and the splits in split order."""
    m, k = x.shape
    x64 = x.astype(np.float64)
    q64 = q.astype(np.float64)
    total = None
    for split in range(p.splits):
        k0 = split * p.k_per_split
        k1 = min(k, k0 + p.k_per_split)
        acc = [np.zeros((m, q.shape[1]), np.float32) for _ in range(8)]
        for c0 in range(k0, k1, kmod.STAGE_K["mma_sync"]):
            for w in range(8):
                r0, r1 = c0 + 16 * w, min(k1, c0 + 16 * w + 16)
                if r0 < r1:
                    step = (x64[:, r0:r1] @ q64[r0:r1]).astype(np.float32)
                    acc[w] = acc[w] + step
        block = acc[0]
        for w in range(1, 8):
            block = block + acc[w]
        total = block if total is None else total + block
    return total


def cuda_core_sums(x, q, p):
    """The CUDA-core (f32) design's f32 sums of x @ q in the kernel's
    order (``csrc/int8_matmul.cu::int8_matmul_kernel``), in numpy: ``p``
    its plan. In each split, thread group g (of 32) of a block adds rows
    2g and 2g + 1 of every 64-row stage of K in turn, one fused
    multiply-add each; a warp's four groups add as (g0 + g1) + (g2 + g3),
    the eight warps in order, and the splits in split order."""
    m, k = x.shape
    n = q.shape[1]
    x32 = x.astype(np.float32)
    q32 = q.astype(np.float32)
    total = None
    for split in range(p.splits):
        k0 = split * p.k_per_split
        k1 = min(k, k0 + p.k_per_split)
        acc = np.zeros((32, m, n), np.float32)  # by thread group
        for c0 in range(k0, k1, kmod.STAGE_K["cuda_cores"]):
            for h in range(2):
                rows = c0 + 2 * np.arange(32) + h
                ok = rows < k1
                r = np.where(ok, rows, 0)
                # an f32 product of x and a code is exact, so an f32 add
                # of it rounds as the fused multiply-add does
                prod = x32[:, r].T[:, :, None] * q32[r][:, None, :]
                acc += np.where(ok[:, None, None], prod, np.float32(0))
        warps = (acc[0::4] + acc[1::4]) + (acc[2::4] + acc[3::4])
        block = warps[0]
        for w in range(1, 8):
            block = block + warps[w]
        total = block if total is None else total + block
    return total


def stream_k_sums(x, q, p):
    """The stream-K design's f32 sums of x @ q in the kernel's order
    (``csrc/int8_matmul.cu::int8_matmul_streamk_kernel``), in numpy:
    ``p`` its plan. Each block walks its run of (tile, stage) units in
    order, adding each 16-row k-step of a stage to its f32 sums of the
    tile as one mma (the 16 exact products summed, one rounding, as in
    :func:`mma_sums`); a tile cut between blocks is each block's sums
    added in block order."""
    m, k = x.shape
    n = q.shape[1]
    stage_k = kmod.stream_k_stage_k(p.block_n)
    stages = -(-k // stage_k)
    m_tiles = -(-m // p.block_m)
    x64 = x.astype(np.float64)
    q64 = q.astype(np.float64)
    parts = {}  # tile -> {block: its f32 sums}
    for b, units in enumerate(kmod.stream_ranges(p, m, k, n)):
        for u in units:
            tile, stage = divmod(u, stages)
            n_tile, m_tile = divmod(tile, m_tiles)
            rows = slice(m_tile * p.block_m, min(m, (m_tile + 1) * p.block_m))
            cols = slice(n_tile * p.block_n, min(n, (n_tile + 1) * p.block_n))
            acc = parts.setdefault(tile, {}).setdefault(
                b, np.zeros((rows.stop - rows.start, cols.stop - cols.start),
                            np.float32))
            for r0 in range(stage * stage_k, min(k, (stage + 1) * stage_k),
                            16):
                acc += (x64[rows, r0:r0 + 16] @ q64[r0:r0 + 16, cols]
                        ).astype(np.float32)
    out = np.zeros((m, n), np.float32)
    for tile, by_block in parts.items():
        n_tile, m_tile = divmod(tile, m_tiles)
        total = None
        for b in sorted(by_block):
            total = by_block[b] if total is None else total + by_block[b]
        out[m_tile * p.block_m:(m_tile + 1) * p.block_m,
            n_tile * p.block_n:(n_tile + 1) * p.block_n] = total
    return out


def epilogue(sums, s, dtype):
    """The kernels' two roundings: the f32 sum to x's dtype, then its
    product with the scale rounded to x's dtype."""
    t = torch.from_numpy(sums).to(dtype)
    return (t * torch.from_numpy(s).to(dtype)).float().numpy()


class TestSumOrder:
    @pytest.mark.parametrize("m,k,n,sms", [
        (8, 256, 128, H100_SMS),     # 2 splits of one stage
        (8, 512, 256, H100_SMS),     # 4 splits, 2 strips
        (2, 1000, 128, H100_SMS),    # a ragged last stage
        (3, 200, 100, H100_SMS),     # ragged everything
        (8, 512, 128, 1),            # no split: one block walks all of K
        (63, 256, 128, H100_SMS)],   # below the threshold: 8 row tiles
        ids=["splits2", "splits4", "ragged_stage", "ragged",
             "one_split", "m63"])
    def test_mma_sync_bf16_matches_jax_within_one_ulp(self, m, k, n, sms):
        x, q, s = operands(m, k, n, seed=3)
        xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        # the cp.async design's plan, which unaligned shapes take
        p = kmod.split_plan(m, k, n, torch.bfloat16, sms)
        assert p.design == "mma_sync"
        got = epilogue(mma_sums(xb, q, p), s, torch.bfloat16)
        want = jax_mm(x, q, s, jnp.bfloat16)
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0)

    @pytest.mark.parametrize("m,k,n,splits", [(8, 2048, 2048, 8),
                                              (4, 2048, 128, 16)],
                             ids=["bench_splits8", "splits16"])
    def test_mma_sync_bf16_long_k_within_the_card_limit(self, m, k, n,
                                                         splits):
        # from K ~ 1000 an f32 sum near 0 summed in another order may
        # round to bf16 an ulp apart twice, off by more than an ulp of
        # the (small) output: the card holds the kernel to chip_smoke's
        # int8_limit, an rtol for each rounding, and so is this
        x, q, s = operands(m, k, n, seed=3)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        p = kmod.split_plan(m, k, n, torch.bfloat16, H100_SMS)
        assert (p.design, p.splits) == ("mma_sync", splits)
        got = epilogue(mma_sums(xb.float().numpy(), q, p), s,
                       torch.bfloat16)
        assert got.shape == (m, n)
        want = jax_mm(x, q, s, jnp.bfloat16)
        pre_scale = ((xb @ torch.from_numpy(q).to(torch.bfloat16)).float()
                     .abs() * torch.from_numpy(s).to(torch.bfloat16).float())
        limit = int8_limit(torch.tensor(want), pre_scale,
                           torch.bfloat16).numpy()
        assert (np.abs(got - want) <= limit).all()

    @pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (3, 200, 100),
                                       (1, 1000, 128)],
                             ids=["bench_splits8", "ragged", "m1"])
    def test_cuda_cores_f32_matches_jax(self, m, k, n):
        # held where the card holds the kernel (chip_smoke.KERNEL_TOL): at
        # K = 2048 the two orders of an f32 sum near 0 differ by more than
        # F32_TOL's atol, which is for K <= 256
        x, q, s = operands(m, k, n, seed=4)
        p = plan(m, k, n, torch.float32, H100_SMS)
        assert p.design == "cuda_cores"
        got = epilogue(cuda_core_sums(x, q, p), s, torch.float32)
        rtol, atol = KERNEL_TOL[torch.float32]
        np.testing.assert_allclose(got, jax_mm(x, q, s, jnp.float32),
                                   rtol=rtol, atol=atol)

    def test_split_order_is_fixed(self):
        # the fixup adds the splits' partials in split order 0..S-1,
        # whichever block draws the last ticket: the emulation's sums are
        # each split's own sums added in that order, bit for bit; and an
        # order that followed the blocks' arrival (here the reverse) rounds
        # differently, so the fixed order is what keeps launches bit-equal
        x, q, _ = operands(8, 2048, 2048, seed=5)
        p = plan(8, 2048, 2048, torch.float32, H100_SMS)
        assert p.splits == 8
        parts = [cuda_core_sums(x[:, k0:k0 + p.k_per_split],
                                q[k0:k0 + p.k_per_split],
                                Plan(p.design, p.block_m, 1, p.k_per_split))
                 for k0 in range(0, 2048, p.k_per_split)]
        in_order = parts[0]
        for part in parts[1:]:
            in_order = in_order + part
        assert np.array_equal(cuda_core_sums(x, q, p), in_order)
        reverse = parts[-1]
        for part in parts[-2::-1]:
            reverse = reverse + part
        assert not np.array_equal(in_order, reverse)


class TestStreamK:
    """The stream-K design's plan and its sums' order (the kernel itself
    runs on the card: ``tests/test_torch_gpu.py``)."""

    #: (M, K, N) of the chat cell's products at 16 rows
    CHAT = [(16, 4096, 4096), (16, 4096, 11008), (16, 11008, 4096),
            (16, 4096, 102400)]

    @pytest.mark.parametrize("m,k,n", CHAT,
                             ids=["qkvo", "gate_up", "down", "head"])
    def test_chat_products_fill_the_card(self, m, k, n):
        p = plan(m, k, n, torch.bfloat16, H100_SMS)
        assert p.design == "stream_k" and p.block_m == 16
        check_plan(p, m, k, n, H100_SMS)
        # no more than 4 of the 132 SMs idle, every block within one
        # stage of every other
        assert p.blocks >= H100_SMS - 4
        assert plan(m, k, n, torch.bfloat16, H100_SMS) == p

    @pytest.mark.parametrize("m,k,n", [
        (8, 2048, 2048), (16, 4096, 4096), (16, 11008, 4096),
        (63, 4096, 4096), (4, 1024, 2048), (3, 1960, 256)])
    def test_aligned_grids_give_every_block_one_tile(self, m, k, n):
        # where the tiles are few, each block's run lies in one tile, so
        # no block takes two tickets
        p = plan(m, k, n, torch.bfloat16, H100_SMS)
        stages = -(-k // kmod.stream_k_stage_k(p.block_n))
        for r in kmod.stream_ranges(p, m, k, n):
            assert r[0] // stages == r[-1] // stages

    @pytest.mark.parametrize("sms", [1, 5, 66, 132, 200])
    @pytest.mark.parametrize("m,k,n", [
        (1, 8, 16), (16, 4096, 11008), (16, 4096, 102400), (9, 1000, 1040),
        (40, 2048, 2048), (63, 2048, 8192)])
    def test_runs_cover_every_unit_once(self, m, k, n, sms):
        p = plan(m, k, n, torch.bfloat16, sms)
        assert p.design == "stream_k"
        check_plan(p, m, k, n, sms)
        assert p == plan(m, k, n, torch.bfloat16, sms)

    def test_a_wide_product_streams_its_tiles_over_every_sm(self):
        # 400 tiles of 256 columns for 132 SMs: runs of 193-194 stages,
        # each cut tile's blocks in one contiguous run of blocks
        p = plan(16, 4096, 102400, torch.bfloat16, H100_SMS)
        ranges = kmod.stream_ranges(p, 16, 4096, 102400)
        assert sorted({len(r) for r in ranges}) == [193, 194]
        stages = 4096 // kmod.stream_k_stage_k(256)
        cut = {r[0] // stages for r in ranges if r[0] % stages}
        assert len(cut) == sum(1 for r in ranges if r[0] % stages)

    @pytest.mark.parametrize("m,k,n,sms", [
        (8, 256, 128, H100_SMS),    # 2 blocks of one stage
        (16, 512, 256, H100_SMS),   # aligned: 4 blocks a tile
        (3, 200, 96, H100_SMS),     # ragged K and N
        (40, 256, 256, H100_SMS),   # two row tiles
        (16, 512, 1024, 5),         # 256 columns, cut tiles
        (9, 512, 384, 3)],          # cut tiles, a partial 256 tile
        ids=["two_blocks", "aligned", "ragged", "two_row_tiles",
             "cut_tiles", "cut_partial_tile"])
    def test_bf16_matches_jax_within_one_ulp(self, m, k, n, sms):
        x, q, s = operands(m, k, n, seed=6)
        xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        p = plan(m, k, n, torch.bfloat16, sms)
        assert p.design == "stream_k"
        got = epilogue(stream_k_sums(xb, q, p), s, torch.bfloat16)
        want = jax_mm(x, q, s, jnp.bfloat16)
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0)

    def test_cut_tiles_add_in_block_order(self):
        # a cut tile's sums are its blocks' own sums added in block
        # order, whichever warp draws the last ticket: the emulation
        # matches that bit for bit, and an order that followed the
        # blocks' arrival (here the reverse) rounds differently
        m, k, n = 8, 2048, 128
        x, q, _ = operands(m, k, n, seed=7)
        p = plan(m, k, n, torch.bfloat16, H100_SMS)
        assert (p.block_n, p.blocks) == (128, 16)
        xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        one = Plan("stream_k", p.block_m, 1, 128, 1, 128)
        parts = [stream_k_sums(xb[:, k0:k0 + 128], q[k0:k0 + 128], one)
                 for k0 in range(0, k, 128)]
        in_order = parts[0]
        for part in parts[1:]:
            in_order = in_order + part
        assert np.array_equal(stream_k_sums(xb, q, p), in_order)
        reverse = parts[-1]
        for part in parts[-2::-1]:
            reverse = reverse + part
        assert not np.array_equal(in_order, reverse)


class TestWgmma:
    """The wgmma design's plan: its tile, chosen from the shape and the
    card alone, and the order in which its persistent grid takes the
    tiles (the kernel itself runs on the card: ``tests/test_torch_gpu.py``,
    ``chip_smoke.py`` phase 3d). The chat prefill's products take it:
    ``TestPlan.test_every_chip_smoke_shape_on_an_h100``'s chat_prefill
    rows."""

    @pytest.mark.parametrize("m,k,n,sms", [
        (1024, 4096, 4096, 132), (4096, 11008, 4096, 132),
        (512, 2048, 2048, 132), (100, 32768, 4096, 132),
        (1024, 4096, 11008, 66), (3072, 4096, 102400, 114)])
    def test_the_tile_is_a_function_of_the_shape_and_card_alone(
            self, m, k, n, sms):
        p = plan(m, k, n, torch.bfloat16, sms)
        assert p == plan(m, k, n, torch.bfloat16, sms)
        # K does not enter: every tile walks all of it
        for k2 in (64, 4040, 16384):
            q = plan(m, k2, n, torch.bfloat16, sms)
            assert (q.block_m, q.block_n, q.blocks) \
                == (p.block_m, p.block_n, p.blocks)
        assert p.block_m == kmod.wgmma_tile(m, n, sms)

    @pytest.mark.parametrize("m,n", [
        (1024, 4096), (2048, 11008), (3072, 4096), (4096, 102400),
        (1000, 4112), (100, 4096), (8 * 128 + 5, 3 * 256 + 16),
        (17 * 128, 1040), (64, 8192)])
    def test_the_raster_covers_every_tile_once(self, m, n):
        for block_m in kmod.WGMMA_TILES:
            order = kmod.wgmma_raster(m, n, block_m)
            m_tiles, n_tiles = -(-m // block_m), -(-n // kmod.BLOCK_N)
            assert sorted(order) == [(i, j) for i in range(m_tiles)
                                     for j in range(n_tiles)]
            # block b of a grid of g takes tiles b, b + g, ...: every
            # tile once over the grid
            for sms in (1, 7, H100_SMS):
                grid = min(len(order), sms)
                taken = [u for b in range(grid)
                         for u in range(b, len(order), grid)]
                assert sorted(taken) == list(range(len(order)))
            # a group's tiles lie in its kGroupM row tiles, walked column
            # by column
            group = min(m_tiles, kmod.WGMMA_GROUP_M)
            first = order[:group * n_tiles]
            assert {i for i, _ in first} == set(range(group))
            assert [j for _, j in first] == sorted(j for _, j in first)


#: the wgmma kernel's instances as nvcc 12.9 names them,
#: int8_matmul_wgmma_kernel<kN> for a tile of kN rows by 128 columns
WGMMA_NAME = ("_ZN47_GLOBAL__N__3f9cc6dc_14_int8_matmul_cu_03ece3dc2wg24"
              "int8_matmul_wgmma_kernelILi{rows}EEEv14CUtensorMap_stS2_S2_"
              "PKfiiiNS0_6RasterE")
PTXAS_ENTRY = """ '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 128 bytes smem
"""


@pytest.mark.parametrize("rows", list(kmod.WGMMA_TILES))
def test_build_phase_reads_the_wgmma_instances(monkeypatch, capsys, rows):
    """``chip_smoke.py``'s build phase names each wgmma instance by its
    tile, gives it the ring's shared memory, and reads ptxas' notes of
    serialised wgmma by the function's name, which ptxas prints apart
    from the function's own lines."""
    import chip_smoke

    names = {r: WGMMA_NAME.format(rows=r) for r in kmod.WGMMA_TILES}
    report = "".join("ptxas info    : Compiling entry function"
                     + PTXAS_ENTRY.format(name=name)
                     for name in names.values())
    report += ("ptxas info    : (C7512) Potential Performance Loss: "
               "wgmma.mma_async instructions are serialized due to "
               "insufficient register resources for the function "
               f"'{names[rows]}'\n")

    class Built:
        ptxas_report, build_seconds = report, 1.0

    monkeypatch.setattr(chip_smoke, "SOURCES", ["int8_matmul.cu"])
    monkeypatch.setattr(chip_smoke._build, "build_all",
                        lambda sources: [Built()])
    monkeypatch.setattr(chip_smoke, "BUILT_INSTANCES", {})
    chip_smoke.phase_build()
    capsys.readouterr()
    entries = chip_smoke.BUILT_INSTANCES["int8_matmul.cu"]
    assert len(entries) == len(kmod.WGMMA_TILES)
    by_rows = {}
    for e in entries:
        assert e["kernel"] == "int8_matmul_wgmma_kernel"
        by_rows[int(re.search(r"(\d+) x 128 tiles", e["design"]).group(1))] \
            = e
    assert set(by_rows) == set(kmod.WGMMA_TILES)
    stages, smem = chip_smoke.wgmma_ring(rows)
    # a ring of two stages at least, within an H100 block's 227 KB with
    # the static 128 bytes
    assert stages >= 2 and smem + 128 <= 232448
    assert by_rows[rows]["dynamic_smem_bytes"] == smem
    assert f"a {stages}-stage TMA ring" in by_rows[rows]["design"]
    assert [r for r, e in by_rows.items() if e["wgmma_serialized"]] \
        == [rows]

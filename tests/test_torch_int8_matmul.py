"""The int8-weight matmul's plain version against the JAX package's
``_mm`` on the CPU, its wrapper's checks and its split-K plan. The CUDA
kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 3d)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.kernels import int8_matmul as kmod
from tpu_operator_libs_torch.kernels.int8_matmul import (
    int8_matmul,
    split_plan,
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


class TestSplitPlan:
    @pytest.mark.parametrize("m,k,n", [
        (8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048), (2, 2048, 2048),
        (512, 2048, 2048), (512, 8192, 2048), (4, 1024, 2048),
        (4, 4096, 2048), (3, 2000, 1000), (1, 100, 10), (8, 257, 128)])
    @pytest.mark.parametrize("sms", [1, 132])
    def test_splits_cover_k_once_within_a_wave(self, m, k, n, sms):
        splits, k_per_split = split_plan(m, n, k, sms)
        assert k_per_split % kmod.CHUNK_K == 0
        # every row of K in exactly one split, none empty
        assert (splits - 1) * k_per_split < k <= splits * k_per_split
        assert 1 <= splits <= kmod.MAX_SPLITS
        tiles = -(-n // kmod.BLOCK_N) * -(-m // kmod.m_tile(m))
        assert splits == 1 or tiles * splits <= sms

    def test_decode_shapes_split_k_on_an_h100(self):
        # the bench shape's decode products have 16 or 64 column strips
        # for 132 SMs: K is split; prefill fills the card without
        assert split_plan(8, 2048, 2048, 132) == (8, 256)
        assert split_plan(8, 8192, 2048, 132) == (2, 1024)
        assert split_plan(8, 2048, 8192, 132) == (8, 1024)
        assert split_plan(512, 2048, 2048, 132) == (1, 2048)

    @pytest.mark.parametrize("m,want", [(1, 1), (2, 2), (3, 4), (4, 4),
                                        (5, 8), (512, 8)])
    def test_m_tile(self, m, want):
        assert kmod.m_tile(m) == want

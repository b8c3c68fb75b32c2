"""The port's ring attention (``tpu_operator_libs_torch/examples/
ring_attention.py``) on gloo ranks against the JAX package's ring on the
virtual CPU devices and against dense attention: tests/test_ring_attention.py's
cases (causal and full, rings of 2, 4 and 8, single-token blocks, the
first block blind to later ones, narrow GQA K/V, bf16 keeping its dtype,
gradients) at its tolerances, with head_dim 16, the narrowest the port's
kernels are built for. The fold's plain version is held to the
reference's ``_block_attention`` state.

Both sides compute from the same numpy inputs. Each ring size is one
launch of ranks that runs all of its cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_rank_workers as workers
from tpu_operator_libs.examples import ring_attention as jring
from tpu_operator_libs_torch.examples import ring_attention as tring
from tpu_operator_libs_torch.kernels.attention_fold import (
    attention_fold,
    attention_fold_reference,
)
from tpu_operator_libs_torch.kernels.flash_attention import (
    flash_attention_reference,
)
from tpu_operator_libs_torch.parallel import Mesh as RankMesh
from tpu_operator_libs_torch.parallel import run_ranks

#: tests/test_ring_attention.py's tolerances
TOL = 1e-5
BF16_TOL = 0.05
HEAD_DIM = 16


def qkv(batch=2, seq=64, heads=4, kv_heads=None, seed=0):
    rng = np.random.default_rng(seed)
    kv_heads = kv_heads or heads
    return (rng.standard_normal((batch, seq, heads, HEAD_DIM),
                                dtype=np.float32),
            rng.standard_normal((batch, seq, kv_heads, HEAD_DIM),
                                dtype=np.float32),
            rng.standard_normal((batch, seq, kv_heads, HEAD_DIM),
                                dtype=np.float32))


def case(q, k, v, causal=True, dtype="float32", grads=False):
    return {"q": q, "k": k, "v": v, "causal": causal, "dtype": dtype,
            "grads": grads}


def jax_ring(n, q, k, v, causal=True):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    return np.asarray(jring.make_ring_attention(mesh, causal=causal)(
        q, k, v), dtype=np.float32)


def dense(q, k, v, causal=True):
    group = q.shape[2] // k.shape[2]
    return np.asarray(jring.dense_reference(
        q, np.repeat(k, group, axis=2), np.repeat(v, group, axis=2),
        causal=causal), dtype=np.float32)


def blocked_k(k, v):
    """k, v with every position from 8 on replaced: what block 0 of an
    8-position block must not see."""
    rng = np.random.default_rng(9)
    k2, v2 = k.copy(), v.copy()
    k2[:, 8:] = rng.standard_normal(k2[:, 8:].shape, dtype=np.float32)
    v2[:, 8:] = 0.0
    return k2, v2


EIGHT = {
    "causal": case(*qkv()),
    "full": case(*qkv(), causal=False),
    "single_token": case(*qkv(seq=8)),
    "first_block_other": case(qkv()[0], *blocked_k(*qkv()[1:])),
    "gqa": case(qkv(heads=4)[0], *qkv(heads=4, kv_heads=2, seed=1)[1:]),
    "bf16": case(*qkv(), dtype="bfloat16"),
    "grads": case(*qkv(seq=32, heads=2), grads=True),
}


@pytest.fixture(scope="module")
def eight():
    names = list(EIGHT)
    got = run_ranks(workers.ring_cases_rank, 8, [EIGHT[n] for n in names],
                    device="cpu", mesh_shape={"sp": 8})
    return dict(zip(names, got[0])), got


@pytest.fixture(scope="module")
def uneven():
    out = {}
    for n in (2, 4):
        q, k, v = qkv(seq=8 * n)
        out[n] = (run_ranks(workers.ring_cases_rank, n, [case(q, k, v)],
                            device="cpu", mesh_shape={"sp": n})[0][0],
                  (q, k, v))
    return out


class TestRingMatchesJaxAndDense:
    @pytest.mark.parametrize("name", ["causal", "full"])
    def test_exact_on_8_ranks(self, eight, name):
        c = EIGHT[name]
        got = eight[0][name]["out"]
        for ref in (jax_ring(8, c["q"], c["k"], c["v"], c["causal"]),
                    dense(c["q"], c["k"], c["v"], c["causal"])):
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("n", [2, 4])
    def test_exact_on_uneven_ring_sizes(self, uneven, n):
        got, (q, k, v) = uneven[n]
        for ref in (jax_ring(n, q, k, v), dense(q, k, v)):
            np.testing.assert_allclose(got["out"], ref, rtol=TOL, atol=TOL)

    def test_every_rank_returns_the_whole_output(self, eight):
        _, ranks = eight
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[0]["out"], ranks[0][0]["out"])

    def test_single_token_blocks(self, eight):
        c = EIGHT["single_token"]
        np.testing.assert_allclose(eight[0]["single_token"]["out"],
                                   jax_ring(8, c["q"], c["k"], c["v"]),
                                   rtol=TOL, atol=TOL)

    def test_first_block_attends_only_itself(self, eight):
        a = eight[0]["causal"]["out"][:, :8]
        b = eight[0]["first_block_other"]["out"][:, :8]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert not np.allclose(eight[0]["causal"]["out"][:, 8:],
                               eight[0]["first_block_other"]["out"][:, 8:])

    def test_narrow_kv_heads_match_repeated_dense(self, eight):
        c = EIGHT["gqa"]
        got = eight[0]["gqa"]["out"]
        np.testing.assert_allclose(got, dense(c["q"], c["k"], c["v"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, jax_ring(8, c["q"], c["k"], c["v"]),
                                   rtol=TOL, atol=TOL)

    def test_bf16_inputs_keep_dtype(self, eight):
        got = eight[0]["bf16"]
        assert got["dtype"] == "torch.bfloat16"
        c = EIGHT["bf16"]
        np.testing.assert_allclose(got["out"], dense(c["q"], c["k"], c["v"]),
                                   rtol=BF16_TOL, atol=BF16_TOL)


class TestGradients:
    def test_gradients_match_dense_and_jax(self, eight):
        c = EIGHT["grads"]
        q, k, v = (jnp.asarray(c[x]) for x in "qkv")
        mesh = Mesh(np.array(jax.devices()[:8]), ("sp",))
        ring = jring.make_ring_attention(mesh)
        want = [
            jax.grad(lambda q, k, v: jnp.sum(jnp.square(fn(q, k, v))),
                     argnums=(0, 1, 2))(q, k, v)
            for fn in (ring, jring.dense_reference)]
        for ref in want:
            for got, r in zip(eight[0]["grads"]["grads"], ref):
                np.testing.assert_allclose(got, np.asarray(r), rtol=TOL,
                                           atol=TOL)


class TestFold:
    def test_plain_fold_matches_the_reference_state(self):
        """Block by block over a 4-block causal sequence: the port's (acc,
        lse) after each fold is the reference's (m, l, acc) in another
        form, lse = m + log l and acc = acc / l."""
        q, k, v = qkv(batch=1, seq=32, heads=2)
        width, me = 8, 3
        qj = jnp.asarray(q[:, me * width:(me + 1) * width])
        q_pos = me * width + jnp.arange(width)
        m = jnp.full((1, 2, width), -jnp.inf)
        l = jnp.zeros((1, 2, width))
        acc_ref = jnp.zeros((1, 2, width, HEAD_DIM))
        qt = torch.from_numpy(q).transpose(1, 2)
        kt = torch.from_numpy(k).transpose(1, 2)
        vt = torch.from_numpy(v).transpose(1, 2)
        acc = torch.zeros((1, 2, width, HEAD_DIM))
        lse = torch.full((1, 2, width), float("-inf"))
        for src in range(me + 1):  # the visible blocks, in any order
            cols = slice(src * width, (src + 1) * width)
            m, l, acc_ref = jring._block_attention(
                qj, jnp.asarray(k[:, cols]), jnp.asarray(v[:, cols]), q_pos,
                src * width + jnp.arange(width), m, l, acc_ref, causal=True)
            out, lse_blk = flash_attention_reference(
                qt[:, :, me * width:(me + 1) * width].contiguous(),
                kt[:, :, cols].contiguous(), vt[:, :, cols].contiguous(),
                causal=src == me, sm_scale=HEAD_DIM ** -0.5)
            attention_fold(acc, lse, out, lse_blk)
            np.testing.assert_allclose(
                lse.numpy(), np.asarray(m + jnp.log(l)), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(
                acc.numpy(), np.asarray(acc_ref / l[..., None]), rtol=TOL,
                atol=TOL)

    def test_rows_that_saw_nothing_stay_zero(self):
        """The guard: where the state and the block both have lse -inf
        the fold leaves zero weight; the same formula without the guard
        gives NaN there, so these inputs exercise it."""
        rng = np.random.default_rng(3)
        acc = torch.from_numpy(rng.standard_normal((2, 4, 8),
                                                   dtype=np.float32))
        lse = torch.from_numpy(rng.standard_normal((2, 4),
                                                   dtype=np.float32))
        o_blk = torch.from_numpy(rng.standard_normal((2, 4, 8),
                                                     dtype=np.float32))
        lse_blk = torch.from_numpy(rng.standard_normal((2, 4),
                                                       dtype=np.float32))
        acc[0, :2], lse[0, :2], lse_blk[0, :2] = 0.0, -np.inf, -np.inf
        new = torch.logaddexp(lse, lse_blk)
        unguarded = (torch.exp(lse - new)[..., None] * acc
                     + torch.exp(lse_blk - new)[..., None] * o_blk)
        assert torch.isnan(unguarded[0, :2]).all()
        got_acc, got_lse = attention_fold_reference(acc.clone(), lse.clone(),
                                                    o_blk, lse_blk)
        assert (got_acc[0, :2] == 0).all()
        assert torch.isneginf(got_lse[0, :2]).all()
        assert torch.isfinite(got_acc).all()
        torch.testing.assert_close(got_acc[1:], unguarded[1:])

    def test_fold_rejects_what_the_kernel_does_not_take(self):
        acc, lse = torch.zeros(2, 8), torch.zeros(2)
        with pytest.raises(ValueError, match="float32"):
            attention_fold(acc, lse.double(), torch.zeros(2, 8), lse)
        with pytest.raises(ValueError, match="multiple of 4"):
            attention_fold(torch.zeros(2, 6), lse, torch.zeros(2, 6), lse)
        with pytest.raises(ValueError, match="dtype"):
            attention_fold(acc, lse, torch.zeros(2, 8).half(), lse)


class TestShapes:
    def test_sequence_must_divide_ring(self):
        mesh = RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None, device=torch.device("cpu"),
                        axis_names=("sp",), other={"sp": (8, 0, None)})
        q, k, v = (torch.from_numpy(x) for x in qkv(seq=60))
        with pytest.raises(ValueError, match="must divide"):
            tring.make_ring_attention(mesh)(q, k, v)

    def test_one_rank_ring_is_the_flash_forward(self):
        """At sp = 1 the ring folds its one block into the empty state:
        exactly the block's own output."""
        mesh = RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None, device=torch.device("cpu"),
                        axis_names=("sp",), other={"sp": (1, 0, None)})
        q, k, v = (torch.from_numpy(x) for x in qkv(seq=16))
        got = tring.ring_attention(q, k, v, mesh)
        want, _ = flash_attention_reference(
            *(x.transpose(1, 2).contiguous() for x in (q, k, v)),
            causal=True, sm_scale=HEAD_DIM ** -0.5)
        assert torch.equal(got, want.transpose(1, 2))

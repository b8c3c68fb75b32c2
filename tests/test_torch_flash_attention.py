"""The port's flash-attention forward on the CPU: its plain version
against JAX's Pallas TPU kernel run in interpret mode, the wrapper's
contract, and the rule that the port imports nothing of JAX."""

import ast
from pathlib import Path

import jax  # noqa: F401  (imported before torch work: tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as pallas_flash_attention,
)

from tpu_operator_libs_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_forward,
)

ROOT = Path(__file__).resolve().parent.parent

#: f32 on both sides; the Pallas kernel folds keys blockwise with the
#: online softmax while the plain version takes one softmax over all of
#: them, so sums differ in order (observed ~6e-7 at S=256).
PALLAS_ATOL = 2e-5


def _inputs(seed, batch, heads, kv_heads, seq, dim):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, seq, dim)).astype(np.float32)
    k = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    v = rng.standard_normal((batch, kv_heads, seq, dim)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("batch,heads,kv_heads,seq,dim", [
    (1, 2, 2, 128, 32),
    (2, 4, 4, 256, 64),
    (1, 4, 2, 128, 16),   # GQA: K/V repeated on the JAX side only
])
def test_plain_version_matches_pallas_kernel(batch, heads, kv_heads, seq,
                                             dim):
    """The Pallas kernel takes q_seq_len >= 128 and a kv_seq_len that
    128 divides (its default BlockSizes), hence S = 128 * k."""
    q, k, v = _inputs(seq + dim, batch, heads, kv_heads, seq, dim)
    group = heads // kv_heads
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_flash_attention(
            jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, axis=1),
            jnp.repeat(jnp.asarray(v), group, axis=1),
            causal=True, sm_scale=dim ** -0.5))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True,
                          sm_scale=dim ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PALLAS_ATOL)


def test_lse_is_the_log_sum_exp_of_the_masked_scores():
    q, k, v = _inputs(3, 1, 2, 1, 40, 16)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_forward(qt, kt, vt, causal=True, sm_scale=0.25)
    kf = np.repeat(k, 2, axis=1).astype(np.float64)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kf) * 0.25
    scores = np.where(np.tril(np.ones((40, 40), bool)), scores, -np.inf)
    want = np.log(np.exp(scores).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    # row 0 sees key 0 only: its output is v[0] exactly
    np.testing.assert_allclose(out.numpy()[:, :, 0], v[:, [0, 0], 0],
                               rtol=0, atol=1e-6)


def test_non_causal_matches_sdpa():
    q, k, v = _inputs(4, 2, 2, 2, 33, 32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got, _ = flash_attention_reference(qt, kt, vt, causal=False,
                                       sm_scale=32 ** -0.5)
    want = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class TestWrapperContract:
    def test_cpu_tensor_takes_plain_path_without_counting(self):
        q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 2, 2, 17,
                                                         16))
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=True, sm_scale=0.25)
        want, _ = flash_attention_reference(q, k, v, causal=True,
                                            sm_scale=0.25)
        assert torch.equal(got, want)
        assert flash_attention.launches == before

    def test_bf16_output_keeps_the_input_dtype(self):
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(6, 1, 2, 2, 9, 16))
        got = flash_attention(q, k, v, causal=True, sm_scale=0.25)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape

    def test_grad_mode_raises(self):
        q, k, v = (torch.from_numpy(x).requires_grad_()
                   for x in _inputs(7, 1, 2, 2, 8, 16))
        with pytest.raises(NotImplementedError, match="training slice"):
            flash_attention(q, k, v, causal=True, sm_scale=0.25)
        with torch.no_grad():
            flash_attention(q, k, v, causal=True, sm_scale=0.25)

    @pytest.mark.parametrize("case", [
        "dtype", "head_dim", "rank", "kv_heads", "contiguity", "mixed",
    ])
    def test_rejects_what_the_kernel_does_not_take(self, case):
        q, k, v = (torch.from_numpy(x) for x in _inputs(8, 1, 4, 2, 8,
                                                         16))
        if case == "dtype":
            q, k, v = q.half(), k.half(), v.half()
        elif case == "head_dim":
            q, k, v = q[..., :8].contiguous(), k[..., :8].contiguous(), \
                v[..., :8].contiguous()
        elif case == "rank":
            q = q[0]
        elif case == "kv_heads":
            k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
        elif case == "contiguity":
            q = q.transpose(1, 2)
        elif case == "mixed":
            k = k.double()
        with pytest.raises(ValueError):
            flash_attention(q, k, v, causal=True, sm_scale=0.25)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "tpu_operator_libs_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 5
    offenders = []
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "tpu_operator_libs", "optax",
                       "orbax"):
                offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert offenders == []

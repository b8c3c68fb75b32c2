"""The port's Llama forward against the JAX package's, on the CPU, from
the same weights (JAX's params carried across by params_from_jax) and
the same numpy-made inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.convert import params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama

#: f32 on both sides; the tolerance of tests/test_llama.py:192.
TOL = 1e-4


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


def tokens(seed, batch, seq, vocab):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq)).astype(np.int32)


def both_params(jcfg, seed=0):
    jp = jllama.init_llama_params(one_device_mesh(), jcfg, seed=seed)
    return jp, params_from_jax(jp, device="cpu")


def port_config(jcfg, **kw):
    return tllama.LlamaConfig(**{**dataclasses.asdict(jcfg), **kw})


def test_config_copy_matches_the_reference():
    assert dataclasses.asdict(tllama.LlamaConfig()) \
        == dataclasses.asdict(jllama.LlamaConfig())
    assert tllama.ATTENTION_IMPLS == jllama.ATTENTION_IMPLS


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3.0
    w = rng.standard_normal((32,)).astype(np.float32)
    want = np.asarray(jllama._rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = tllama._rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("positions", [None, [7, 8, 9, 10, 11, 12]])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    jpos = None if positions is None else jnp.asarray(positions)
    tpos = None if positions is None else torch.tensor(positions)
    want = np.asarray(jllama._rope(jnp.asarray(x), 10000.0, jpos))
    got = tllama._rope(torch.from_numpy(x), 10000.0, tpos)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_xla_forward_matches_jax_at_default_config():
    """LlamaConfig(): GQA with group 2, f32 weights."""
    jcfg = jllama.LlamaConfig()
    jp, tp = both_params(jcfg)
    toks = tokens(3, 2, jcfg.seq_len, jcfg.vocab)
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg))
    got = tllama.forward(tp, torch.from_numpy(toks), port_config(jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_forward_matches_jax_einsum_forward():
    """JAX's own flash path raises off the TPU (tests/test_llama.py:56-61)
    and its einsum path is the oracle its test holds flash to; the
    port's flash path takes the kernel's plain version on the CPU.
    head_dim 16 (a width the kernel takes), GQA group 2, seq 128."""
    jcfg = jllama.LlamaConfig(d_model=64, n_heads=4, n_kv_heads=2)
    jp, tp = both_params(jcfg, seed=1)
    toks = tokens(4, 2, 128, jcfg.vocab)
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg))
    got = tllama.forward(tp, torch.from_numpy(toks),
                         port_config(jcfg, attention_impl="flash"))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_next_token_loss_matches_jax():
    jcfg = jllama.LlamaConfig()
    jp, tp = both_params(jcfg, seed=2)
    toks = tokens(5, 2, jcfg.seq_len, jcfg.vocab)
    want = float(jllama.next_token_loss(jp, jnp.asarray(toks), jcfg))
    got = float(tllama.next_token_loss(tp, torch.from_numpy(toks),
                                       port_config(jcfg)))
    assert abs(got - want) < TOL


def test_ring_attention_is_not_ported_yet():
    """The ring is ported now (tests/test_torch_sequence_parallel.py);
    the same call without a mesh fails as the reference's does: the ring
    needs a mesh with an sp axis."""
    cfg = tllama.LlamaConfig(attention_impl="ring")
    params = tllama.init_llama_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="'sp' axis"):
        tllama.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)


def test_port_init_is_seeded_and_in_the_reference_layout():
    cfg = tllama.LlamaConfig()
    a = tllama.init_llama_params(cfg, seed=3, device="cpu")
    b = tllama.init_llama_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["layers"][1]["wk"], b["layers"][1]["wk"])
    jp = jllama.init_llama_params(one_device_mesh(), jllama.LlamaConfig())
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    ported = jax.tree_util.tree_map(lambda x: tuple(x.shape), a)
    assert shapes == ported
    bf = tllama.init_llama_params(cfg, param_dtype=torch.bfloat16,
                                  device="cpu")
    assert bf["lm_head"].dtype == torch.bfloat16


class TestParamsFromJax:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_float_leaves_round_trip_bit_exact(self, dtype):
        jp = jllama.init_llama_params(one_device_mesh(),
                                      jllama.LlamaConfig(), param_dtype=dtype)
        tp = params_from_jax(jp, device="cpu")
        want = np.asarray(jp["layers"][0]["wq"]).astype(np.float32)
        got = tp["layers"][0]["wq"]
        assert got.dtype == {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[dtype]
        np.testing.assert_array_equal(got.float().numpy(), want)

    def test_int8_leaves_keep_codes_and_scales(self):
        from tpu_operator_libs.examples.llama_decode import (
            quantize_params_int8,
        )

        jq = quantize_params_int8(jllama.init_llama_params(
            one_device_mesh(), jllama.LlamaConfig()))
        tq = params_from_jax(jq, device="cpu", dtype=torch.bfloat16)
        leaf = tq["layers"][1]["w_down"]
        assert leaf["q"].dtype == torch.int8
        assert leaf["s"].dtype == torch.float32  # scales are not recast
        np.testing.assert_array_equal(
            leaf["q"].numpy(), np.asarray(jq["layers"][1]["w_down"]["q"]))
        np.testing.assert_array_equal(
            leaf["s"].numpy(), np.asarray(jq["layers"][1]["w_down"]["s"]))
        assert tq["embed"].dtype == torch.bfloat16  # plain leaves are


class TestDeviceResolution:
    def test_default_is_cuda_and_raises_without_it(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            tllama.init_llama_params(tllama.LlamaConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_jax({"embed": np.zeros((2, 2), np.float32)})

    def test_cpu_when_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")

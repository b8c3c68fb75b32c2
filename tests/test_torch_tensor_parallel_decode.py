"""The port's dp x tp decode on gloo ranks: greedy tokens at tp=2 against
the JAX package's ``generate`` on a (1, 2) mesh, the int8 scales of the
row-parallel weights against JAX's whole-weight scales bit for bit, and
the port's own contract at (dp 2, tp 2) in bfloat16: its host loop and
device loop give the same tokens, with plain and with int8 weights + int8
KV cache, and sampled tokens agree across the ranks."""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import test_torch_rank_workers as workers
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.parallel import run_ranks

JCFG = jllama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, seq_len=16)
CONFIG_KW = dataclasses.asdict(JCFG)
NEW_TOKENS = 8


def prompt(batch, length=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab, (batch, length)).astype(np.int32)


@pytest.fixture(scope="module")
def tp2_run():
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    params = jllama.init_llama_params(mesh, JCFG)
    toks = prompt(2)
    want = np.asarray(jdecode.generate(params, toks, JCFG, mesh, NEW_TOKENS))
    qparams = jdecode.quantize_params_int8(params)
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    ranks = run_ranks(workers.tp_decode_rank, 2, params_np, CONFIG_KW, toks,
                      NEW_TOKENS, "float32", device="cpu")
    return {"want": want, "qparams": qparams, "ranks": ranks}


def test_greedy_tokens_at_tp2_equal_jax(tp2_run):
    for rank in tp2_run["ranks"]:
        np.testing.assert_array_equal(rank["host_plain"], tp2_run["want"])
        np.testing.assert_array_equal(rank["device_plain"], tp2_run["want"])


@pytest.mark.parametrize("name,split", [("wo", False), ("w_down", False),
                                        ("wq", True), ("w_up", True),
                                        ("lm_head", True)])
def test_int8_scales_bit_equal_to_jax_whole_weight(tp2_run, name, split):
    layer = tp2_run["qparams"]["layers"][0]
    want = np.asarray((tp2_run["qparams"] if name == "lm_head"
                       else layer)[name]["s"])
    for tp_rank, rank in enumerate(tp2_run["ranks"]):
        got = rank["scales"][name]
        if split:  # column-parallel: the scales of this rank's columns
            width = want.shape[0] // 2
            expected = want[tp_rank * width:(tp_rank + 1) * width]
        else:  # row-parallel: every rank holds the whole weight's scales
            expected = want
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, expected)


def test_host_loop_equals_device_loop_at_dp2_tp2_in_bf16():
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    params = jllama.init_llama_params(mesh, JCFG, seed=3)
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    ranks = run_ranks(workers.tp_decode_rank, 4, params_np, CONFIG_KW,
                      prompt(4, seed=1), NEW_TOKENS, "bfloat16",
                      device="cpu")
    first = ranks[0]
    for label in ("plain", "int8"):
        assert first[f"host_{label}"].shape == (4, 6 + NEW_TOKENS)
        for rank in ranks:  # every rank returns the whole batch
            np.testing.assert_array_equal(rank[f"host_{label}"],
                                          first[f"host_{label}"])
            np.testing.assert_array_equal(rank[f"device_{label}"],
                                          rank[f"host_{label}"])
    assert ((first["host_int8"] >= 0) & (first["host_int8"] < 64)).all()
    # equally seeded generators: the tp ranks draw the same tokens
    for rank in ranks:
        np.testing.assert_array_equal(rank["sampled"], first["sampled"])
    assert not np.array_equal(first["sampled"], first["host_plain"])

"""The port's dp x tp decode on gloo ranks: greedy tokens at tp=2 against
the JAX package's ``generate`` on a (1, 2) mesh, the int8 scales of the
row-parallel weights against JAX's whole-weight scales bit for bit, and
the port's own contract at (dp 2, tp 2) in bfloat16: its host loop and
device loop give the same tokens, with plain and with int8 weights + int8
KV cache, and with sampling, an eos and logprobs; sampled tokens agree
across the ranks. Which loop the device decode takes: the Python loop on
the CPU, one CUDA graph replayed on the card with or without a mesh, and
a refusal for a mesh on the card that does not talk over NCCL."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_rank_workers as workers
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.parallel import Mesh as TorchMesh, run_ranks

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


@pytest.fixture(scope="module")
def dp2_tp2_run():
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    params = jllama.init_llama_params(mesh, JCFG, seed=3)
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return run_ranks(workers.tp_decode_rank, 4, params_np, CONFIG_KW,
                     prompt(4, seed=1), NEW_TOKENS, "bfloat16",
                     device="cpu")


def test_host_loop_equals_device_loop_at_dp2_tp2_in_bf16(dp2_tp2_run):
    ranks = dp2_tp2_run
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


def test_sampled_with_eos_and_logprobs_host_equals_device_at_dp2_tp2(
        dp2_tp2_run):
    first = dp2_tp2_run[0]["sampled_eos"]
    eos = first["eos_id"]
    assert first["device"].shape == (4, 6 + NEW_TOKENS)
    # row 0 drew the eos at its third step and pads from there, with a
    # logprob of 0 at every padded position
    assert (first["device"][0, 6 + 2:] == eos).all()
    assert (first["device_logprobs"][0, 3:] == 0.0).all()
    assert np.isfinite(first["device_logprobs"]).all()
    for rank in dp2_tp2_run:  # every rank: both loops, bit for bit
        got = rank["sampled_eos"]
        assert got["eos_id"] == eos
        for key in ("host", "host_logprobs", "device", "device_logprobs"):
            np.testing.assert_array_equal(got[key], first[key])
        np.testing.assert_array_equal(got["device"], got["host"])
        np.testing.assert_array_equal(got["device_logprobs"],
                                      got["host_logprobs"])


def test_every_rank_runs_the_python_loop_on_the_cpu(dp2_tp2_run):
    # each of the NEW_TOKENS forward calls (the prefill of this rank's 2
    # rows x 6 positions, then steps of 2 rows) all-reduces the bf16
    # residual twice a layer and gathers the vocabulary once
    per_row = 2 * (2 * JCFG.n_layers * JCFG.d_model + JCFG.vocab)
    loop = {"eager_steps": NEW_TOKENS - 1, "graph_launches": 0,
            "capture_ms": 0.0,
            "collectives": NEW_TOKENS * (2 * JCFG.n_layers + 1),
            "collective_bytes": per_row * (2 * 6 + 2 * (NEW_TOKENS - 1))}
    for rank in dp2_tp2_run:
        assert rank["device_plain_loop"] == loop
        assert rank["device_int8_loop"] == loop
        assert rank["sampled_eos"]["device_loop"] == loop


def test_a_gloo_mesh_on_the_card_is_refused(dp2_tp2_run):
    for rank in dp2_tp2_run:
        assert "decodes over NCCL, not gloo" in rank["on_the_card"]


def one_rank_mesh(device="cpu"):
    return TorchMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                     tp_group=None, device=torch.device(device))


@pytest.mark.parametrize("device,mesh,backend,captures", [
    ("cpu", False, None, False),
    ("cpu", True, "gloo", False),
    ("cuda", False, None, True),
    ("cuda", True, "nccl", True),
    ("cuda", True, "gloo", "raises"),
], ids=["cpu", "cpu_mesh", "card", "card_nccl_mesh", "card_gloo_mesh"])
def test_which_loop_the_device_decode_takes(monkeypatch, device, mesh,
                                            backend, captures):
    asked = []

    def get_backend(group=None):
        asked.append(group)
        return backend

    monkeypatch.setattr(tdecode.dist, "get_backend", get_backend)
    mesh = one_rank_mesh(device) if mesh else None
    device = torch.device(device)
    if captures == "raises":
        with pytest.raises(ValueError, match="decodes over NCCL, not gloo"):
            tdecode._captures(device, mesh)
    else:
        assert tdecode._captures(device, mesh) is captures
    # only a mesh on the card asks for its backend, and of its tp group
    assert asked == ([None] if device.type == "cuda" and mesh else [])


def test_a_mesh_that_captures_replays_its_step(monkeypatch):
    """generate_on_device with a mesh hands its step to _replay_steps
    whenever the loop is captured (on the card), as without one: every
    step goes through it, and last_call is what it ran."""
    calls = []

    def replay_steps(step, steps, generator, device, mesh=None):
        calls.append((steps, generator, mesh))
        for _ in range(steps):
            step()
        return {"eager_steps": 1, "graph_launches": steps - 1,
                "capture_ms": 1.0}

    monkeypatch.setattr(tdecode, "_captures", lambda device, mesh: True)
    monkeypatch.setattr(tdecode, "_replay_steps", replay_steps)
    config = tllama.LlamaConfig(**CONFIG_KW)
    params = tllama.init_llama_params(config, seed=3, device="cpu")
    toks = prompt(2)
    mesh = one_rank_mesh()
    gen = torch.Generator().manual_seed(4)
    dev = tdecode.generate_on_device(params, toks, config, NEW_TOKENS,
                                     temperature=1.0, generator=gen,
                                     mesh=mesh)
    assert calls == [(NEW_TOKENS - 1, gen, mesh)]
    # one rank: no tp collective
    assert tdecode.generate_on_device.last_call == {
        "eager_steps": 1, "graph_launches": NEW_TOKENS - 2,
        "capture_ms": 1.0, "collectives": 0, "collective_bytes": 0}
    host = tdecode.generate(params, toks, config, NEW_TOKENS,
                            temperature=1.0, mesh=mesh,
                            generator=torch.Generator().manual_seed(4))
    assert torch.equal(dev, host)

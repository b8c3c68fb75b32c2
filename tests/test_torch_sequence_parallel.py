"""The port's ``attention_impl="ring"`` Llama on a dp x sp mesh of gloo
ranks against the JAX package's on a (2, 2) ("dp", "sp") mesh of the
virtual CPU devices: the logits (sharded over the sequence on both
sides), three clipped AdamW steps' losses and the parameters after them,
and tests/test_llama.py's two ``ValueError`` contracts. Without the sum
of the gradients over sp the losses leave JAX's: the comparison catches
it.

Both packages start from JAX's parameters and JAX's global token
batches; each rank takes its dp rows and its sp block of the sequence.
GQA (4 query heads over 2 KV heads) puts only the narrow K/V on the
ring."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_rank_workers as workers
from test_torch_tensor_parallel import LOGITS_TOL, as_numpy
from test_torch_train import LOSS_TOL, assert_params_match
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.parallel import Mesh as RankMesh
from tpu_operator_libs_torch.parallel import run_ranks

STEPS = 3
#: small enough that the clip binds at every step: the norm must count
#: each replicated leaf once, not once a sequence block
CLIP = 0.05
JCFG = jllama.LlamaConfig(vocab=64, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, seq_len=32,
                          attention_impl="ring", grad_clip_norm=CLIP)


def mesh_2x2():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))


@pytest.fixture(scope="module")
def jax_run():
    mesh = mesh_2x2()
    params = jllama.init_llama_params(mesh, JCFG)
    optimizer, step = jllama.make_train_step(mesh, JCFG)
    tokens = [jllama.make_token_batch(mesh, i, JCFG) for i in range(STEPS)]
    logits = np.asarray(jax.jit(
        lambda p, t: jllama.forward(p, t, JCFG, mesh))(params, tokens[0]))
    grad_fn = jax.jit(jax.grad(
        lambda p, t: jllama.next_token_loss(p, t, JCFG, mesh)))
    state = {"params": params, "opt": optimizer.init(params),
             "step": jax.numpy.zeros((), jax.numpy.int32)}
    grads, losses = [], []
    for toks in tokens:
        grads.append(grad_fn(state["params"], toks))
        state, loss = step(state, toks)
        losses.append(float(loss))
    return {"params": as_numpy(params), "logits": logits, "losses": losses,
            "grads": grads, "final": state["params"],
            "tokens": [np.asarray(t) for t in tokens]}


@pytest.fixture(scope="module")
def port_run(jax_run):
    return run_ranks(workers.sp_train_rank, 4, jax_run["params"],
                     dataclasses.asdict(JCFG), jax_run["tokens"],
                     device="cpu", mesh_shape={"dp": 2, "sp": 2})


def global_logits(ranks):
    """The (B, S, vocab) logits from the ranks' (dp, sp) blocks."""
    rows = []
    for dp_rank in (0, 1):
        blocks = sorted((r for r in ranks if r["dp_rank"] == dp_rank),
                        key=lambda r: r["sp_rank"])
        rows.append(np.concatenate([r["logits"] for r in blocks], axis=1))
    return np.concatenate(rows, axis=0)


def test_the_clip_binds_at_every_step(jax_run):
    import optax

    norms = [float(optax.global_norm(g)) for g in jax_run["grads"]]
    assert all(norm > 2 * CLIP for norm in norms), norms


def test_ring_logits_match_jax(jax_run, port_run):
    assert [(r["dp_rank"], r["sp_rank"]) for r in port_run] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert port_run[0]["logits"].shape == (2, 16, 64)  # a sequence block
    np.testing.assert_allclose(global_logits(port_run), jax_run["logits"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_dp2_sp2_clipped_steps_match_jax(jax_run, port_run):
    for r in port_run:
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   atol=LOSS_TOL, rtol=0)
    # the weights are replicated: every rank ends with JAX's
    for r in port_run:
        assert_params_match(jax_run["final"], r["params"], jax_run["grads"])


def test_without_the_sum_over_sp_the_losses_leave_jax(jax_run, port_run):
    drift = np.abs(np.array(port_run[0]["unsummed_losses"])
                   - np.array(jax_run["losses"]))
    assert drift[0] <= LOSS_TOL  # the first loss precedes any update
    assert drift[1:].max() > 100 * LOSS_TOL, drift


def test_ring_requires_sp_axis():
    mesh = RankMesh(dp=2, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                    tp_group=None, device=torch.device("cpu"))
    config = tllama.LlamaConfig(attention_impl="ring", n_heads=4,
                                n_kv_heads=4)
    params = tllama.init_llama_params(config, device="cpu")
    tokens = tllama.make_token_batch(0, config, device="cpu")
    with pytest.raises(ValueError, match="'sp' axis"):
        tllama.forward(params, tokens, config, mesh)
    with pytest.raises(ValueError, match="'sp' axis"):
        tllama.forward(params, tokens, config)


def test_ring_rejected_with_tensor_parallelism():
    with pytest.raises(ValueError, match="tp=1"):
        tllama.LlamaConfig(attention_impl="ring").validate_for(4)


def test_a_sequence_sharded_mesh_runs_only_the_ring():
    mesh = RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                    tp_group=None, device=torch.device("cpu"),
                    axis_names=("dp", "sp"), other={"sp": (2, 0, None)})
    config = tllama.LlamaConfig(n_heads=4, n_kv_heads=4)
    params = tllama.init_llama_params(config, device="cpu")
    tokens = tllama.make_token_batch(0, config, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tllama.forward(params, tokens, config, mesh)

"""The port's dp x tp Llama train step on gloo ranks against the JAX
package's ``make_train_step`` on a (2, 2) mesh of the virtual CPU
devices, the port at tp=2 against itself at tp=1, and the two collectives
whose absence the comparison must catch: ``copy_to_tp``'s backward
all-reduce and the clip norm's all-reduce over tp.

Both packages start from JAX's parameters and JAX's token batches (the
global batch; each dp rank takes its rows), with a clip norm small enough
to bind at every step."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import test_torch_rank_workers as workers
from test_torch_train import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_TOL,
    assert_params_match,
)
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs_torch.convert import params_from_jax, state_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.parallel import Mesh as RankMesh
from tpu_operator_libs_torch.parallel import (
    TP_SPLIT_DIM,
    run_ranks,
    to_numpy,
)

#: f32 logits on both sides: tests/test_torch_llama.py's tolerance
LOGITS_TOL = 1e-4
STEPS = 3
#: small enough that the clip binds at every step (checked below)
CLIP = 0.05
JCFG = jllama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, seq_len=16,
                          grad_clip_norm=CLIP)
CONFIG_KW = dataclasses.asdict(JCFG)


def mesh_2x2():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))


def as_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def jax_run():
    mesh = mesh_2x2()
    params = jllama.init_llama_params(mesh, JCFG)
    optimizer, step = jllama.make_train_step(mesh, JCFG)
    tokens = [jllama.make_token_batch(mesh, i, JCFG) for i in range(STEPS)]
    state = {"params": params, "opt": optimizer.init(params),
             "step": jax.numpy.zeros((), jax.numpy.int32)}
    logits = np.asarray(jax.jit(
        lambda p, t: jllama.forward(p, t, JCFG, mesh))(params, tokens[0]))
    grad_fn = jax.jit(jax.grad(
        lambda p, t: jllama.next_token_loss(p, t, JCFG, mesh)))
    grads, losses = [], []
    for toks in tokens:
        grads.append(grad_fn(state["params"], toks))
        state, loss = step(state, toks)
        losses.append(float(loss))
    return {"params": as_numpy(params), "logits": logits, "losses": losses,
            "grads": grads, "final": state["params"], "state": state,
            "tokens": [np.asarray(t) for t in tokens]}


def port_run(jax_run, n, variant="plain"):
    return run_ranks(workers.tp_train_rank, n, jax_run["params"], CONFIG_KW,
                     jax_run["tokens"], variant, device="cpu")


@pytest.fixture(scope="module")
def run_2x2(jax_run):
    return port_run(jax_run, 4)


def assemble(ranks, field="params"):
    """The whole tree from the ranks' shards: tp shards concatenated
    along their split dim (from the dp-rank-0 row); the dp replicas of
    every shard must be equal bit for bit."""
    row = sorted((r for r in ranks if r["dp_rank"] == 0),
                 key=lambda r: r["tp_rank"])
    for r in ranks:
        twin = row[r["tp_rank"]]
        for a, b in zip(jax.tree.leaves(r[field]),
                        jax.tree.leaves(twin[field])):
            np.testing.assert_array_equal(a, b)

    def join(key, parts):
        if isinstance(parts[0], dict):
            return {k: join(k, [p[k] for p in parts]) for k in parts[0]}
        if isinstance(parts[0], list):
            return [join(key, [p[i] for p in parts])
                    for i in range(len(parts[0]))]
        dim = TP_SPLIT_DIM.get(key)
        return parts[0] if dim is None else np.concatenate(parts, axis=dim)

    return join(None, [r[field] for r in row])


def global_logits(ranks):
    row = sorted((r for r in ranks if r["tp_rank"] == 0),
                 key=lambda r: r["dp_rank"])
    return np.concatenate([r["logits"] for r in row], axis=0)


def test_the_clip_binds_at_every_step(jax_run):
    norms = [float(optax.global_norm(g)) for g in jax_run["grads"]]
    assert all(norm > 2 * CLIP for norm in norms), norms


def test_dp2_tp2_logits_and_clipped_steps_match_jax(jax_run, run_2x2):
    assert [(r["dp_rank"], r["tp_rank"]) for r in run_2x2] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    wq = run_2x2[0]["params"]["layers"][0]["wq"]
    assert wq.shape == (32, 32 // 2)  # still split over tp
    np.testing.assert_allclose(global_logits(run_2x2), jax_run["logits"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    for r in run_2x2:
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   atol=LOSS_TOL, rtol=0)
    assert_params_match(jax_run["final"], assemble(run_2x2),
                        jax_run["grads"])


def test_tp2_equals_tp1(jax_run):
    """The port at (dp 1, tp 2) against the port on one device without a
    mesh, on the same weights and the same global batch."""
    config = tllama.LlamaConfig(**CONFIG_KW)
    params = params_from_jax(jax_run["params"], device="cpu")
    tokens = [torch.from_numpy(np.array(t)) for t in jax_run["tokens"]]
    with torch.no_grad():
        logits = tllama.forward(params, tokens[0], config)
    optimizer, step = tllama.make_train_step(config, device="cpu")
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for toks in tokens:
        state, loss = step(state, toks)
        losses.append(float(loss))

    tp2 = port_run(jax_run, 2)
    assert [(r["dp_rank"], r["tp_rank"]) for r in tp2] == [(0, 0), (0, 1)]
    np.testing.assert_allclose(global_logits(tp2), logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp2[0]["losses"], losses, atol=LOSS_TOL,
                               rtol=0)
    assert_params_match(state["params"], assemble(tp2), jax_run["grads"])


def test_norm_weight_gradients_are_equal_on_every_tp_rank(run_2x2):
    """Every rank holds the replicated leaves' whole gradient, bit for
    bit (the all-reduces hand every rank the same sum); that it is the
    whole and not a partial one the JAX comparison of the parameters
    above shows."""
    first = run_2x2[0]["replicated_grads"]
    assert all(np.abs(value).max() > 0 for value in first.values())
    for r in run_2x2[1:]:
        for key, value in r["replicated_grads"].items():
            np.testing.assert_array_equal(value, first[key])


def test_without_copy_to_tp_norm_gradients_are_partial(jax_run):
    ranks = port_run(jax_run, 4, "no_copy_to_tp")
    tp0, tp1 = ranks[0]["replicated_grads"], ranks[1]["replicated_grads"]
    for key in ("attn_norm0", "mlp_norm1", "final_norm"):
        assert not np.allclose(tp0[key], tp1[key], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL), key


def test_clip_without_its_tp_all_reduce_is_caught(jax_run):
    ranks = port_run(jax_run, 4, "local_clip")
    with pytest.raises(AssertionError):
        assert_params_match(jax_run["final"], assemble(ranks),
                            jax_run["grads"])


def test_sharded_state_from_jax_holds_each_ranks_blocks(jax_run):
    """``convert.state_from_jax`` with a mesh: every rank's parameters
    and moments are the blocks JAX's NamedShardings give its device, so
    the ranks' shards put back together are JAX's arrays bit for bit."""
    ranks = []
    for dp_rank in (0, 1):
        for tp_rank in (0, 1):
            mesh = RankMesh(dp=2, tp=2, dp_rank=dp_rank, tp_rank=tp_rank,
                            dp_group=None, tp_group=None,
                            device=torch.device("cpu"))
            state = state_from_jax(jax_run["state"], mesh=mesh)
            ranks.append({"params": to_numpy(state["params"]),
                          "mu": to_numpy(state["opt"]["mu"]),
                          "step": int(state["step"]),
                          "dp_rank": dp_rank, "tp_rank": tp_rank})
    assert ranks[0]["params"]["lm_head"].shape == (32, 64 // 2)
    assert ranks[0]["params"]["layers"][0]["w_down"].shape == (64 // 2, 32)
    assert {r["step"] for r in ranks} == {STEPS}
    adam = jax_run["state"]["opt"][1][0]  # clip's state, then adamw's
    for field, want in (("params", jax_run["final"]), ("mu", adam.mu)):
        for a, b in zip(jax.tree.leaves(want),
                        jax.tree.leaves(assemble(ranks, field))):
            np.testing.assert_array_equal(np.asarray(a), b)

"""The port's training slice against the JAX package's, on the CPU: model
gradients, AdamW steps with and without schedule and clipping, remat,
carrying a JAX state across, and learning. Both sides start from the
same weights (JAX's params carried across) and the same token batches
(JAX's, or the port's orbit from JAX's start tokens)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs_torch.convert import params_from_jax, state_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.optim import AdamW, tree_leaves, value_and_grad

#: gradients, f32 on both sides: the tolerance of tests/test_llama.py:148
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
#: train steps: losses within 1e-4, parameters within 1e-5
LOSS_TOL, PARAM_TOL = 1e-4, 1e-5
#: Adam's first update is lr * g / (|g| + 1e-8): where a gradient element
#: is at float noise (below GRAD_ATOL, against ~1e-3 elsewhere) the two
#: sides' noise gives different updates of up to 2 * lr. Such elements
#: are reported and counted, not covered by a looser tolerance.
MAX_NOISE_ELEMENTS = 8


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


def port_config(jcfg, **kw):
    return tllama.LlamaConfig(**{**dataclasses.asdict(jcfg), **kw})


def numpy_leaves(tree):
    """Leaves in JAX's order (dict keys sorted), as float32 numpy."""
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                       dtype=np.float32)
            for x in jax.tree.leaves(tree)]


def jax_state(jcfg, seed=0):
    mesh = one_device_mesh()
    params = jllama.init_llama_params(mesh, jcfg, seed=seed)
    optimizer, step = jllama.make_train_step(mesh, jcfg)
    return ({"params": params, "opt": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}, step)


def run_both(jcfg, jstate, jstep, tstate, steps):
    """Run ``steps`` (indices) on both sides from the given states;
    return (jax losses, port losses, jax grads per step, states)."""
    mesh = one_device_mesh()
    _, tstep = tllama.make_train_step(port_config(jcfg), device="cpu")
    jlosses, tlosses, jgrads = [], [], []
    for i in steps:
        toks = jllama.make_token_batch(mesh, i, jcfg)
        jgrads.append(jax.grad(
            lambda p, t=toks: jllama.next_token_loss(p, t, jcfg))(
                jstate["params"]))
        jstate, jloss = jstep(jstate, toks)
        tstate, tloss = tstep(tstate, torch.from_numpy(np.array(toks)))
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    return jlosses, tlosses, jgrads, jstate, tstate


def assert_params_match(jparams, tparams, jgrads):
    """Every parameter within PARAM_TOL, except elements whose JAX
    gradient was at float noise at some step (see MAX_NOISE_ELEMENTS),
    which stay within 2 * lr * steps and are counted."""
    noise = [np.zeros(a.shape, bool) for a in numpy_leaves(jparams)]
    for grads in jgrads:
        for mask, g in zip(noise, numpy_leaves(grads)):
            mask |= np.abs(g) < GRAD_ATOL
    off = 0
    for a, b, mask in zip(numpy_leaves(jparams), numpy_leaves(tparams),
                          noise):
        diff = np.abs(a - b)
        beyond = diff > PARAM_TOL
        assert not (beyond & ~mask).any(), (
            f"max |diff| {diff[~mask].max()} outside noise elements")
        off += int(beyond.sum())
        assert (diff[mask] <= 2 * 3e-3 * len(jgrads)).all()
    assert off <= MAX_NOISE_ELEMENTS, f"{off} noise elements differ"
    return off


class TestTokenBatch:
    def test_the_orbit_from_jax_start_tokens_is_jax_batch(self):
        jcfg = jllama.LlamaConfig()
        toks = np.asarray(jllama.make_token_batch(one_device_mesh(), 3,
                                                  jcfg))
        got = tllama.make_token_batch(3, port_config(jcfg), device="cpu",
                                      start=toks[:, 0])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), toks)

    def test_default_start_is_seeded_by_step(self):
        cfg = tllama.LlamaConfig(vocab=50, seq_len=9)
        a = tllama.make_token_batch(4, cfg, batch_per_shard=3, device="cpu")
        b = tllama.make_token_batch(4, cfg, batch_per_shard=3, device="cpu")
        c = tllama.make_token_batch(5, cfg, batch_per_shard=3, device="cpu")
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert a.shape == (3, 9)
        nxt = (a[:, :-1].long() * 7 + 3) % 50
        assert torch.equal(nxt, a[:, 1:].long())

    def test_start_must_have_a_row_per_sequence(self):
        with pytest.raises(ValueError, match="rows"):
            tllama.make_token_batch(0, tllama.LlamaConfig(), device="cpu",
                                    start=[1, 2, 3])


#: The embedding gradient sums each token's O(1) contributions over the
#: positions it occupies; where such a sum nearly cancels, the two
#: frameworks' summation orders leave float32 noise: of the seed pairs
#: below, w0-t1 puts 3 elements of that leaf (whose largest elements are
#: 1-2) up to 1.5e-6 from JAX's with xla, w2-t0 puts 2, outside GRAD_ATOL.
#: Such elements are counted and bounded, with room to spare, not covered
#: by a looser tolerance for every element.
EMBED_NOISE_ELEMENTS, EMBED_NOISE_ATOL = 4, 4e-6


def assert_grads_match(jgrads, tgrads):
    """Every leaf within GRAD_RTOL / GRAD_ATOL, except at most
    EMBED_NOISE_ELEMENTS elements of the embedding gradient, which stay
    within EMBED_NOISE_ATOL."""
    want = numpy_leaves({k: v for k, v in jgrads.items() if k != "embed"})
    got = numpy_leaves({k: v for k, v in tgrads.items() if k != "embed"})
    assert len(want) == len(got) and len(want) > 0
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    (a,), (b,) = numpy_leaves(jgrads["embed"]), numpy_leaves(tgrads["embed"])
    diff = np.abs(b - a)
    noise = diff > GRAD_ATOL + GRAD_RTOL * np.abs(a)
    assert noise.sum() <= EMBED_NOISE_ELEMENTS, (
        f"{noise.sum()} embedding gradient elements off")
    np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=EMBED_NOISE_ATOL)
    return int(noise.sum())


@pytest.mark.parametrize("impl,weights_seed,tokens_seed", [
    ("xla", 1, 0), ("flash", 1, 0),
    ("xla", 0, 1), ("flash", 0, 1),
    ("xla", 2, 0), ("flash", 2, 0),
], ids=["xla", "flash", "xla-w0-t1", "flash-w0-t1", "xla-w2-t0",
        "flash-w2-t0"])
def test_model_gradients_match_jax(impl, weights_seed, tokens_seed):
    """flash: head_dim 16, GQA group 2, seq 128 (JAX's own flash path
    raises off the TPU, so both are held to JAX's einsum path). The seed
    pairs w0-t1 and w2-t0 put 3 and 2 noise elements in the embedding
    gradient with xla (see EMBED_NOISE_ELEMENTS)."""
    if impl == "flash":
        jcfg = jllama.LlamaConfig(d_model=64, n_heads=4, n_kv_heads=2)
        seq = 128
    else:
        jcfg, seq = jllama.LlamaConfig(), jllama.LlamaConfig().seq_len
    jp = jllama.init_llama_params(one_device_mesh(), jcfg,
                                  seed=weights_seed)
    toks = np.random.default_rng(tokens_seed).integers(
        0, jcfg.vocab, (2, seq)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.next_token_loss(p, jnp.asarray(toks), jcfg))(jp)
    tloss, tgrads = value_and_grad(
        tllama.next_token_loss, params_from_jax(jp, device="cpu"),
        torch.from_numpy(toks),
        port_config(jcfg, attention_impl=impl))
    assert abs(float(tloss) - float(jloss)) < LOSS_TOL
    assert len(numpy_leaves(tgrads)) == 2 + 9 * jcfg.n_layers + 1
    assert_grads_match(jgrads, tgrads)


@pytest.mark.parametrize("knobs", [
    {},
    {"warmup_steps": 2, "total_steps": 10},
    {"grad_clip_norm": 0.1},      # binds: the global norm is ~1
    {"grad_clip_norm": 100.0},    # passes the gradient through
], ids=["constant", "warmup_cosine", "clip_binding", "clip_not_binding"])
def test_train_steps_match_jax(knobs):
    jcfg = dataclasses.replace(jllama.LlamaConfig(), **knobs)
    jstate, jstep = jax_state(jcfg)
    tstate = state_from_jax(jstate, device="cpu")
    jl, tl, jgrads, jstate, tstate = run_both(jcfg, jstate, jstep, tstate,
                                              range(3))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert_params_match(jstate["params"], tstate["params"], jgrads)
    assert int(tstate["step"]) == 3 and int(tstate["opt"]["count"]) == 3


def test_warmup_learning_rate_is_zero_at_step_zero():
    """optax evaluates the schedule at the count before the increment,
    so the first warmup step is a true no-op (tests/test_llama.py:273)."""
    cfg = tllama.LlamaConfig(warmup_steps=4, total_steps=20)
    optimizer, step = tllama.make_train_step(cfg, device="cpu")
    params = tllama.init_llama_params(cfg, device="cpu")
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    assert float(optimizer.learning_rate(torch.tensor(0))) == 0.0
    state, _ = step(state, tllama.make_token_batch(0, cfg, device="cpu"))
    for a, b in zip(tree_leaves(params), tree_leaves(state["params"])):
        assert torch.equal(a, b)
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate, warmup_steps=4,
        decay_steps=20)
    for count in (1, 3, 4, 5, 12, 20, 25):
        np.testing.assert_allclose(
            float(optimizer.learning_rate(torch.tensor(count))),
            float(schedule(count)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_update_matches_optax(clip):
    """One update of a random tree, bf16 and f32 leaves: the numerics of
    optax.adamw behind clip_by_global_norm, moments in the leaf dtype."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32),
             "b": [rng.standard_normal(7).astype(np.float32) * 1e-3]}
    opt = optax.adamw(1e-2)
    if clip:
        opt = optax.chain(optax.clip_by_global_norm(clip), opt)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = opt.init(jparams)
    tparams = params_from_jax(params, device="cpu")
    tstate = state_from_jax({"params": params, "opt": jopt,
                             "step": np.int32(0)}, device="cpu")["opt"]
    port = AdamW(1e-2, clip_norm=clip)
    for _ in range(2):
        updates, jopt = opt.update(jax.tree.map(jnp.asarray, grads), jopt,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate = port.update(params_from_jax(grads, device="cpu"),
                                      tstate, tparams)
    for a, b in zip(numpy_leaves(jparams), numpy_leaves(tparams)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    for name in ("mu", "nu"):
        adam = jax.tree.leaves(jopt, is_leaf=lambda x: hasattr(x, "mu"))[0]
        want = numpy_leaves(getattr(adam, name))
        for a, b in zip(want, numpy_leaves(tstate[name])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    bf = params_from_jax(params, device="cpu", dtype=torch.bfloat16)
    state = port.init(bf)
    assert state["mu"]["a"].dtype == torch.bfloat16
    new, _ = port.update(params_from_jax(grads, device="cpu",
                                         dtype=torch.bfloat16), state, bf)
    assert new["b"][0].dtype == torch.bfloat16


def test_clip_scales_by_max_norm_over_norm_without_epsilon():
    grads = {"w": torch.tensor([3.0, 4.0])}  # global norm 5
    port = AdamW(1.0, weight_decay=0.0, clip_norm=5.0)
    params = {"w": torch.zeros(2)}
    # at norm == max_norm optax scales (by exactly 1); one step of Adam
    # from zero moments moves each element by -lr * sign(g) * |g|/(|g|+eps)
    new, state = port.update(grads, port.init(params), params)
    np.testing.assert_allclose(state["mu"]["w"].numpy(), [0.3, 0.4],
                               rtol=1e-6)
    port = AdamW(1.0, weight_decay=0.0, clip_norm=2.5)
    _, state = port.update(grads, port.init(params), params)
    np.testing.assert_allclose(state["mu"]["w"].numpy(), [0.15, 0.2],
                               rtol=1e-6)


@pytest.mark.parametrize("impl,seq", [("xla", 32), ("flash", 128)])
def test_remat_gives_the_same_logits_and_gradients(impl, seq):
    cfg = tllama.LlamaConfig(d_model=64, n_heads=4, n_kv_heads=2,
                             attention_impl=impl)
    remat = dataclasses.replace(cfg, remat=True)
    params = tllama.init_llama_params(cfg, seed=4, device="cpu")
    toks = tllama.make_token_batch(0, dataclasses.replace(cfg, seq_len=seq),
                                   device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(
            tllama.forward(params, toks, remat).numpy(),
            tllama.forward(params, toks, cfg).numpy(), rtol=1e-6, atol=1e-6)
    loss_a, grads_a = value_and_grad(tllama.next_token_loss, params, toks,
                                     cfg)
    loss_b, grads_b = value_and_grad(tllama.next_token_loss, params, toks,
                                     remat)
    assert abs(float(loss_a) - float(loss_b)) < 1e-6
    for a, b in zip(tree_leaves(grads_a), tree_leaves(grads_b)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_remat_recomputes_the_flash_forward(monkeypatch):
    """With remat the backward pass runs each layer's forward again: the
    flash forward is called twice per layer, without it once."""
    from tpu_operator_libs_torch.kernels import flash_attention as fa

    calls = []
    real = fa.flash_forward
    monkeypatch.setattr(fa, "flash_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = tllama.LlamaConfig(d_model=64, n_heads=4, n_kv_heads=2,
                             attention_impl="flash", seq_len=16)
    params = tllama.init_llama_params(cfg, device="cpu")
    toks = tllama.make_token_batch(0, cfg, device="cpu")
    for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        calls.clear()
        value_and_grad(tllama.next_token_loss, params, toks,
                       dataclasses.replace(cfg, remat=remat))
        assert len(calls) == want


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["adamw", "clip_chain"])
def test_state_from_jax_continues_a_jax_run(clip):
    """Two JAX steps, the state carried across, then one port step equals
    JAX's third step (the clip chain nests the Adam state in tuples)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig(), grad_clip_norm=clip)
    jstate, jstep = jax_state(jcfg, seed=5)
    mesh = one_device_mesh()
    for i in range(2):
        jstate, _ = jstep(jstate, jllama.make_token_batch(mesh, i, jcfg))
    tstate = state_from_jax(jstate, device="cpu")
    assert int(tstate["step"]) == 2 and int(tstate["opt"]["count"]) == 2
    jl, tl, jgrads, jstate, tstate = run_both(jcfg, jstate, jstep, tstate,
                                              [2])
    assert abs(tl[0] - jl[0]) < LOSS_TOL
    assert_params_match(jstate["params"], tstate["params"], jgrads)


def test_state_from_jax_needs_an_adam_state():
    with pytest.raises(ValueError, match="Adam"):
        state_from_jax({"params": {}, "opt": (), "step": np.int32(0)},
                       device="cpu")


def test_learns_the_synthetic_rule():
    """tests/test_llama.py:151-166: the loss at step 40 is below half the
    first."""
    cfg = tllama.LlamaConfig()
    optimizer, step = tllama.make_train_step(cfg, device="cpu")
    params = tllama.init_llama_params(cfg, device="cpu")
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for i in range(40):
        state, loss = step(state, tllama.make_token_batch(i, cfg,
                                                          device="cpu"))
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]


@pytest.mark.parametrize("knobs", [
    {"total_steps": -1},
    {"warmup_steps": 3},
    {"warmup_steps": 5, "total_steps": 5},
    {"grad_clip_norm": -1.0},
])
def test_train_step_refuses_what_jax_refuses(knobs):
    jcfg = dataclasses.replace(jllama.LlamaConfig(), **knobs)
    with pytest.raises(ValueError) as want:
        jllama.make_train_step(one_device_mesh(), jcfg)
    with pytest.raises(ValueError) as got:
        tllama.make_train_step(port_config(jcfg), device="cpu")
    assert str(got.value) == str(want.value)


def test_train_step_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.make_train_step(tllama.LlamaConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.make_token_batch(0, tllama.LlamaConfig())


def test_config_for_mesh_matches_the_reference():
    for tp in (1, 3):
        assert dataclasses.asdict(tllama.config_for_mesh(tp)) \
            == dataclasses.asdict(jllama.config_for_mesh(tp))

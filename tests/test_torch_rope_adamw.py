"""The train step's RoPE and AdamW on the CPU: ``kernels/rope.py`` and
``kernels/adamw.py`` (their plain versions here, the kernels in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 3g) against the
JAX package's ``_rope`` (forward and ``jax.vjp``) and optax's ``adamw``,
the explicit RoPE backward against autograd bit for bit, an emulation of
the AdamW kernel's roundings against the plain update bit for bit, and
the wrappers' dispatch and checks.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs_torch.convert import params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.kernels import SOURCES, WRAPPERS, _build
from tpu_operator_libs_torch.kernels import adamw as amod
from tpu_operator_libs_torch.kernels import kv_append as kmod
from tpu_operator_libs_torch.kernels import rope as rmod
from tpu_operator_libs_torch.kernels.adamw import (
    adamw_update,
    adamw_update_reference,
)
from tpu_operator_libs_torch.kernels.rope import (
    rope_backward_reference,
    rope_bwd,
    rope_qk,
    rope_reference,
)
from tpu_operator_libs_torch.optim import AdamW, tree_leaves, tree_map

THETA = 10000.0
#: f32 rotations against JAX's: test_torch_llama.py's test_rope_matches_jax
F32_TOL = 1e-5
#: AdamW against optax in f32: test_torch_train.py's
#: test_optimizer_update_matches_optax (params 1e-6 / 1e-7, moments 1e-9)
ADAM_RTOL, ADAM_ATOL, MOMENT_ATOL = 1e-6, 1e-7, 1e-9
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def bits(t):
    """``t``'s bits as integers: equal bits, not equal values (-0, +0)."""
    return t.contiguous().view({4: torch.int32, 2: torch.int16}[
        t.element_size()])


def assert_close_as(got, want, what):
    """bf16 within one ulp, f32 within F32_TOL."""
    assert got.dtype == want.dtype, what
    if got.dtype == torch.bfloat16:
        assert chip_smoke.max_ulp(got, want) <= 1, what
    else:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   msg=what)


def to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def from_jax(x):
    return params_from_jax({"x": x}, device="cpu")["x"]


# --- RoPE -----------------------------------------------------------------

POSITIONS = {"default": None, "ring_block": 2048}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("start", list(POSITIONS.values()),
                         ids=list(POSITIONS))
@pytest.mark.parametrize("dim", [16, 64])
def test_rope_reference_matches_jax(dtype, start, dim):
    rng = np.random.default_rng(dim)
    x = randn(rng, (2, 12, 3, dim), dtype)
    tpos = None if start is None else start + torch.arange(12)
    jpos = None if start is None else start + jnp.arange(12)
    want = from_jax(jllama._rope(to_jax(x), THETA, jpos))
    assert_close_as(rope_reference(x, THETA, tpos), want, "rope")


def zeros_planted(rng, shape, dtype):
    """Random gradients with zeros and negative zeros among them."""
    dy = randn(rng, shape, dtype)
    dy[0, :2] = 0.0
    dy[-1, 0, 0, : shape[-1] // 2] = -0.0
    dy[-1, 1] = -0.0
    return dy


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("start", list(POSITIONS.values()),
                         ids=list(POSITIONS))
@pytest.mark.parametrize("dim", [16, 18, 64])
def test_rope_backward_reference_is_autograd_bit_for_bit(dtype, start, dim):
    """The explicit backward rounds as autograd through rope_reference
    does, to the bit (signed zeros included: autograd adds the two
    half-slices' gradients into zeros, so -0 comes out as +0)."""
    rng = np.random.default_rng(7 + dim)
    x = randn(rng, (2, 9, 3, dim), dtype).requires_grad_()
    dy = zeros_planted(rng, (2, 9, 3, dim), dtype)
    pos = None if start is None else start + torch.arange(9)
    (want,) = torch.autograd.grad(rope_reference(x, THETA, pos), x, dy)
    got = rope_backward_reference(dy, THETA, pos)
    assert got.dtype == dtype
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("start", list(POSITIONS.values()),
                         ids=list(POSITIONS))
def test_rope_backward_reference_matches_jax_vjp(dtype, start):
    rng = np.random.default_rng(11)
    x = randn(rng, (2, 12, 4, 64), dtype)
    dy = randn(rng, (2, 12, 4, 64), dtype)
    jpos = None if start is None else start + jnp.arange(12)
    _, vjp = jax.vjp(lambda t: jllama._rope(t, THETA, jpos), to_jax(x))
    (want,) = vjp(to_jax(dy))
    pos = None if start is None else start + torch.arange(12)
    assert_close_as(rope_backward_reference(dy, THETA, pos), from_jax(want),
                    "rope backward")


def qkv(rng, dtype, seq=10, heads=4, kv_heads=2, dim=16):
    return (randn(rng, (2, seq, heads, dim), dtype),
            randn(rng, (2, seq, kv_heads, dim), dtype),
            randn(rng, (2, seq, kv_heads, dim), dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_head_major_output_is_the_transposed_natural_one(dtype):
    q, k, v = qkv(np.random.default_rng(1), dtype)
    pos = 100 + torch.arange(10)
    q_rot, k_rot = rope_qk(q, k, THETA, pos)
    assert torch.equal(q_rot, rope_reference(q, THETA, pos))
    assert torch.equal(k_rot, rope_reference(k, THETA, pos))
    hq, hk, hv = rope_qk(q, k, THETA, pos, v=v, head_major=True)
    for got, want in ((hq, q_rot), (hk, k_rot), (hv, v)):
        assert got.is_contiguous()
        assert torch.equal(got, want.transpose(1, 2))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("head_major", [False, True],
                         ids=["natural", "head_major"])
def test_rope_qk_gradients_equal_autograd_of_the_plain_rotation(
        dtype, head_major):
    """rope_qk's autograd Function (its backward rope_bwd) against
    autograd through rope_reference and the transposes the flash path
    made before: the same bits."""
    rng = np.random.default_rng(2)
    q, k, v = qkv(rng, dtype)
    pos = torch.arange(10) + 7
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    if head_major:
        outs = rope_qk(*mine[:2], THETA, pos, v=mine[2], head_major=True)
        refs = [t.transpose(1, 2).contiguous() for t in (
            rope_reference(plain[0], THETA, pos),
            rope_reference(plain[1], THETA, pos), plain[2])]
    else:
        outs = rope_qk(*mine[:2], THETA, pos)
        refs = [rope_reference(t, THETA, pos) for t in plain[:2]]
    grads_out = [zeros_planted(rng, t.shape, dtype) for t in outs]
    n = len(outs)
    got = torch.autograd.grad(outs, mine[:n], grads_out)
    want = torch.autograd.grad(refs, plain[:n], grads_out)
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))


def test_rope_bwd_takes_head_major_gradients_back():
    rng = np.random.default_rng(3)
    dq, dk, dv = (t.transpose(1, 2).contiguous()
                  for t in qkv(rng, torch.bfloat16))
    got = rope_bwd(dq, dk, THETA, dv=dv, head_major=True)
    assert [tuple(t.shape) for t in got] == [(2, 10, 4, 16), (2, 10, 2, 16),
                                             (2, 10, 2, 16)]
    assert torch.equal(got[0], rope_backward_reference(
        dq.transpose(1, 2), THETA))
    assert torch.equal(got[2], dv.transpose(1, 2))


def bad_rope_inputs():
    q, k, v = qkv(np.random.default_rng(4), torch.float32)
    meta = torch.empty(q.shape, device="meta")
    return {
        "odd_head_dim": (q[..., :15], k[..., :15], {}),
        "half_dtype": (q.half(), k.half(), {}),
        "mixed_dtypes": (q, k.bfloat16(), {}),
        "mixed_devices": (q, torch.empty(k.shape, device="meta"), {}),
        "unknown_device": (meta, torch.empty(k.shape, device="meta"), {}),
        "positions_int32": (q, k, {"positions": torch.arange(
            10, dtype=torch.int32)}),
        "positions_length": (q, k, {"positions": torch.arange(9)}),
        "v_without_head_major": (q, k, {"v": v}),
        "v_shape": (q, k, {"v": v[:, :, :1], "head_major": True}),
        "k_length": (q, k[:, :9], {}),
        "theta": (q, k, {"theta": 0.0}),
    }


@pytest.mark.parametrize("case", list(bad_rope_inputs()))
def test_rope_qk_rejects_what_the_kernel_does_not_take(case):
    q, k, kw = bad_rope_inputs()[case]
    theta = kw.pop("theta", THETA)
    before = {n: WRAPPERS[n].launches for n in ("rope", "rope_bwd")}
    with pytest.raises(ValueError):
        rope_qk(q, k, theta, **kw)
    assert before == {n: WRAPPERS[n].launches for n in ("rope", "rope_bwd")}


def test_rope_on_the_cpu_runs_the_plain_version_and_launches_nothing():
    q, k, v = (t.requires_grad_() for t in qkv(np.random.default_rng(5),
                                                torch.bfloat16))
    before = {n: WRAPPERS[n].launches for n in ("rope", "rope_bwd")}
    freqs = dict(rmod._freqs)
    outs = rope_qk(q, k, THETA, v=v, head_major=True)
    torch.autograd.grad(outs, (q, k, v), [torch.ones_like(t) for t in outs])
    assert before == {n: WRAPPERS[n].launches for n in ("rope", "rope_bwd")}
    # no buffer made for a kernel, and the cache write's frequencies are
    # the same cache
    assert rmod._freqs == freqs and kmod._freqs is rmod._freqs
    assert kmod._rope is rope_reference is tllama._rope


def test_rope_vector_width_and_head_groups():
    """The pairs a thread (16-byte loads where alignment allows) and the
    grid's head groups, which fill 132 SMs at the train and ring shapes
    and never exceed the heads."""
    bf = torch.empty(64, dtype=torch.bfloat16)
    f32 = torch.empty(64)
    assert rmod.vector_width(128, bf) == 8
    assert rmod.vector_width(128, f32) == 8
    assert rmod.vector_width(16, bf[1:]) == 1
    assert rmod.vector_width(8, bf) == 4
    assert rmod.vector_width(18, bf) == 1
    # train (16, 1024), q, k and v heads 48; the ring block (1, 2048), 32
    assert rmod.splits(16 * 1024, 128, 8, 48, 132) == 3
    assert rmod.splits(2048, 128, 8, 32, 132) == 17
    assert rmod.splits(4, 16, 8, 6, 132) == 6
    assert rmod.splits(10 ** 6, 128, 8, 48, 132) == 1


# --- AdamW ----------------------------------------------------------------


def leaf_lists(rng, dtype, shapes=((4, 5), (7,), (3, 2, 2))):
    params = [randn(rng, s, dtype) for s in shapes]
    grads = [randn(rng, s, dtype) * 1e-2 for s in shapes]
    mu = [randn(rng, s, dtype) * 1e-3 for s in shapes]
    nu = [(randn(rng, s, torch.float32) * 1e-3).square().to(dtype)
          for s in shapes]
    return grads, mu, nu, params


OPTAX_CASES = {
    "constant": {},
    "schedule": {"warmup_steps": 2, "total_steps": 8},
    "clip": {"clip_norm": 0.05},
    "adam": {"weight_decay": 0.0},
}


@pytest.mark.parametrize("case", list(OPTAX_CASES))
def test_adamw_reference_matches_optax(case):
    """Three updates of adamw_update_reference against optax on JAX's
    inputs, f32: a constant rate, the warmup-cosine schedule, the clip
    (a norm above the limit) and optax.adam (weight decay 0)."""
    kw = OPTAX_CASES[case]
    port = AdamW(1e-2, **kw)
    if "total_steps" in kw:
        lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=1e-2, warmup_steps=2,
            decay_steps=8)
    else:
        lr = 1e-2
    opt = (optax.adam(lr) if case == "adam" else optax.adamw(lr))
    if "clip_norm" in kw:
        opt = optax.chain(optax.clip_by_global_norm(kw["clip_norm"]), opt)
    rng = np.random.default_rng(8)
    grads_np = [[rng.standard_normal(s).astype(np.float32) * 0.1
                 for s in ((4, 5), (7,))] for _ in range(3)]
    params_np = [rng.standard_normal(s).astype(np.float32)
                 for s in ((4, 5), (7,))]
    jparams = [jnp.asarray(p) for p in params_np]
    jstate = opt.init(jparams)
    params = [torch.from_numpy(p) for p in params_np]
    state = {"count": torch.zeros((), dtype=torch.int32),
             "mu": [torch.zeros_like(p) for p in params],
             "nu": [torch.zeros_like(p) for p in params]}
    for grads in grads_np:
        updates, jstate = opt.update([jnp.asarray(g) for g in grads],
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = [torch.from_numpy(g) for g in grads]
        norm = torch.sqrt(sum(g.square().sum() for g in tgrads)) \
            if port.clip_norm else None
        params, state = adamw_update_reference(
            tgrads, state, params, lr=port.learning_rate(state["count"]),
            weight_decay=port.weight_decay, clip_norm=port.clip_norm,
            norm=norm)
    for got, want in zip(params, jparams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)
    adam = [s for s in jax.tree.leaves(
        jstate, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    for name in ("mu", "nu"):
        for got, want in zip(state[name], getattr(adam, name)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=ADAM_RTOL, atol=MOMENT_ATOL)
    assert int(state["count"]) == 3


def former_update(opt, grads, state, params):
    """``AdamW.update``'s body before the kernel, on trees: the plain
    version must stay this, op for op."""
    B1, B2, EPS = 0.9, 0.999, 1e-8
    if opt.clip_norm > 0.0:
        norm = torch.sqrt(sum(g.float().square().sum()
                              for g in tree_leaves(grads)))
        keep = norm < opt.clip_norm
        grads = tree_map(lambda g: torch.where(
            keep, g, g / norm.to(g.dtype) * opt.clip_norm), grads)
    mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - B2) * g * g + B2 * v, grads,
                  state["nu"])
    count = state["count"] + 1
    bias1 = 1 - torch.pow(B1, count.float())
    bias2 = 1 - torch.pow(B2, count.float())
    lr = opt.learning_rate(state["count"])

    def step(p, m, v):
        u = (m / bias1.to(m.dtype)) / (
            torch.sqrt(v / bias2.to(v.dtype)) + EPS)
        if opt.weight_decay:
            u = u + opt.weight_decay * p
        if isinstance(lr, torch.Tensor):
            u = (-lr).to(u.dtype) * u
        else:
            u = u * -lr
        return (p + u).to(p.dtype)

    return tree_map(step, params, mu, nu), {"count": count, "mu": mu,
                                            "nu": nu}


UPDATE_CASES = {
    "constant": {},
    "schedule_count5": {"warmup_steps": 2, "total_steps": 8},
    "clip_above": {"clip_norm": 0.01},
    "clip_below": {"clip_norm": 100.0},
    "adam": {"weight_decay": 0.0},
}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_is_the_former_body_bit_for_bit(dtype, case):
    """AdamW.update on nested trees (leaves flattened in params' order,
    whatever order the state's dicts hold) equals its former body to the
    bit, and leaves its arguments as they were."""
    opt = AdamW(1e-2, **UPDATE_CASES[case])
    grads, mu, nu, params = leaf_lists(np.random.default_rng(9), dtype)
    tree = {"a": params[0], "layers": [{"w": params[1], "b": params[2]}]}

    def like(leaves):
        return {"a": leaves[0], "layers": [{"w": leaves[1],
                                            "b": leaves[2]}]}

    count = torch.tensor(5 if "schedule" in case else 0, dtype=torch.int32)
    # the state's dicts in another order than params'
    state = {"count": count,
             "mu": {"layers": [{"b": mu[2], "w": mu[1]}], "a": mu[0]},
             "nu": like(nu)}
    before = [t.clone() for t in grads + mu + nu + params]
    got_p, got_s = opt.update(like(grads), state, tree)
    want_p, want_s = former_update(opt, like(grads), state, tree)
    for a, b in zip(tree_leaves(got_p) + tree_leaves(got_s["mu"])
                    + tree_leaves(got_s["nu"]),
                    tree_leaves(want_p) + tree_leaves(tree_map(
                        lambda _, x: x, tree, want_s["mu"]))
                    + tree_leaves(want_s["nu"])):
        assert a.dtype == dtype and torch.equal(bits(a), bits(b))
    assert torch.equal(got_s["count"], want_s["count"])
    for a, b in zip(before, grads + mu + nu + params):
        assert torch.equal(bits(a), bits(b))


def kernel_emulation(grads, state, params, *, lr, weight_decay,
                     clip_norm=0.0, norm=None):
    """csrc/adamw.cu's arithmetic, element by element in float32 with
    each operation rounded to the leaves' dtype where the source rounds
    (R): the derivation the kernel's bit-equality rests on."""
    dtype = params[0].dtype

    def r(x):
        return x.to(dtype).float()

    def f32(x):  # a Python number as the kernel's float argument
        return torch.tensor(x, dtype=torch.float32)

    count = state["count"] + 1
    bias1 = r(1 - torch.pow(0.9, count.float()))
    bias2 = r(1 - torch.pow(0.999, count.float()))
    c1, b1, c2, b2 = f32(1 - 0.9), f32(0.9), f32(1 - 0.999), f32(0.999)
    out = ([], [], [])
    for g, m, v, p in zip(grads, state["mu"], state["nu"], params):
        g, m, v, p = g.float(), m.float(), v.float(), p.float()
        if clip_norm > 0.0 and not bool(norm < clip_norm):
            g = r(r(g / r(norm)) * f32(clip_norm))
        m = r(r(c1 * g) + r(b1 * m))
        v = r(r(r(c2 * g) * g) + r(b2 * v))
        u = r(r(m / bias1) / r(r(torch.sqrt(r(v / bias2))) + f32(1e-8)))
        if weight_decay:
            u = r(u + r(f32(weight_decay) * p))
        if isinstance(lr, torch.Tensor):
            u = r(r(-lr) * u)
        else:
            u = r(u * f32(-lr))
        for lst, t in zip(out, (r(p + u), m, v)):
            lst.append(t.to(dtype))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_kernel_roundings_give_the_plain_update(dtype, case):
    """The kernel's per-element operations, emulated, equal the plain
    update to the bit, as the card must show."""
    opt = AdamW(3e-2, **UPDATE_CASES[case])
    grads, mu, nu, params = leaf_lists(np.random.default_rng(10), dtype,
                                       ((64, 33), (101,)))
    count = torch.tensor(5 if "schedule" in case else 0, dtype=torch.int32)
    state = {"count": count, "mu": mu, "nu": nu}
    norm = (torch.sqrt(sum(g.float().square().sum() for g in grads))
            if opt.clip_norm else None)
    kw = {"lr": opt.learning_rate(count), "weight_decay": opt.weight_decay,
          "clip_norm": opt.clip_norm, "norm": norm}
    want_p, want_s = adamw_update_reference(grads, state, params, **kw)
    got_p, got_m, got_v = kernel_emulation(grads, state, params, **kw)
    for a, b in zip(got_p + got_m + got_v,
                    want_p + want_s["mu"] + want_s["nu"]):
        assert torch.equal(bits(a), bits(b))


def bad_adamw_inputs():
    grads, mu, nu, params = leaf_lists(np.random.default_rng(12),
                                       torch.float32)
    meta = [torch.empty(p.shape, device="meta") for p in params]
    count = torch.zeros((), dtype=torch.int32)
    return {
        "lengths": (grads[:2], {"count": count, "mu": mu, "nu": nu},
                    params, {}),
        "empty": ([], {"count": count, "mu": [], "nu": []}, [], {}),
        "shapes": (grads, {"count": count, "mu": mu[::-1], "nu": nu},
                   params, {}),
        "mixed_devices": (meta, {"count": count, "mu": mu, "nu": nu},
                          params, {}),
        "count_device": (grads, {"count": count.to("meta"), "mu": mu,
                                 "nu": nu}, params, {}),
        "unknown_device": (meta, {"count": count.to("meta"), "mu": meta,
                                  "nu": meta}, meta, {}),
        "clip_without_norm": (grads, {"count": count, "mu": mu, "nu": nu},
                              params, {"clip_norm": 1.0}),
    }


@pytest.mark.parametrize("case", list(bad_adamw_inputs()))
def test_adamw_update_rejects_bad_inputs(case):
    grads, state, params, kw = bad_adamw_inputs()[case]
    before = WRAPPERS["adamw"].launches
    with pytest.raises(ValueError):
        adamw_update(grads, state, params, lr=1e-3, weight_decay=1e-4,
                     **kw)
    assert WRAPPERS["adamw"].launches == before


def test_adamw_on_the_cpu_runs_the_plain_version_and_launches_nothing():
    grads, mu, nu, params = leaf_lists(np.random.default_rng(13),
                                       torch.bfloat16)
    state = {"count": torch.zeros((), dtype=torch.int32), "mu": mu,
             "nu": nu}
    before = WRAPPERS["adamw"].launches
    got = adamw_update(grads, state, params, lr=1e-3, weight_decay=1e-4)
    want = adamw_update_reference(grads, state, params, lr=1e-3,
                                  weight_decay=1e-4)
    assert WRAPPERS["adamw"].launches == before
    for a, b in zip(got[0] + got[1]["mu"], want[0] + want[1]["mu"]):
        assert torch.equal(bits(a), bits(b))


def test_the_train_step_runs_the_wrappers(monkeypatch):
    """One CPU train step of a small Llama on the flash path rotates
    through rope_qk (the head-major layout, forward and backward, once a
    layer each) and updates through adamw_update, once."""
    cfg = tllama.LlamaConfig(d_model=64, n_heads=4, n_kv_heads=2,
                             attention_impl="flash", seq_len=16)
    calls = {}

    def count(module, name):
        original = getattr(module, name)

        def fn(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return original(*args, **kw)
        monkeypatch.setattr(module, name, fn)

    count(rmod, "_plain")
    count(rmod, "_plain_backward")
    count(amod, "adamw_update_reference")
    optimizer, step = tllama.make_train_step(cfg, device="cpu")
    params = tllama.init_llama_params(cfg, seed=3, device="cpu")
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    new, loss = step(state, tllama.make_token_batch(0, cfg, device="cpu"))
    assert calls == {"_plain": cfg.n_layers,
                     "_plain_backward": cfg.n_layers,
                     "adamw_update_reference": 1}
    assert torch.isfinite(loss) and int(new["step"]) == 1


def test_wrappers_sources_and_kernel_constants():
    """Both kernels are listed with their counters and sources, and the
    wrapper's count of launches takes the source's leaves a launch."""
    for name in ("rope", "rope_bwd", "adamw"):
        assert isinstance(WRAPPERS[name].launches, int)
    assert {"rope.cu", "adamw.cu"} <= set(SOURCES)
    adamw_src = (_build.CSRC_DIR / "adamw.cu").read_text()
    assert re.search(r"constexpr int kMaxLeaves = (\d+);", adamw_src) \
        .group(1) == str(amod.MAX_LEAVES)
    assert amod.vector_width(torch.empty(8), torch.empty(8)) == 4
    assert amod.vector_width(torch.empty(16, dtype=torch.bfloat16)) == 8
    assert amod.vector_width(torch.empty(9)[1:]) == 1

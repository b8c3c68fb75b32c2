"""The next-token loss and the clip's global norm of the port's train
step against the JAX package and optax, on the CPU.

``kernels/cross_entropy.py``'s plain versions and :class:`NextTokenLoss`
(which runs them on the CPU) against ``jax.nn.log_softmax`` /
``take_along_axis`` / the mean of ``tpu_operator_libs/examples/llama.py::
next_token_loss`` (``:338-341``) and its ``jax.grad`` in the logits;
``next_token_loss`` and the ring's ``_ring_loss`` on a tiny model against
JAX's; ``kernels/global_norm.py``'s plain version and
``parallel.global_norm`` against ``optax.global_norm``, with the bfloat16
norm's difference from optax pinned. Inputs are made with numpy from a
seed and handed to both packages. The kernels themselves run on the card
only: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 3g.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from test_torch_train import (
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_TOL,
    assert_grads_match,
    numpy_leaves,
)
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs_torch.convert import params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.kernels import SOURCES, WRAPPERS, _build
from tpu_operator_libs_torch.kernels import cross_entropy as cmod
from tpu_operator_libs_torch.kernels import global_norm as nmod
from tpu_operator_libs_torch.kernels.adamw import clip_reference
from tpu_operator_libs_torch.optim import value_and_grad
from tpu_operator_libs_torch.parallel import Mesh as RankMesh
from tpu_operator_libs_torch.parallel import global_norm

#: the loss, float32 on both sides from the same (exactly widened)
#: logits: the row sums take other orders, so 1e-5 relative
LOSS_RTOL = 1e-5
#: float32 dlogits: tests/test_llama.py:148's gradient tolerance
#: (GRAD_RTOL, GRAD_ATOL); bfloat16 dlogits: one bfloat16 ulp (both
#: sides compute in float32 and round once to bfloat16)
BF16_ULPS = 1
#: the norm, float32 sums of squares in other orders
NORM_RTOL = 1e-5

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def jax_loss(logits, targets):
    """tpu_operator_libs/examples/llama.py:338-341 on logits (B, S_used,
    V) and targets (B, S_used)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    picked = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return -jnp.mean(picked)


def operands(batch, seq, vocab, used, dtype, seed=0):
    """(port logits, port targets, JAX logits, JAX targets) from numpy:
    logits at the scale of a model's (a few units), the targets of the
    first ``used`` positions."""
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((batch, seq, vocab))) \
        .astype(np.float32)
    targets = rng.integers(0, vocab, (batch, used))
    jlogits = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tlogits = torch.from_numpy(np.array(jlogits.astype(jnp.float32))) \
        .to(TORCH_DTYPES[dtype])
    return (tlogits, torch.from_numpy(targets), jlogits,
            jnp.asarray(targets, jnp.int32))


def bf16_ulps(got, want) -> int:
    """The largest distance in bfloat16 ulps between two bfloat16 arrays
    (their bit patterns as ordered integers)."""
    def ordered(x):
        bits = np.asarray(torch.as_tensor(x).view(torch.int16)).astype(
            np.int64)
        return np.where(bits < 0, -(bits & 0x7fff), bits)

    return int(np.max(np.abs(ordered(got) - ordered(want))))


def as_bf16_torch(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))) \
        .to(torch.bfloat16)


CASES = [(dtype, vocab, shift) for dtype in ("float32", "bfloat16")
         for vocab in (16, 1001) for shift in (1, 0)]
IDS = [f"{d}-v{v}-{'s_minus_1' if s else 's'}" for d, v, s in CASES]


@pytest.mark.parametrize("dtype,vocab,shift", CASES, ids=IDS)
def test_loss_and_its_gradient_match_jax(dtype, vocab, shift):
    """The plain version and NextTokenLoss against JAX's loss and its
    gradient in the logits, for S_used = S - 1 (the next-token loss) and
    S (a ring block); the loss within LOSS_RTOL, float32 dlogits within
    (GRAD_RTOL, GRAD_ATOL), bfloat16 dlogits within BF16_ULPS, and the
    positions past S_used exactly 0."""
    batch, seq = 2, 7
    used = seq - shift
    logits, targets, jlogits, jtargets = operands(batch, seq, vocab, used,
                                                  dtype)
    want, jgrad = jax.value_and_grad(
        lambda x: jax_loss(x[:, :used], jtargets))(jlogits)
    plain = cmod.next_token_loss_reference(logits, targets)
    x = logits.clone().requires_grad_()
    loss = cmod.cross_entropy(x, targets)
    loss.backward()
    for got in (plain, loss.detach()):
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert x.grad.dtype == logits.dtype and x.grad.shape == logits.shape
    if dtype == "float32":
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        assert bf16_ulps(x.grad, as_bf16_torch(jgrad)) <= BF16_ULPS
    assert not x.grad[:, used:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("used", [1, 2, 5])
def test_backward_formula_equals_autograd_of_the_plain_version(dtype, used):
    """next_token_loss_backward_reference (what the backward kernel
    computes) against autograd through next_token_loss_reference, at an
    upstream gradient other than 1: float32 within (GRAD_RTOL,
    GRAD_ATOL), bfloat16 within BF16_ULPS (autograd rounds the mean's
    gradient in another order); every row past S_used exactly 0."""
    logits, targets, _, _ = operands(3, 6, 33, used, dtype, seed=used)
    grad = torch.tensor(0.75)
    x = logits.clone().requires_grad_()
    (cmod.next_token_loss_reference(x, targets) * grad).backward()
    got = cmod.next_token_loss_backward_reference(logits, targets, grad)
    assert got.dtype == logits.dtype and got.shape == logits.shape
    assert not got[:, used:].any()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), x.grad.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        assert bf16_ulps(got, x.grad) <= BF16_ULPS


def test_next_token_loss_takes_the_whole_logits():
    """llama.next_token_loss hands the whole (B, S, V) logits and the
    (B, S - 1) targets to the loss, so its gradient is made at full size
    with the last position 0 (no sliced copy, no padding)."""
    cfg = tllama.LlamaConfig(n_layers=1)
    params = tllama.init_llama_params(cfg, device="cpu")
    toks = tllama.make_token_batch(0, cfg, device="cpu")
    seen = {}
    real = cmod.NextTokenLoss.backward

    def spy(ctx, grad):
        out = real(ctx, grad)
        seen["dlogits"] = out[0]
        return out

    cmod.NextTokenLoss.backward = staticmethod(spy)
    try:
        value_and_grad(tllama.next_token_loss, params, toks, cfg)
    finally:
        cmod.NextTokenLoss.backward = staticmethod(real)
    dlogits = seen["dlogits"]
    assert dlogits.shape == (*toks.shape, cfg.vocab)
    assert not dlogits[:, -1].any() and dlogits[:, :-1].any()


def tiny_jax_model(seed=0):
    jcfg = jllama.LlamaConfig(vocab=64, d_model=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, d_ff=128, seq_len=32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    jp = jllama.init_llama_params(mesh, jcfg, seed=seed)
    toks = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab, (2, jcfg.seq_len)).astype(np.int32)
    return jcfg, jp, toks


def one_rank_ring_mesh():
    """A dp 1 x sp 1 mesh of this process alone: the ring's collectives
    are the identity at size 1, so no process group is needed."""
    return RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                    tp_group=None, device=torch.device("cpu"),
                    axis_names=("dp", "sp"), other={"sp": (1, 0, None)})


@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_model_loss_and_gradients_match_jax(impl):
    """next_token_loss (xla) and _ring_loss (ring at sp 1) of a tiny
    Llama against JAX's next_token_loss and its gradients: the loss
    within test_torch_train's LOSS_TOL, every gradient within (GRAD_RTOL,
    GRAD_ATOL) but the few embedding elements at float noise that
    test_torch_train's assert_grads_match counts and bounds."""
    jcfg, jp, toks = tiny_jax_model()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.next_token_loss(p, jnp.asarray(toks), jcfg))(jp)
    cfg = tllama.LlamaConfig(**{**dataclasses.asdict(jcfg),
                                "attention_impl": impl})
    mesh = one_rank_ring_mesh() if impl == "ring" else None
    loss, grads = value_and_grad(tllama.next_token_loss,
                                 params_from_jax(jp, device="cpu"),
                                 torch.from_numpy(toks), cfg, mesh)
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    assert len(numpy_leaves(grads)) == len(numpy_leaves(jgrads))
    assert_grads_match(jgrads, grads)


def test_ring_loss_at_sp_1_equals_next_token_loss_bit_for_bit():
    """At sp 1 the ring's block has S - 1 targets and a share of 1: its
    loss is the next-token loss's, bit for bit (phase 9 holds the ring
    Llama's losses to phase 7's on the card). head_dim 16: the ring's
    flash kernels take 16, 32, 64 and 128."""
    cfg = tllama.LlamaConfig(vocab=64, d_model=64, n_layers=1, n_heads=4,
                             n_kv_heads=2, d_ff=128, seq_len=32)
    params = tllama.init_llama_params(cfg, device="cpu")
    toks = tllama.make_token_batch(3, cfg, device="cpu")
    flat = tllama.next_token_loss(params, toks, cfg)
    ring = tllama.next_token_loss(
        params, toks, dataclasses.replace(cfg, attention_impl="ring"),
        one_rank_ring_mesh())
    assert torch.equal(flat, ring)


def loss_args(case):
    logits = torch.zeros(2, 5, 16)
    targets = torch.zeros(2, 4, dtype=torch.int64)
    return {"f16_logits": (logits.half(), targets),
            "f64_logits": (logits.double(), targets),
            "int32_targets": (logits, targets.int()),
            "strided_logits": (torch.zeros(2, 16, 5).transpose(1, 2),
                               targets),
            "strided_targets": (logits, torch.zeros(2, 8,
                                                    dtype=torch.int64)[:, ::2]),
            "two_d_logits": (logits[0], targets),
            "batch_mismatch": (logits, targets[:1]),
            "too_many_positions": (logits, torch.zeros(2, 6,
                                                       dtype=torch.int64)),
            "no_positions": (logits, targets[:, :0]),
            "target_past_vocab": (logits, targets + 16),
            "negative_target": (logits, targets - 1)}[case]


@pytest.mark.parametrize("case", [
    "f16_logits", "f64_logits", "int32_targets", "strided_logits",
    "strided_targets", "two_d_logits", "batch_mismatch",
    "too_many_positions", "no_positions", "target_past_vocab",
    "negative_target"])
def test_loss_refuses_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        cmod.cross_entropy(*loss_args(case))


def test_loss_on_the_cpu_launches_nothing():
    logits, targets, _, _ = operands(2, 5, 16, 4, "float32")
    before = {n: WRAPPERS[n].launches for n in ("cross_entropy",
                                                "cross_entropy_bwd",
                                                "global_norm")}
    x = logits.requires_grad_()
    cmod.cross_entropy(x, targets).backward()
    global_norm([x.grad])
    assert before == {n: WRAPPERS[n].launches for n in before}


def norm_leaves(dtype, seed=4):
    """numpy gradients of three shapes of a narrow model's leaves (a
    matrix each way and a norm's vector) at a gradient's scale."""
    rng = np.random.default_rng(seed)
    return [(1e-2 * rng.standard_normal(shape)).astype(np.float32)
            for shape in ((256, 96), (96, 256), (256,))]


def test_global_norm_plain_version_matches_optax_in_float32():
    """sum_of_squares' plain version, and parallel.global_norm over a
    nested tree, against optax.global_norm of the same float32 leaves
    within NORM_RTOL."""
    leaves = norm_leaves("float32")
    want = float(optax.global_norm([jnp.asarray(x) for x in leaves]))
    tleaves = [torch.from_numpy(x) for x in leaves]
    sums, norm = nmod.sum_of_squares(tleaves, norm=True)
    assert len(sums) == 3 and norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), want, rtol=NORM_RTOL)
    np.testing.assert_allclose(
        [float(s) for s in sums],
        [float(jnp.sum(jnp.asarray(x) ** 2)) for x in leaves],
        rtol=NORM_RTOL)
    tree = {"a": tleaves[0], "layers": [{"w": tleaves[1], "n": tleaves[2]}]}
    np.testing.assert_allclose(float(global_norm(tree)), want,
                               rtol=NORM_RTOL)


def test_bf16_global_norm_differs_from_optax_within_one_ulp():
    """optax sums a bfloat16 leaf's squares in bfloat16 and returns a
    bfloat16 norm; the port's is float32. Rounded to bfloat16 the port's
    is within one ulp of optax's, and the clip (which divides by the norm
    cast to the leaf's dtype) gives optax's gradients bit for bit at
    thresholds that do not fall between the two norms, wherever the two
    round to the same bfloat16 norm (ROADMAP.md, Queue 3's known
    differences)."""
    leaves = [jnp.asarray(x).astype(jnp.bfloat16)
              for x in norm_leaves("bfloat16")]
    want = optax.global_norm(leaves)
    assert want.dtype == jnp.bfloat16
    tleaves = [as_bf16_torch(x) for x in leaves]
    norm = global_norm(tleaves)
    assert norm.dtype == torch.float32
    optax_norm = torch.tensor(float(want), dtype=torch.bfloat16)
    assert bf16_ulps(norm.to(torch.bfloat16), optax_norm) <= 1
    low = min(float(norm), float(want))
    high = max(float(norm), float(want))
    same = bool(norm.to(torch.bfloat16) == optax_norm)
    for clip in (0.5 * low, 2.0 * high):
        jclipped, _ = optax.clip_by_global_norm(clip).update(leaves, None)
        got = clip_reference(tleaves, norm, clip)
        for g, w in zip(got, jclipped):
            if same or clip > high:
                assert torch.equal(g, as_bf16_torch(w))
            else:
                assert bf16_ulps(g, as_bf16_torch(w)) <= 2


def test_global_norm_refuses_no_leaves():
    with pytest.raises(ValueError):
        nmod.sum_of_squares([])


def test_kernel_constants_match_the_sources():
    """The wrappers' sizes of the kernels' blocks and tables are the
    sources' (the C entries check them), and both sources are built."""
    assert {"cross_entropy.cu", "adamw.cu"} <= set(SOURCES)
    adamw_src = (_build.CSRC_DIR / "adamw.cu").read_text()

    def constant(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert constant(adamw_src, "kThreads") == nmod.THREADS
    assert constant(adamw_src, "kNormVectors") == nmod.NORM_VECTORS
    assert constant(adamw_src, "kMaxLeaves") == nmod.MAX_LEAVES
    for name in ("cross_entropy", "cross_entropy_bwd", "global_norm"):
        assert isinstance(WRAPPERS[name].launches, int)
    assert cmod.vector_width(torch.empty(2, 3, 16)) == 4
    assert cmod.vector_width(torch.empty(2, 3, 16,
                                         dtype=torch.bfloat16)) == 8
    assert cmod.vector_width(torch.empty(2, 3, 1001,
                                         dtype=torch.bfloat16)) == 1


def test_train_launches_count_the_loss_and_the_norm(monkeypatch):
    """chip_smoke.train_launches (what phases 7 and 9 hold the card to)
    against the loss's forwards and backwards and the norm's calls of a
    clipped and an unclipped train step on the CPU."""
    cfg = tllama.LlamaConfig(n_layers=1)
    params = tllama.init_llama_params(cfg, device="cpu")
    real = (cmod.NextTokenLoss.forward, cmod.NextTokenLoss.backward,
            nmod.sum_of_squares)
    for clip in (0.0, 1.0):
        calls = {"cross_entropy": 0, "cross_entropy_bwd": 0,
                 "global_norm": 0}

        def counted(name, fn):
            def call(*args, **kw):
                calls[name] += 1
                return fn(*args, **kw)
            return call

        monkeypatch.setattr(cmod.NextTokenLoss, "forward", staticmethod(
            counted("cross_entropy", real[0])))
        monkeypatch.setattr(cmod.NextTokenLoss, "backward", staticmethod(
            counted("cross_entropy_bwd", real[1])))
        monkeypatch.setattr("tpu_operator_libs_torch.parallel.sum_of_squares",
                            counted("global_norm", real[2]))
        optimizer, step = tllama.make_train_step(
            dataclasses.replace(cfg, grad_clip_norm=clip), device="cpu")
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        step(state, tllama.make_token_batch(0, cfg, device="cpu"))
        monkeypatch.undo()
        want = chip_smoke.train_launches(1, 1, 1, clipped=bool(clip))
        assert calls == {k: want[k] for k in calls}

"""The Llama block's norm (with the residual add folded in) and SwiGLU
gate on the CPU: ``kernels/rms_norm.py`` and ``kernels/swiglu.py`` (the
plain versions here, the kernels in ``tests/test_torch_gpu.py``) against
the JAX package's ``_rms_norm``, ``h + delta`` and ``jax.nn.silu(g) * u``,
their explicit backward formulas against ``jax.vjp`` of the same
expressions, the autograd Functions (with and without ``checkpoint``),
the launch plan, and the call sites: the cached step against JAX's
``forward_with_cache`` and the count of norms and gates a forward runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.checkpoint import checkpoint

import chip_smoke
import norm_gate_variants as ngv
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.convert import params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.kernels import WRAPPERS
from tpu_operator_libs_torch.kernels import rms_norm as rmod
from tpu_operator_libs_torch.kernels import swiglu as smod
from tpu_operator_libs_torch.kernels.rms_norm import (
    add_rms_norm,
    add_rms_norm_reference,
    rms_norm_backward_reference,
    rms_norm_bwd,
    rms_norm_reference,
)
from tpu_operator_libs_torch.kernels.swiglu import (
    swiglu,
    swiglu_backward_reference,
    swiglu_bwd,
    swiglu_reference,
)

#: f32 forwards against JAX: tests/test_torch_llama.py:47-54's tolerance
F32_TOL = 1e-6
#: f32 gradients against jax.vjp: assert_grads_match's
#: (tests/test_torch_train.py:23)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
#: bf16 gradients against jax.vjp, as a share of the leaf's largest
#: element: JAX rounds the gradient to bf16 at each op of the chain (dn =
#: dy * w, each of the two paths into x, their sum), the plain formula
#: once at the end, so the two differ by about two bf16 ulps of the
#: leaf's scale (0.0035-0.0069 of it at these inputs); the norm's
#: backward without its variance term is 0.049-0.118 off, without ds 0.70
BF16_GRAD_REL = 2.0 ** -6
WIDTHS = (32, 33)
DTYPES = ("float32", "bfloat16")
EPS = 1e-5


def arrays(seed, *shapes, dtype="float32", scale=1.0):
    """Seeded numpy arrays cast as JAX casts (bfloat16 round to nearest
    even), which JAX and the port both take."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(
        (rng.standard_normal(shape) * scale).astype(np.float32))
        .astype(dtype)) for shape in shapes]


def to_torch(x):
    return params_from_jax({"x": x}, device="cpu")["x"]


def assert_close_as(got, want, what, ulps=1):
    """f32 within F32_TOL, bf16 within ``ulps`` ulps."""
    assert got.dtype == want.dtype, what
    if got.dtype == torch.bfloat16:
        assert chip_smoke.max_ulp(got, want) <= ulps, what
    else:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   msg=what)


def assert_grad_close(got, want, what):
    assert got.dtype == want.dtype, what
    if got.dtype == torch.bfloat16:
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_GRAD_REL * scale, (what, err, scale)
    else:
        torch.testing.assert_close(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=what)


def jax_add_norm(h, d, w):
    s = h if d is None else h + d
    return s, jllama._rms_norm(s, w)


class TestForwardAgainstJax:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("dim", WIDTHS)
    @pytest.mark.parametrize("fused", [True, False], ids=["add", "no_add"])
    def test_add_rms_norm(self, fused, dim, dtype):
        """``(h + delta, _rms_norm(h + delta, w))`` with and without the
        add: the sum bit-equal, the norm within 1e-6 (f32) or one bf16
        ulp (the variance's sum in another order)."""
        h, d, w = arrays(1 + dim, (2, 5, dim), (2, 5, dim), (dim,),
                         dtype=dtype, scale=3.0)
        want_s, want_y = jax_add_norm(jnp.asarray(h),
                                      jnp.asarray(d) if fused else None,
                                      jnp.asarray(w))
        s, y = add_rms_norm(to_torch(h), to_torch(d) if fused else None,
                            to_torch(w))
        assert torch.equal(s, to_torch(want_s))
        assert_close_as(y, to_torch(want_y), "y")

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("dim", WIDTHS)
    def test_swiglu(self, dim, dtype):
        """``F.silu(g) * u`` against ``jax.nn.silu(g) * u``: 1e-6 in f32,
        two bf16 ulps: JAX's silu is ``x * sigmoid(x)`` with the sigmoid
        rounded to bf16 before its product (one rounding more than
        ``F.silu``'s ``x / (1 + exp(-x))``), and both round silu again
        before the product with u."""
        g, u = arrays(2 + dim, (3, 4, dim), (3, 4, dim), dtype=dtype,
                      scale=3.0)
        want = jax.nn.silu(jnp.asarray(g)) * jnp.asarray(u)
        got = swiglu(to_torch(g), to_torch(u))
        assert torch.equal(got, swiglu_reference(to_torch(g), to_torch(u)))
        assert_close_as(got, to_torch(want), "swiglu", ulps=2)


class TestBackwardAgainstJax:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("dim", WIDTHS)
    @pytest.mark.parametrize("fused", [True, False], ids=["add", "no_add"])
    def test_rms_norm_backward_reference(self, fused, dim, dtype):
        """``rms_norm_backward_reference`` against ``jax.vjp`` of ``(h +
        delta, _rms_norm(h + delta, w))`` with cotangents (ds, dy): dx
        (the same for h and delta) and dw."""
        h, d, w, dy, ds = arrays(3 + dim, *[(2, 5, dim)] * 2, (dim,),
                                 *[(2, 5, dim)] * 2, dtype=dtype,
                                 scale=2.0)
        if fused:
            (_, _), vjp = jax.vjp(jax_add_norm, *map(jnp.asarray, (h, d, w)))
            jdh, jdd, jdw = vjp((jnp.asarray(ds), jnp.asarray(dy)))
            assert np.array_equal(np.asarray(jdh), np.asarray(jdd))
        else:
            _, vjp = jax.vjp(lambda x, w_: jllama._rms_norm(x, w_),
                             jnp.asarray(h), jnp.asarray(w))
            jdh, jdw = vjp(jnp.asarray(dy))
        x = to_torch(h) + to_torch(d) if fused else to_torch(h)
        _, rstd = rmod._rms_parts(x, to_torch(w), EPS)
        dx, dw = rms_norm_backward_reference(
            to_torch(dy), x, to_torch(w), rstd,
            to_torch(ds) if fused else None)
        assert_grad_close(dx, to_torch(jdh), "dx")
        assert_grad_close(dw, to_torch(jdw), "dw")

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("dim", WIDTHS)
    def test_swiglu_backward_reference(self, dim, dtype):
        """``swiglu_backward_reference`` against ``jax.vjp`` of
        ``jax.nn.silu(g) * u``."""
        g, u, dy = arrays(4 + dim, *[(3, 4, dim)] * 3, dtype=dtype,
                          scale=3.0)
        _, vjp = jax.vjp(lambda a, b: jax.nn.silu(a) * b,
                         jnp.asarray(g), jnp.asarray(u))
        jdg, jdu = vjp(jnp.asarray(dy))
        dg, du = swiglu_backward_reference(to_torch(dy), to_torch(g),
                                           to_torch(u))
        assert_grad_close(dg, to_torch(jdg), "dg")
        assert_grad_close(du, to_torch(jdu), "du")


def bf16_round(a):
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def fma32(a, b, c):
    """float32 ``fmaf(a, b, c)``: the product exact in float64, one
    rounding of the sum (twice where float64 itself rounds, which a
    tolerance covers)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_backward(dy, x, w, rstd, ds, p, vec, x_bf16, w_bf16):
    """``rms_norm_bwd_kernel``'s arithmetic in its order, in float32
    numpy from float32 arrays (the loaded values): the row sum (each
    thread's elements in order, vector c = t + i * threads_per_row, by
    fmaf; the warp's butterfly; the row's warps in order), dx with every
    product and sum rounded on its own, and dw (each thread's rows in
    order, from 0; the block's groups in order; each combine group's
    partials in block order, then the groups' sums in group order, each
    from 0), for ``Plan`` p at ``vec`` elements a load."""
    rows, dim = x.shape
    f32 = np.float32
    per_row, per_block = p.threads_per_row, p.rows_per_block
    chunks = dim // vec
    loads = p.loads or -(-chunks // per_row)
    g = dy * w
    cs = np.zeros((rows, per_row), f32)
    t = np.arange(per_row)
    for i in range(loads):
        c = t + i * per_row
        live = c < chunks
        for e in range(vec):
            col = np.where(live, c * vec + e, 0)
            cs = np.where(live, fma32(g[:, col], x[:, col], cs), cs)
    v = cs.reshape(rows, per_row // 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    total = v[:, 0, 0]
    if per_row > 32:
        total = np.zeros(rows, f32)
        for warp in range(per_row // 32):
            total = total + v[:, warp, 0]
    r = rstd[:, None]
    k = (r * r * total[:, None]) / f32(dim)
    dx = r * (g - x * k)
    if ds is not None:
        dx = dx + ds
    n = x * r
    if x_bf16:
        dx, n = bf16_round(dx), bf16_round(n)
    contrib = dy * n
    # the rows of (block b, group j): b * rows_per_block + j + k * stride
    stride = p.blocks * per_block
    acc = np.zeros((p.blocks, per_block, dim), f32)
    first = np.arange(p.blocks * per_block).reshape(p.blocks, per_block)
    for step in range(-(-rows // stride)):
        row = first + step * stride
        live = (row < rows)[..., None]
        acc = np.where(live, acc + contrib[np.minimum(row, rows - 1)], acc)
    partial = acc[:, 0]
    for j in range(1, per_block):
        partial = partial + acc[:, j]
    per = p.blocks_per_group
    sums = []
    for start in range(0, p.blocks, per):
        total = np.zeros(dim, f32)
        for b in range(start, min(p.blocks, start + per)):
            total = total + partial[b]
        sums.append(total)
    dw = sums[0]
    if len(sums) > 1:
        dw = np.zeros(dim, f32)
        for total in sums:
            dw = dw + total
    if w_bf16:
        dw = bf16_round(dw)
    return dx, dw


#: (rows, dim, layout): the wrapper's plan on 132 SMs ("plan": a row a
#: block, a two-level combine), the plan on 3 SMs (several rows a group,
#: one level), and the first with 6 blocks in combine groups of 2
#: ("strided": several rows a group, two levels)
EMULATED_SHAPES = [(rows, dim, layout) for rows, dim in ((37, 256),
                                                         (130, 1001))
                   for layout in ("plan", "three_sms", "strided")]


def emulated_plan(rows, dim, vec, layout, bf16=True):
    if layout == "three_sms":
        return rmod.plan(rows, dim, vec, 3, backward=True, bf16=bf16)
    p = rmod.plan(rows, dim, vec, 132, backward=True, bf16=bf16)
    if layout == "strided":
        p = dataclasses.replace(p, blocks=6, blocks_per_group=2)
    return p


def sum_bound(dy, n):
    """The rounding bound of two float32 sums over the rows of ``dy *
    n`` in different orders: 2 (rows - 1) 2^-24 sum |dy * n| a column."""
    rows = dy.shape[0]
    return 2 * (rows - 1) * 2.0 ** -24 * (dy.float() * n.float()).abs().sum(0)


class TestBackwardSummationOrder:
    """The backward kernel's summation order, emulated on the CPU at the
    plans its wrapper gives, held to the plain formula within the
    kernels' tolerance and to ``jax.vjp`` of the JAX package's
    ``_rms_norm`` within ``TestBackwardAgainstJax``'s. In float32, dw
    against JAX adds ``sum_bound`` to that tolerance: dw sums 37 and 130
    rows here (10 there), and the plain formula itself lands 0.9-4.3
    times the 1e-6 atol off JAX's at these row counts."""

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("rows,dim,layout", EMULATED_SHAPES)
    @pytest.mark.parametrize("fused", [True, False], ids=["ds", "no_ds"])
    def test_emulated_kernel_against_plain_and_jax(self, fused, rows, dim,
                                                   layout, dtype):
        h, d, w, dy, ds = arrays(40 + dim, *[(rows, dim)] * 2, (dim,),
                                 *[(rows, dim)] * 2, dtype=dtype,
                                 scale=2.0)
        if fused:
            (_, _), vjp = jax.vjp(jax_add_norm, *map(jnp.asarray, (h, d, w)))
            jdx, _, jdw = vjp((jnp.asarray(ds), jnp.asarray(dy)))
        else:
            _, vjp = jax.vjp(lambda x, w_: jllama._rms_norm(x, w_),
                             jnp.asarray(h), jnp.asarray(w))
            jdx, jdw = vjp(jnp.asarray(dy))
        x = to_torch(h) + to_torch(d) if fused else to_torch(h)
        tw, tdy = to_torch(w), to_torch(dy)
        tds = to_torch(ds) if fused else None
        _, rstd = rmod._rms_parts(x, tw, EPS)
        vec = rmod.vector_width(dim, x)
        bf16 = dtype == "bfloat16"
        p = emulated_plan(rows, dim, vec, layout, bf16)
        dx, dw = emulate_backward(
            tdy.float().numpy(), x.float().numpy(), tw.float().numpy(),
            rstd.numpy(), None if tds is None else tds.float().numpy(), p,
            vec, bf16, bf16)
        dx = torch.from_numpy(dx).to(x.dtype)
        dw = torch.from_numpy(dw).to(tw.dtype)
        ref_dx, ref_dw = rms_norm_backward_reference(tdy, x, tw, rstd, tds)
        rtol, atol = chip_smoke.KERNEL_TOL[x.dtype]
        torch.testing.assert_close(dx.float(), ref_dx.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(dw.float(), ref_dw.float(), rtol=rtol,
                                   atol=atol)
        assert_grad_close(dx, to_torch(jdx), "dx")
        if bf16:
            assert_grad_close(dw, to_torch(jdw), "dw")
        else:
            n = (x * rstd[:, None]).to(x.dtype)
            limit = GRAD_ATOL + GRAD_RTOL * to_torch(jdw).abs() \
                + sum_bound(tdy, n)
            assert ((dw - to_torch(jdw)).abs() <= limit).all()

    def test_emulation_follows_the_plan(self):
        """The emulated dw depends on the plan's order (a block a row and
        several rows a group give other float32 bits) and equals the plain
        sum where every order is exact (small integers)."""
        rng = np.random.default_rng(41)
        rows, dim = 130, 256
        dy = rng.standard_normal((rows, dim)).astype(np.float32)
        x = rng.standard_normal((rows, dim)).astype(np.float32)
        w, rstd = np.ones(dim, np.float32), np.ones(rows, np.float32)
        layouts = ("plan", "three_sms", "strided")
        got = [emulate_backward(dy, x, w, rstd, None,
                                emulated_plan(rows, dim, 8, layout), 8,
                                False, False)[1] for layout in layouts]
        assert not np.array_equal(got[0], got[1])
        assert not np.array_equal(got[0], got[2])
        ints = rng.integers(-8, 9, (rows, dim)).astype(np.float32)
        for layout in layouts:
            _, dw = emulate_backward(
                ints, np.ones((rows, dim), np.float32), w, rstd, None,
                emulated_plan(rows, dim, 8, layout), 8, False, False)
            assert np.array_equal(dw, ints.sum(axis=0))


def plain_norm_loss(h, d, w, fused):
    """The autograd of the plain expressions, as the yardstick."""
    s = h + d if fused else h
    y = rms_norm_reference(s, w)
    return (y.float() * torch.linspace(-1, 1, y.shape[-1])).sum() \
        + (0.1 * (s.float() ** 2).sum() if fused else 0.0)


class TestAutogradFunctions:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("fused", [True, False], ids=["add", "no_add"])
    def test_norm_gradients(self, fused, dtype):
        """The Function's gradients are the plain backward formula's (the
        residual output's gradient added into dx for both h and delta),
        and in f32 autograd's through the plain expressions within the
        gradient tolerance; no launch is counted on the CPU."""
        torch.manual_seed(5)
        h, d = (torch.randn(3, 4, 33).to(dtype).requires_grad_()
                for _ in range(2))
        w = torch.randn(33).to(dtype).requires_grad_()
        before = (add_rms_norm.launches, rms_norm_bwd.launches)
        s, y = add_rms_norm(h, d if fused else None, w)
        if not fused:
            assert s is h
        loss = (y.float() * torch.linspace(-1, 1, 33)).sum() \
            + (0.1 * (s.float() ** 2).sum() if fused else 0.0)
        # the gradients that reach the Function's outputs
        upstream = torch.autograd.grad(loss, [s, y] if fused else [y],
                                       retain_graph=True)
        inputs = [h, w] + ([d] if fused else [])
        got = torch.autograd.grad(loss, inputs)
        assert (add_rms_norm.launches, rms_norm_bwd.launches) == before
        x = (h + d if fused else h).detach()
        _, rstd = rmod._rms_parts(x, w.detach(), EPS)
        dx, dw = rms_norm_backward_reference(
            upstream[-1], x, w.detach(), rstd,
            upstream[0] if fused else None)
        assert torch.equal(got[0], dx) and torch.equal(got[1], dw)
        if fused:
            assert torch.equal(got[2], dx)
        if dtype == torch.float32:
            refs = [t.detach().clone().requires_grad_() for t in (h, d, w)]
            want = torch.autograd.grad(
                plain_norm_loss(*refs, fused),
                [refs[0], refs[2]] + ([refs[1]] if fused else []))
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_swiglu_gradients(self, dtype):
        """The Function's gradients are the plain backward formula's, and
        autograd's through ``F.silu(g) * u``: bit-equal in bf16 (both
        round dy * u first), within the gradient tolerance in f32."""
        torch.manual_seed(6)
        g, u = (torch.randn(4, 33).mul(3).to(dtype).requires_grad_()
                for _ in range(2))
        dy = torch.randn(4, 33).to(dtype)
        before = (swiglu.launches, swiglu_bwd.launches)
        got = torch.autograd.grad(swiglu(g, u), [g, u], dy)
        assert (swiglu.launches, swiglu_bwd.launches) == before
        want = swiglu_backward_reference(dy, g.detach(), u.detach())
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        g2, u2 = (t.detach().clone().requires_grad_() for t in (g, u))
        auto = torch.autograd.grad(swiglu_reference(g2, u2), [g2, u2], dy)
        for a, b in zip(got, auto):
            torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)

    def test_mixed_dtypes_promote_as_the_plain_version(self):
        """bf16 h under an f32 delta (a bf16 model over an f32 cache):
        the sum and the norm in f32, as ``h + delta`` and ``_rms_norm``."""
        h, w = torch.randn(2, 33).bfloat16(), torch.randn(33).bfloat16()
        d = torch.randn(2, 33)
        s, y = add_rms_norm(h, d, w)
        assert s.dtype == y.dtype == torch.float32
        assert torch.equal(s, h + d)
        assert torch.equal(y, tllama._rms_norm(h + d, w))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_checkpoint_gives_the_same_gradients(self, dtype):
        """A block of both Functions under ``checkpoint(...,
        use_reentrant=False)`` against the same block without it: the
        recompute gives the Functions what they saved, so the gradients
        are bit-equal."""
        torch.manual_seed(7)
        leaves = [torch.randn(2, 3, 32).to(dtype), torch.randn(2, 3, 32)
                  .to(dtype), torch.randn(32).to(dtype),
                  (torch.randn(32, 64) * 0.2).to(dtype),
                  (torch.randn(32, 64) * 0.2).to(dtype),
                  (torch.randn(64, 32) * 0.2).to(dtype)]

        def block(h, d, w, wg, wu, wd):
            s, m = add_rms_norm(h, d, w)
            return s + swiglu(m @ wg, m @ wu) @ wd

        grads = []
        for remat in (False, True):
            inputs = [t.clone().requires_grad_() for t in leaves]
            out = checkpoint(block, *inputs, use_reentrant=False) \
                if remat else block(*inputs)
            grads.append(torch.autograd.grad(out.float().sum(), inputs))
        for a, b in zip(*grads):
            assert torch.equal(a, b)


class TestWrappers:
    def test_listed_with_their_launch_counts(self):
        assert WRAPPERS["rms_norm"] is add_rms_norm
        assert WRAPPERS["rms_norm_bwd"] is rms_norm_bwd
        assert WRAPPERS["swiglu"] is swiglu
        assert WRAPPERS["swiglu_bwd"] is swiglu_bwd
        assert rmod.SOURCE == "rms_norm.cu" and smod.SOURCE == "swiglu.cu"

    def test_the_batch_forward_keeps_the_plain_norm_by_its_name(self):
        assert tllama._rms_norm is rms_norm_reference

    @pytest.mark.parametrize("bad", ["delta_shape", "weight_shape",
                                     "weight_2d", "scalar"])
    def test_bad_shapes_raise(self, bad):
        h, d, w = torch.randn(2, 8), torch.randn(2, 8), torch.randn(8)
        if bad == "delta_shape":
            d = torch.randn(2, 4)
        elif bad == "weight_shape":
            w = torch.randn(4)
        elif bad == "weight_2d":
            w = torch.randn(1, 8)
        else:
            h = torch.tensor(1.0)
        with pytest.raises(ValueError):
            add_rms_norm(h, d, w)

    @pytest.mark.parametrize("fn", ["add_rms_norm", "rms_norm_bwd",
                                    "swiglu", "swiglu_bwd"])
    def test_another_device_raises_rather_than_running_the_plain_version(
            self, fn):
        """Tensors on a device that is neither the CPU nor CUDA (``meta``)
        raise, counting no launch."""
        x = torch.randn(2, 8, device="meta")
        w = torch.randn(8, device="meta")
        before = {name: f.launches for name, f in WRAPPERS.items()}
        with pytest.raises(ValueError, match="unsupported device"):
            if fn == "add_rms_norm":
                add_rms_norm(x, x, w)
            elif fn == "rms_norm_bwd":
                rms_norm_bwd(x, x, w, torch.ones(2, device="meta"))
            elif fn == "swiglu":
                swiglu(x, x)
            else:
                swiglu_bwd(x, x, x)
        assert before == {name: f.launches for name, f in WRAPPERS.items()}

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="meta"):
            add_rms_norm(torch.randn(2, 8), torch.randn(2, 8, device="meta"),
                         torch.randn(8))
        with pytest.raises(ValueError, match="meta"):
            swiglu(torch.randn(2, 8), torch.randn(2, 8, device="meta"))

    def test_gate_shapes_must_match(self):
        with pytest.raises(ValueError, match="differ"):
            swiglu(torch.randn(2, 8), torch.randn(2, 4))


def resident(blocks):
    """A resident-block count for ``plan``: ``blocks`` an SM whatever the
    instance (on the card the wrapper asks the driver)."""
    return lambda *instance: blocks


class TestPlan:
    @pytest.mark.parametrize("rows,dim,vec,want", [
        # the bench decode, bf16: a thread a vector, a row a block, one
        # block a row on 8 SMs
        (8, 2048, 8, (256, 1, 1, 8)),
        # the prefill block: one wave of a row a block (5 an SM)
        (512, 2048, 8, (256, 1, 1, 512)),
        # the train shape: past one wave, two vectors a thread at 128
        # threads, two rows a block, a grid of the resident blocks
        (16384, 2048, 8, (128, 2, 2, 660)),
        # f32 at 4 a load (a misaligned buffer): two vectors a thread
        (8, 2048, 4, (256, 1, 2, 8)),
        # an odd width at element loads: 4 a thread at 256 threads
        (64, 1001, 1, (256, 1, 4, 64)),
        (8, 33, 1, (64, 1, 1, 8)),
        # a row of one warp: no barrier
        (8, 32, 8, (32, 1, 1, 8)),
    ])
    def test_forward(self, rows, dim, vec, want):
        p = rmod.plan(rows, dim, vec, 132, resident=resident(5))
        assert (p.threads_per_row, p.rows_per_block, p.loads,
                p.blocks) == want
        # the register path covers the row; a block's groups fit
        assert p.loads == 0 or p.loads * p.threads_per_row * vec >= dim
        assert p.threads_per_row * p.rows_per_block <= rmod.FORWARD_THREADS

    @pytest.mark.parametrize("rows,want", [
        # within one wave the add changes nothing
        (8, (256, 1, 1, 8)), (512, (256, 1, 1, 512)),
        # past it, a block for every pair of rows
        (16384, (128, 2, 2, 8192)),
    ])
    def test_forward_with_the_add(self, rows, want):
        p = rmod.plan(rows, 2048, 8, 132, resident=resident(5), add=True)
        assert (p.threads_per_row, p.rows_per_block, p.loads,
                p.blocks) == want

    @pytest.mark.parametrize("dim,vec,register_path", [
        # the budget: 4 vectors a thread at 256 threads a row
        (8192, 8, True), (8200, 8, False),
        (4096, 4, True), (4100, 4, False),
        (1024, 1, True), (1025, 1, False),
    ])
    def test_register_budget_edge(self, dim, vec, register_path):
        """A width at the budget holds its row in registers (4 vectors a
        thread); one vector past it takes the two-pass loop at 256
        threads."""
        p = rmod.plan(7, dim, vec, 132)
        assert p.threads_per_row == rmod.MAX_THREADS_PER_ROW
        assert p.loads == (rmod.MAX_LOADS if register_path else 0)
        assert rmod.MAX_LOADS * rmod.MAX_THREADS_PER_ROW * 8 == 8192

    @pytest.mark.parametrize("per_sm,blocks", [(1, 132), (5, 660),
                                               (50, 6600)])
    def test_train_shape_strides_over_its_rows(self, per_sm, blocks):
        """(16384, 2048) without the add: two rows a block, a grid of the
        SMs times the resident blocks, each block taking its pairs of
        rows a turn at a time, every row once."""
        p = rmod.plan(16384, 2048, 8, 132, resident=resident(per_sm))
        assert (p.threads_per_row, p.rows_per_block, p.loads) == (128, 2, 2)
        assert p.blocks == blocks
        groups = -(-16384 // p.rows_per_block)
        turns = [len(range(b, groups, p.blocks)) for b in range(p.blocks)]
        assert sum(turns) * p.rows_per_block == 16384
        assert max(turns) - min(turns) <= 1

    @pytest.mark.parametrize("rows,one_wave", [(660, True), (661, False)])
    def test_one_wave_edge(self, rows, one_wave):
        """One vector a thread while the rows fit one wave of a row a
        block (5 blocks an SM on 132 SMs), two past it."""
        p = rmod.plan(rows, 2048, 8, 132, resident=resident(5))
        assert (p.threads_per_row, p.loads) == (
            (256, 1) if one_wave else (128, 2))

    @pytest.mark.parametrize("rows,dim,want", [
        # narrow rows share a block: a warp a row, 8 rows a block
        (16384, 256, (32, 8, 1, 660)),
        # fewer rows than SMs: a row a block
        (100, 256, (32, 1, 1, 100)),
        (512, 1024, (128, 2, 1, 256)),
    ])
    def test_rows_a_block(self, rows, dim, want):
        p = rmod.plan(rows, dim, 8, 132, resident=resident(5))
        assert (p.threads_per_row, p.rows_per_block, p.loads,
                p.blocks) == want

    def test_forward_plan_takes_the_resident_count_of_its_instance(self):
        asked = []

        def count(loads, threads):
            asked.append((loads, threads))
            return 3

        p = rmod.plan(16384, 2048, 8, 132, resident=count)
        assert asked == [(1, 256), (2, 256)] and p.blocks == 396

    @pytest.mark.parametrize("rows,dim,vec,per_sm,bf16,want", [
        # the train shape: 128 threads x 2 vectors a row, four rows a
        # block, a grid of the resident blocks, dw combined in groups of
        # about the square root of the blocks
        (16384, 2048, 8, 1, True, (128, 4, 2, 132, 12)),
        (16384, 2048, 8, 2, True, (128, 4, 2, 264, 17)),
        (16384, 2048, 8, 3, True, (128, 4, 2, 396, 20)),
        # in f32 (16 registers of each array a thread): blocks of 256
        (16384, 2048, 8, 1, False, (128, 2, 2, 132, 12)),
        # fewer rows than SMs: a row a block, dw in one level
        (8, 2048, 8, 2, True, (128, 1, 2, 8, 8)),
        (8, 2048, 8, 2, False, (128, 1, 2, 8, 8)),
        # the prefill block: a block for every four rows
        (512, 2048, 8, 2, True, (128, 4, 2, 128, 12)),
        (512, 2048, 4, 2, False, (256, 2, 2, 256, 16)),
        # f32 at 4 a load (the decode step of an f32 model)
        (8, 2048, 4, 2, False, (256, 1, 2, 8, 8)),
        # an odd width at element loads: 4 vectors a thread
        (64, 1001, 1, 2, True, (256, 1, 4, 64, 8)),
        (10, 33, 1, 2, False, (32, 1, 2, 10, 10)),
        # 32 elements a thread: blocks of 256 threads
        (7, 8192, 8, 2, True, (256, 1, 4, 7, 7)),
        (16384, 8192, 8, 1, True, (256, 1, 4, 132, 12)),
        (16384, 4096, 8, 1, True, (256, 2, 2, 132, 12)),
        # past the register budget the two-pass loop, a row a block, up
        # to the widest width whose dw sums fit the shared memory
        (7, 8200, 8, 2, True, (256, 1, 0, 7, 7)),
        (7, 58112, 8, 2, True, (256, 1, 0, 7, 7)),
        (7, 58113, 1, 2, True, None),
        (7, 70000, 8, 2, True, None),
    ])
    def test_backward(self, rows, dim, vec, per_sm, bf16, want):
        if want is None:
            with pytest.raises(ValueError, match="shared memory"):
                rmod.plan(rows, dim, vec, 132, backward=True, bf16=bf16)
            return
        p = rmod.plan(rows, dim, vec, 132, backward=True,
                      resident=resident(per_sm), bf16=bf16)
        assert (p.threads_per_row, p.rows_per_block, p.loads, p.blocks,
                p.blocks_per_group) == want
        # the register path covers the row, the two passes take a row a
        # block; a block's groups fit; the combine's groups have counters
        assert (p.loads * p.threads_per_row * vec >= dim if p.loads
                else p.rows_per_block == 1)
        held = p.loads * vec // (2 if bf16 and vec == 8 else 1)
        assert p.threads_per_row * p.rows_per_block <= (
            rmod.BACKWARD_THREADS if held <= 8
            else rmod.WIDE_BACKWARD_THREADS)
        assert -(-p.blocks // p.blocks_per_group) <= rmod.COMBINE_GROUPS
        assert dim * 4 <= rmod.MAX_SMEM_BYTES
        # every block has a row, and the groups' strides take every row
        # once
        assert (p.blocks - 1) * p.rows_per_block < rows
        taken = sorted(row for first in range(p.blocks * p.rows_per_block)
                       for row in range(first, rows,
                                        p.blocks * p.rows_per_block))
        assert taken == list(range(rows))

    @pytest.mark.parametrize("fused", [True, False], ids=["ds", "no_ds"])
    def test_backward_plan_asks_the_resident_count_of_its_instance(
            self, monkeypatch, fused):
        """At the train shape the wrapper's plan asks CUDA's occupancy
        query for the resident blocks of the instance it launches, with
        ds or without (-1), and spreads the blocks it is told of."""
        asked = []

        def count(index, codes, vec, dim, loads, threads):
            asked.append((codes, vec, dim, loads, threads))
            return 2 if fused else 3

        monkeypatch.setattr(rmod, "_bwd_resident", count)
        monkeypatch.setattr(rmod, "sm_count", lambda index: 132)
        p = rmod.backward_plan(16384, 2048, 8, 0, (torch.bfloat16,) * 3
                               + (torch.bfloat16 if fused else None,))
        assert asked == [((1, 1, 1, 1 if fused else -1), 8, 2048, 2, 512)]
        assert p == rmod.Plan(128, 4, 2, 264 if fused else 396,
                              17 if fused else 20)

    def test_combine_groups_stay_within_the_counters(self):
        """Any grid up to 64 x 64 blocks falls into at most
        ``COMBINE_GROUPS`` combine groups, each of at least one block."""
        for blocks in range(1, 64 * 64 + 1):
            p = rmod.plan(blocks, 32, 8, blocks, backward=True)
            assert p.blocks == blocks
            assert 1 <= -(-blocks // p.blocks_per_group) \
                <= rmod.COMBINE_GROUPS

    @pytest.mark.parametrize("n,vec,per_sm,want", [
        # the bench decode's gate (8, 8192): a vector a thread, 32 blocks
        (8 * 8192, 8, 2, (1, 32)),
        # the tp = 2 shard (4, 4096): 8 blocks
        (4 * 4096, 8, 2, (1, 8)),
        # the prefill block and the train shape: 4 vectors a thread, the
        # grid the SMs times the resident blocks
        (512 * 8192, 8, 2, (4, 264)),
        (512 * 8192, 8, 5, (4, 512)),
        (16384 * 8192, 8, 4, (4, 528)),
        # between: 2 vectors a thread still give every SM a tile
        (100000 * 8, 8, 2, (2, 196)),
        # a ragged count at element loads, and one below a vector
        (3003, 1, 8, (1, 12)),
        (5, 8, 8, (1, 1)),
    ])
    def test_gate(self, n, vec, per_sm, want):
        p = smod.plan(n, vec, 132, resident=lambda unroll: per_sm)
        assert (p.unroll, p.blocks) == want
        tiles = -(-(n // vec) // (smod.THREADS * p.unroll))
        assert 1 <= p.blocks <= max(1, tiles)

    def test_gate_asks_the_resident_count_of_its_unroll(self):
        asked = []
        p = smod.plan(16384 * 8192, 8, 132,
                      resident=lambda unroll: asked.append(unroll) or 3)
        assert asked == [4] and p == smod.Plan(4, 396)

    @pytest.mark.parametrize("dim,width", [(2048, 8), (36, 4), (33, 1),
                                           (6, 1)])
    def test_vector_width_by_width(self, dim, width):
        x = torch.zeros(2, dim, dtype=torch.bfloat16)
        assert rmod.vector_width(dim, x, x.clone()) == width

    def test_misaligned_buffer_takes_element_loads(self):
        flat = torch.zeros(2 * 16 + 1, dtype=torch.bfloat16)
        shifted = flat[1:].view(2, 16)
        assert rmod.vector_width(16, shifted) == 1
        assert smod.vector_width(shifted) == 1
        assert smod.vector_width(torch.zeros(8, 33)) == 8


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


#: bf16 logits against JAX's: chip_smoke's BF16_LOGITS_REL_TOL (the
#: two sides round to bf16 at other points through the layers)
BF16_LOGITS_REL = chip_smoke.BF16_LOGITS_REL_TOL


class TestCachedStep:
    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["bf16_cache", "int8_cache"])
    def test_prefill_and_steps_match_jax_in_bf16(self, quantize_kv):
        """bf16 weights, a prefill of 5 and three steps (at a device
        position) through ``forward_with_cache`` with every residual add
        folded into the next norm, against JAX's ``forward_with_cache``
        from the same weights: the logits within the bf16 tolerance of the
        card's decode contract, max-normalised."""
        jcfg, tcfg = jllama.LlamaConfig(), tllama.LlamaConfig()
        jp = jllama.init_llama_params(one_device_mesh(), jcfg,
                                      param_dtype=jnp.bfloat16)
        tp = params_from_jax(jp, device="cpu")
        assert tp["final_norm"].dtype == torch.bfloat16
        toks = np.random.default_rng(63).integers(
            0, jcfg.vocab, (2, 8)).astype(np.int32)
        jc = jdecode.init_kv_cache(one_device_mesh(), jcfg, 2, 16,
                                   param_dtype=jnp.bfloat16,
                                   quantize_kv=quantize_kv)
        tc = tdecode.init_kv_cache(tcfg, 2, 16, torch.bfloat16,
                                   quantize_kv=quantize_kv, device="cpu")
        for a, b in ((0, 5), (5, 6), (6, 7), (7, 8)):
            want, jc = jdecode.forward_with_cache(
                jp, jnp.asarray(toks[:, a:b]), jc, a, jcfg)
            got, tc = tdecode.forward_with_cache(
                tp, torch.from_numpy(toks[:, a:b]), tc,
                a if a == 0 else torch.tensor(a), tcfg)
            want = to_torch(want)
            assert got.dtype == want.dtype == torch.bfloat16
            assert torch.isfinite(got.float()).all()
            assert chip_smoke.rel_err(got, want) <= BF16_LOGITS_REL

    def test_f32_steps_match_jax(self):
        """f32 weights: each call's logits within the decode tests'
        1e-4."""
        jcfg, tcfg = jllama.LlamaConfig(), tllama.LlamaConfig()
        jp = jllama.init_llama_params(one_device_mesh(), jcfg, seed=3)
        tp = params_from_jax(jp, device="cpu")
        toks = np.random.default_rng(64).integers(
            0, jcfg.vocab, (2, 7)).astype(np.int32)
        jc = jdecode.init_kv_cache(one_device_mesh(), jcfg, 2, 16)
        tc = tdecode.init_kv_cache(tcfg, 2, 16, device="cpu")
        for a, b in ((0, 5), (5, 6), (6, 7)):
            want, jc = jdecode.forward_with_cache(
                jp, jnp.asarray(toks[:, a:b]), jc, a, jcfg)
            got, tc = tdecode.forward_with_cache(
                tp, torch.from_numpy(toks[:, a:b]), tc, a, tcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)


class Spy:
    """Counts a function's calls (and whether each had a delta)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append(args)
        return self.fn(*args, **kwargs)


class TestCallSites:
    def test_cached_step_runs_2l_plus_1_norms_and_l_gates(self, monkeypatch):
        """A ``forward_with_cache`` call runs the norm 2L + 1 times, the
        first (on the embedding) without an add and every other with the
        residual add before it, and the gate L times."""
        cfg = tllama.LlamaConfig(n_layers=3)
        params = tllama.init_llama_params(cfg, device="cpu")
        norm, gate = Spy(tdecode.add_rms_norm), Spy(tdecode.swiglu)
        monkeypatch.setattr(tdecode, "add_rms_norm", norm)
        monkeypatch.setattr(tdecode, "swiglu", gate)
        cache = tdecode.init_kv_cache(cfg, 2, 8, device="cpu")
        tdecode.forward_with_cache(params, torch.zeros(2, 3, dtype=torch.long),
                                   cache, 0, cfg)
        deltas = [args[1] is not None for args in norm.calls]
        assert deltas == [False] + [True] * (2 * cfg.n_layers)
        assert len(gate.calls) == cfg.n_layers

    @pytest.mark.parametrize("remat", [False, True])
    def test_batch_forward_and_backward(self, monkeypatch, remat):
        """The batch forward runs L + 1 norms without an add (each layer's
        attention norm and the final norm), L with the attention's add
        (the MLP norms) and L gates, each with its backward once in a
        gradient; under remat the layers' forwards run twice."""
        cfg = tllama.LlamaConfig(n_layers=3, remat=remat)
        params = tllama.init_llama_params(cfg, device="cpu")
        spies = {name: Spy(getattr(tllama, name))
                 for name in ("add_rms_norm", "swiglu")}
        for name, spy in spies.items():
            monkeypatch.setattr(tllama, name, spy)
        bwd = {name: Spy(getattr(mod, name)) for mod, name in
               ((rmod, "rms_norm_bwd"), (smod, "swiglu_bwd"))}
        monkeypatch.setattr(rmod, "rms_norm_bwd", bwd["rms_norm_bwd"])
        monkeypatch.setattr(smod, "swiglu_bwd", bwd["swiglu_bwd"])
        toks = tllama.make_token_batch(0, cfg, device="cpu")
        tllama.value_and_grad(tllama.next_token_loss, params, toks, cfg)
        layers = cfg.n_layers * (2 if remat else 1)
        adds = [args[1] is not None for args in spies["add_rms_norm"].calls]
        assert adds.count(False) == layers + 1
        assert adds.count(True) == layers
        assert len(spies["swiglu"].calls) == layers
        assert len(bwd["rms_norm_bwd"].calls) == 2 * cfg.n_layers + 1
        assert len(bwd["swiglu_bwd"].calls) == cfg.n_layers

    def test_batch_forward_equals_the_plain_expressions(self, monkeypatch):
        """The batch forward's logits are those of the unfused plain
        block (``h + attn``, ``_rms_norm``, ``F.silu(g) * u``), bit for
        bit on the CPU."""
        cfg = tllama.LlamaConfig(n_layers=2)
        params = tllama.init_llama_params(cfg, param_dtype=torch.bfloat16,
                                          device="cpu")
        toks = tllama.make_token_batch(1, cfg, device="cpu")
        got = tllama.forward(params, toks, cfg)
        monkeypatch.setattr(tllama, "add_rms_norm", add_rms_norm_reference)
        monkeypatch.setattr(tllama, "swiglu", swiglu_reference)
        assert torch.equal(got, tllama.forward(params, toks, cfg))


class TestChipSmokeCounts:
    def test_block_launches_count_the_batch_forward_and_backward(
            self, monkeypatch):
        """``chip_smoke.block_launches`` (the counts phases 7 and 9 hold
        the card to) against the calls a gradient of a llama-277M-deep
        model makes, with and without remat."""
        for remat in (False, True):
            cfg = tllama.LlamaConfig(n_layers=chip_smoke.CONFIG_277M.n_layers,
                                     remat=remat)
            params = tllama.init_llama_params(cfg, device="cpu")
            sites = ((tllama, "add_rms_norm"), (tllama, "swiglu"),
                     (rmod, "rms_norm_bwd"), (smod, "swiglu_bwd"))
            spies = {name: Spy(getattr(mod, name)) for mod, name in sites}
            for mod, name in sites:
                monkeypatch.setattr(mod, name, spies[name])
            tllama.value_and_grad(tllama.next_token_loss, params,
                                  tllama.make_token_batch(0, cfg,
                                                          device="cpu"), cfg)
            got = {"rms_norm": len(spies["add_rms_norm"].calls),
                   "rms_norm_bwd": len(spies["rms_norm_bwd"].calls),
                   "swiglu": len(spies["swiglu"].calls),
                   "swiglu_bwd": len(spies["swiglu_bwd"].calls)}
            assert got == chip_smoke.block_launches(1, 1, remat=remat)
            monkeypatch.undo()

    def test_cached_step_counts(self):
        n = chip_smoke.CONFIG_277M.n_layers
        assert chip_smoke.block_launches(3) == {
            "rms_norm": 3 * (2 * n + 1), "rms_norm_bwd": 0,
            "swiglu": 3 * n, "swiglu_bwd": 0}

    @pytest.mark.parametrize("key,want", [
        ("void (anonymous namespace)::rms_norm_fwd_kernel<8>(FwdParams)",
         "rms_norm"),
        ("_ZN12_GLOBAL__N_119rms_norm_bwd_kernelILi4EEEvNS_9BwdParamsE",
         "rms_norm"),
        ("_ZN12_GLOBAL__N_119rms_norm_bwd_kernelILi8ELi2ELb1ELb1EEEvNS_9Bwd"
         "ParamsE", "rms_norm"),
        ("void (anonymous namespace)::rms_norm_bwd_kernel<8, 2, true, "
         "false>(BwdParams)", "rms_norm"),
        ("void (anonymous namespace)::swiglu_fwd_kernel<8>(void const*)",
         "swiglu"),
        ("void (anonymous namespace)::rms_norm_fwd_kernel<8, 1, true>("
         "FwdParams)", "rms_norm"),
        ("void (anonymous namespace)::swiglu_fwd_kernel<__nv_bfloat16, 8, "
         "4>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
         "long long)", "swiglu"),
        ("rope_kv_append_kernel<2>", "rope_kv_append"),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::silu_kernel>", None),
    ])
    def test_profile_names_the_new_kernels(self, key, want):
        import decode_step_profile

        assert decode_step_profile.port_kernel(key) == want


#: ptxas -v's lines for one kernel instance, as the build phase reads them
PTXAS_BLOCK = """ '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    {stack} bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, 64 bytes smem
"""


class TestBuildReport:
    def test_build_phase_reads_the_forward_instances(self, monkeypatch,
                                                     capsys):
        """The build phase names each instance by its template arguments
        (the norm's vec, loads, packing and, backward, ds; the gate's
        dtype, vec and unroll), and phase 3f finds its registers, shared
        memory and spills by them."""
        prefix = "_ZN36_INTERNAL_3f2c1e0a_11_rms_norm_cu_7e7f3a2a"
        norm = "".join("Compiling entry function" + PTXAS_BLOCK.format(
            name=f"{prefix}19rms_norm_fwd_kernelILi{vec}ELi{loads}ELb"
                 f"{int(packed)}EEEvNS_9FwdParamsE", stack=0, spill=0,
            regs=regs)
            for vec, loads, packed, regs in ((8, 1, True, 40),
                                             (8, 1, False, 48),
                                             (8, 0, False, 38),
                                             (1, 4, False, 64)))
        norm += "".join("Compiling entry function" + PTXAS_BLOCK.format(
            name=f"{prefix}19rms_norm_bwd_kernelILi{vec}ELi{loads}ELb"
                 f"{int(packed)}ELb{int(ds)}EEEvNS_9BwdParamsE", stack=0,
            spill=spill, regs=regs)
            for vec, loads, packed, ds, spill, regs in (
                (8, 2, True, True, 0, 96), (8, 2, True, False, 0, 80),
                (1, 0, False, True, 8, 40)))
        gate = "".join("Compiling entry function" + PTXAS_BLOCK.format(
            name=f"{prefix}17swiglu_fwd_kernelI{t}Li8ELi{unroll}EEEvPKT_"
                 "S3_PS1_x", stack=0, spill=4, regs=regs)
            for t, unroll, regs in (("13__nv_bfloat16", 4, 56),
                                    ("f", 1, 32)))

        class Built:
            def __init__(self, report):
                self.ptxas_report, self.build_seconds = report, 1.0

        monkeypatch.setattr(chip_smoke, "SOURCES", ["rms_norm.cu",
                                                    "swiglu.cu"])
        monkeypatch.setattr(chip_smoke._build, "build_all",
                            lambda sources: [Built(norm), Built(gate)])
        monkeypatch.setattr(chip_smoke, "BUILT_INSTANCES", {})
        chip_smoke.phase_build()
        out = capsys.readouterr().out
        assert '"design": "8 elements a load, 1 vectors a thread held in ' \
            'registers as packed bfloat16"' in out
        assert '"design": "8 elements a load, two passes' in out
        assert '"design": "8 elements a load, 2 vectors a thread held in ' \
            'registers as packed bfloat16, with ds"' in out
        assert chip_smoke.instance_ptxas(
            "rms_norm.cu", "rms_norm_bwd_kernel",
            keys=("registers", "static_smem_bytes", "spill_store_bytes"),
            vec=8, loads=2, packed=True, ds=True) == {
                "registers": 96, "static_smem_bytes": 64,
                "spill_store_bytes": 0}
        assert chip_smoke.instance_ptxas(
            "rms_norm.cu", "rms_norm_bwd_kernel", vec=8, loads=2,
            packed=True, ds=False)["registers"] == 80
        assert chip_smoke.instance_ptxas(
            "rms_norm.cu", "rms_norm_bwd_kernel", vec=1, loads=0,
            packed=False, ds=True)["spill_store_bytes"] == 8
        assert chip_smoke.instance_ptxas(
            "rms_norm.cu", "rms_norm_fwd_kernel", vec=8, loads=1,
            packed=True) == {"registers": 40, "spill_store_bytes": 0,
                             "stack_bytes": 0}
        assert chip_smoke.instance_ptxas(
            "rms_norm.cu", "rms_norm_fwd_kernel", vec=8, loads=1,
            packed=False)["registers"] == 48
        assert chip_smoke.instance_ptxas(
            "rms_norm.cu", "rms_norm_fwd_kernel", vec=1, loads=4,
            packed=False)["registers"] == 64
        assert chip_smoke.instance_ptxas(
            "swiglu.cu", "swiglu_fwd_kernel", dtype="bfloat16", vec=8,
            unroll=4) == {"registers": 56, "spill_store_bytes": 4,
                          "stack_bytes": 0}
        assert chip_smoke.instance_ptxas(
            "swiglu.cu", "swiglu_fwd_kernel", dtype="float32", vec=8,
            unroll=1)["registers"] == 32
        # an instance the report lacks (a reused build) says so
        assert "not reported" in chip_smoke.instance_ptxas(
            "swiglu.cu", "swiglu_fwd_kernel", dtype="float32", vec=4,
            unroll=2)


class TestVariantsScript:
    """``norm_gate_variants.py``'s source variants are string edits of the
    kernels' sources: each must still find its text, or the script stops
    on the card."""

    @pytest.mark.parametrize("name", sorted(ngv.VARIANTS))
    def test_every_edit_still_applies(self, name):
        for file, edits in ngv.VARIANTS[name].items():
            text = (ngv._build.CSRC_DIR / file).read_text()
            for old, new in edits:
                assert text.count(old) == 1, (name, file, old)
                assert old != new

    def test_layouts_name_known_variants(self):
        names = [layout[0] for layout in ngv.NORM_LAYOUTS]
        assert len(set(names)) == len(names)
        assert set(ngv.AFTER_PRODUCT_LAYOUTS) <= set(names)
        for _, variant, target, per_block, grid in ngv.NORM_LAYOUTS:
            assert variant is None or variant in ngv.VARIANTS
            assert grid in (None, "full", "strided")

    def test_exits_without_cuda(self, capsys):
        assert ngv.main([]) == 1
        assert "CUDA is not available" in capsys.readouterr().err

"""The cached step's rotation and cache write on the CPU:
``kernels/kv_append.py::rope_kv_append`` (the plain version here, the
kernel in ``tests/test_torch_gpu.py``) against the JAX package's
``forward_with_cache`` write: ``_rope`` of q and k at the decode positions,
then ``_quantize_kv_block`` or the cast, then ``dynamic_update_slice``.
Also the order of rounding and quantizing, the wrapper's checks, the
vector width it gives the kernel, and the cached step as a whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.convert import params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.kernels import WRAPPERS
from tpu_operator_libs_torch.kernels import kv_append as kmod
from tpu_operator_libs_torch.kernels.kv_append import (
    _quantize_kv_block,
    _rope,
    kv_append,
    rope_freqs,
    rope_kv_append,
    rope_kv_append_reference,
    vector_width,
)

THETA = 10000.0
#: f32 rotations against JAX's: test_torch_llama.py's test_rope_matches_jax
F32_TOL = 1e-5
#: int8 scales against JAX's, relative
SCALE_RTOL = 1e-5
BATCH, HEADS, KV_HEADS, SEQ = 2, 8, 2, 12


def to_torch(x):
    return params_from_jax({"x": x}, device="cpu")["x"]


def assert_close_as(got: torch.Tensor, want: torch.Tensor, what: str):
    """f32 within F32_TOL, bf16 within one ulp, int8 codes within 1."""
    assert got.dtype == want.dtype, what
    if got.dtype == torch.bfloat16:
        assert chip_smoke.max_ulp(got, want) <= 1, what
    elif got.dtype == torch.int8:
        assert (got.int() - want.int()).abs().max().item() <= 1, what
    else:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   msg=what)


def jax_write(q, k, v, start, cache_dtype, head_dim):
    """JAX's forward_with_cache write at ``start``: (rotated q, the cache
    leaves after the update of a zero cache)."""
    t_new = q.shape[1]
    positions = start + jnp.arange(t_new)
    q_rot = jllama._rope(jnp.asarray(q), THETA, positions)
    k_rot = jllama._rope(jnp.asarray(k), THETA, positions)
    shape = (BATCH, SEQ, KV_HEADS, head_dim)

    def update(buf, block):
        return jax.lax.dynamic_update_slice(
            buf, block, (0, start) + (0,) * (buf.ndim - 2))

    if cache_dtype == "int8":
        want = {}
        for name, x in (("k", k_rot), ("v", jnp.asarray(v))):
            codes, scales = jdecode._quantize_kv_block(x)
            want[name] = update(jnp.zeros(shape, jnp.int8), codes)
            want[f"{name}_s"] = update(jnp.zeros(shape[:3]), scales)
    else:
        dt = jnp.dtype(cache_dtype)
        want = {name: update(jnp.zeros(shape, dt), x.astype(dt))
                for name, x in (("k", k_rot), ("v", jnp.asarray(v)))}
    return q_rot, want


def activations(seed, t_new, head_dim, x_dtype):
    """Seeded q, k, v from numpy, cast as JAX casts (bfloat16 round to
    nearest even), as numpy arrays JAX and the port both take."""
    rng = np.random.default_rng(seed)
    out = []
    for heads in (HEADS, KV_HEADS, KV_HEADS):
        x = (rng.standard_normal((BATCH, t_new, heads, head_dim)) * 2) \
            .astype(np.float32)
        out.append(np.asarray(jnp.asarray(x).astype(x_dtype)))
    return out


class TestAgainstJax:
    @pytest.mark.parametrize("tensor_pos", [False, True],
                             ids=["int_pos", "tensor_pos"])
    @pytest.mark.parametrize("t_new", [1, 5])
    @pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32", "int8"])
    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("head_dim", [8, 16, 64])
    def test_write_matches_jax(self, head_dim, x_dtype, cache_dtype, t_new,
                               tensor_pos):
        """GQA (8 query heads over 2 KV heads): the rotated q and every
        cache leaf against JAX's, f32 within 1e-5, bf16 within one ulp,
        int8 codes within 1 and scales within 1e-5 relative; the rows
        outside [start, start + T) zero in both."""
        q, k, v = activations(40 + head_dim + t_new, t_new, head_dim,
                              x_dtype)
        start = 6
        q_want, want = jax_write(q, k, v, start, cache_dtype, head_dim)
        entry = {name: torch.zeros(w.shape,
                                   dtype=getattr(torch, w.dtype.name))
                 for name, w in want.items()}
        pos = torch.tensor(start) if tensor_pos else start
        before = rope_kv_append.launches
        q_got = rope_kv_append(entry, to_torch(q), to_torch(k), to_torch(v),
                               pos, THETA)
        assert rope_kv_append.launches == before  # the plain version
        assert_close_as(q_got, to_torch(q_want), "q")
        for name, w in want.items():
            w = to_torch(w)
            if name.endswith("_s"):
                torch.testing.assert_close(entry[name], w, rtol=SCALE_RTOL,
                                           atol=0.0, msg=name)
            else:
                assert_close_as(entry[name], w, name)
            assert not entry[name][:, :start].any()
            assert not entry[name][:, start + t_new:].any()

    @pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32", "int8"])
    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    def test_write_of_jax_rotated_keys_bit_equal(self, x_dtype, cache_dtype):
        """Given the keys JAX rotated, the port's rotation-free write
        (the same kernel body without the rotation) gives JAX's cache bit
        for bit: what can differ is the rotation alone."""
        q, k, v = activations(50, 5, 16, x_dtype)
        start = 3
        _, want = jax_write(q, k, v, start, cache_dtype, 16)
        k_rot = jllama._rope(jnp.asarray(k), THETA, start + jnp.arange(5))
        entry = {name: torch.zeros(w.shape,
                                   dtype=getattr(torch, w.dtype.name))
                 for name, w in want.items()}
        kv_append(entry, to_torch(k_rot), to_torch(v), start)
        for name, w in want.items():
            assert torch.equal(entry[name], to_torch(w)), name


class TestOrder:
    def test_rounded_rotation_is_quantized(self):
        """The plain version quantizes the rotated k after rounding it to
        k's dtype, as JAX does (``_rope`` casts back before
        ``_quantize_kv_block``): at this input, quantizing the float32
        rotation instead gives other codes and scales, and the plain
        version gives the rounded rotation's."""
        q, k, v = (to_torch(x) for x in activations(60, 1, 64, "bfloat16"))
        positions = torch.arange(1) + 9
        rounded = _quantize_kv_block(_rope(k, THETA, positions))
        unrounded = _quantize_kv_block(_rope(k.float(), THETA, positions))
        assert not torch.equal(rounded[0], unrounded[0])
        assert not torch.equal(rounded[1], unrounded[1])
        entry = tdecode.init_kv_cache(tllama.LlamaConfig(
            n_heads=HEADS, n_kv_heads=KV_HEADS, d_model=HEADS * 64), BATCH,
            SEQ, quantize_kv=True, device="cpu")[0]
        rope_kv_append(entry, q, k, v, 9, THETA)
        assert torch.equal(entry["k"][:, 9], rounded[0][:, 0])
        assert torch.equal(entry["k_s"][:, 9], rounded[1][:, 0])

    def test_reference_is_rope_then_write(self):
        """The plain version is ``_rope`` of q and k at start_pos +
        arange(T), then the rotation-free write of the rotated k and v."""
        q, k, v = (to_torch(x) for x in activations(61, 3, 16, "bfloat16"))
        entry = {"k": torch.zeros(BATCH, SEQ, KV_HEADS, 16,
                                  dtype=torch.bfloat16)}
        entry["v"] = torch.zeros_like(entry["k"])
        want = {n: t.clone() for n, t in entry.items()}
        positions = torch.arange(3) + 4
        q_rot = rope_kv_append_reference(entry, q, k, v, torch.tensor(4),
                                         THETA)
        kv_append(want, _rope(k, THETA, positions), v, 4)
        assert torch.equal(q_rot, _rope(q, THETA, positions))
        for name in entry:
            assert torch.equal(entry[name], want[name])

    def test_one_rope_for_the_batch_forward_and_the_cache_write(self):
        """The batch forward's ``_rope`` is the cache write's, and the
        kernel's frequencies come from its expression."""
        assert tllama._rope is _rope
        half = 32
        want = THETA ** (-torch.arange(0, half, dtype=torch.float32) / half)
        assert torch.equal(rope_freqs(THETA, 64, "cpu"), want)


def small_case(t_new=2, head_dim=8, cache=torch.int8):
    q = torch.randn(BATCH, t_new, HEADS, head_dim)
    k, v = (torch.randn(BATCH, t_new, KV_HEADS, head_dim) for _ in range(2))
    shape = (BATCH, SEQ, KV_HEADS, head_dim)
    if cache == torch.int8:
        entry = {"k": torch.zeros(shape, dtype=torch.int8),
                 "k_s": torch.zeros(shape[:3]),
                 "v": torch.zeros(shape, dtype=torch.int8),
                 "v_s": torch.zeros(shape[:3])}
    else:
        entry = {"k": torch.zeros(shape, dtype=cache),
                 "v": torch.zeros(shape, dtype=cache)}
    return entry, q, k, v


class TestWrapper:
    def test_listed_with_its_launch_count(self):
        assert WRAPPERS["rope_kv_append"] is rope_kv_append
        assert WRAPPERS["kv_append"] is kv_append
        assert isinstance(rope_kv_append.launches, int)

    @pytest.mark.parametrize("bad", ["q_int", "q_f16", "k_f16"])
    def test_bad_dtypes_raise(self, bad):
        entry, q, k, v = small_case()
        if bad == "q_int":
            q = q.to(torch.int32)
        elif bad == "q_f16":
            q = q.half()
        else:
            k = k.half()
        with pytest.raises(ValueError, match="dtype"):
            rope_kv_append(entry, q, k, v, 3, THETA)

    @pytest.mark.parametrize("bad", ["heads_not_multiple", "q_t", "q_dim",
                                     "q_3d", "q_strided", "q_batch"])
    def test_bad_shapes_raise(self, bad):
        entry, q, k, v = small_case()
        q = {"heads_not_multiple": q[:, :, :3].contiguous(),
             "q_t": q[:, :1].contiguous(),
             "q_dim": torch.randn(BATCH, 2, HEADS, 4),
             "q_3d": q[0],
             "q_strided": q.transpose(1, 2),
             "q_batch": q[:1].contiguous()}[bad]
        with pytest.raises(ValueError, match="q"):
            rope_kv_append(entry, q, k, v, 3, THETA)

    def test_odd_head_dims_raise(self):
        entry, q, k, v = small_case(head_dim=7, cache=torch.float32)
        with pytest.raises(ValueError, match="even"):
            rope_kv_append(entry, q, k, v, 3, THETA)

    @pytest.mark.parametrize("pos", [-1, True, 11, 2.0])
    def test_bad_start_pos_raise(self, pos):
        entry, q, k, v = small_case()
        with pytest.raises(ValueError, match="start_pos|positions"):
            rope_kv_append(entry, q, k, v, pos, THETA)

    @pytest.mark.parametrize("pos", [torch.tensor([3]),
                                     torch.tensor(3, dtype=torch.int32)])
    def test_bad_start_pos_tensors_raise(self, pos):
        entry, q, k, v = small_case()
        with pytest.raises(ValueError, match="start_pos"):
            rope_kv_append(entry, q, k, v, pos, THETA)

    @pytest.mark.parametrize("theta", [0.0, -1.0, True, "10000"])
    def test_bad_theta_raise(self, theta):
        entry, q, k, v = small_case()
        with pytest.raises(ValueError, match="theta"):
            rope_kv_append(entry, q, k, v, 3, theta)

    def test_another_device_raises_rather_than_running_the_plain_version(
            self):
        """Tensors on a device that is neither the CPU nor CUDA (``meta``)
        pass the checks and then raise, counting no launch."""
        entry, q, k, v = small_case()
        entry = {n: t.to("meta") for n, t in entry.items()}
        q, k, v = (x.to("meta") for x in (q, k, v))
        before = rope_kv_append.launches
        with pytest.raises(ValueError, match="unsupported device"):
            rope_kv_append(entry, q, k, v, torch.tensor(3, device="meta"),
                           THETA)
        assert rope_kv_append.launches == before

    def test_mixed_devices_raise(self):
        entry, q, k, v = small_case()
        with pytest.raises(ValueError, match="meta"):
            rope_kv_append(entry, q.to("meta"), k, v, 3, THETA)

    def test_returns_a_new_q_and_writes_the_cache_in_place(self):
        entry, q, k, v = small_case(cache=torch.float32)
        k_cache = entry["k"]
        q_copy = q.clone()
        q_rot = rope_kv_append(entry, q, k, v, 3, THETA)
        assert q_rot is not q and torch.equal(q, q_copy)
        assert entry["k"] is k_cache and entry["k"][:, 3:5].any()


class TestVectorWidth:
    @pytest.mark.parametrize("dim,width", [(128, 2), (64, 2), (16, 2),
                                           (8, 2), (10, 1), (6, 1)])
    def test_pairs_a_lane_by_head_dim(self, dim, width):
        x = torch.zeros(2, 1, 4, dim)
        assert vector_width(x, x.clone()) == width

    def test_misaligned_buffer_takes_element_loads(self):
        flat = torch.zeros(2 * 4 * 16 + 1)
        shifted = flat[1:].view(2, 1, 4, 16)  # 4 bytes past an 8-byte edge
        assert shifted.data_ptr() % 8 == 4
        assert vector_width(torch.zeros(2, 1, 4, 16), shifted) == 1


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


class TestCachedStepAsAWhole:
    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["f32_cache", "int8_cache"])
    def test_prefill_and_steps_match_jax(self, quantize_kv):
        """The small GQA config through a prefill of 5 and two steps (the
        steps at a device position), JAX and the port from the same
        weights: each call's logits within the decode tests' 1e-4, and
        the caches within the write's limits (int8 codes within 1)."""
        jcfg, tcfg = jllama.LlamaConfig(), tllama.LlamaConfig()
        jp = jllama.init_llama_params(one_device_mesh(), jcfg)
        tp = params_from_jax(jp, device="cpu")
        rng = np.random.default_rng(62)
        toks = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
        jc = jdecode.init_kv_cache(one_device_mesh(), jcfg, 2, 16,
                                   quantize_kv=quantize_kv)
        tc = tdecode.init_kv_cache(tcfg, 2, 16, quantize_kv=quantize_kv,
                                   device="cpu")
        for a, b in ((0, 5), (5, 6), (6, 7)):
            want, jc = jdecode.forward_with_cache(
                jp, jnp.asarray(toks[:, a:b]), jc, a, jcfg)
            got, tc = tdecode.forward_with_cache(
                tp, torch.from_numpy(toks[:, a:b]), tc,
                a if a == 0 else torch.tensor(a), tcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
        for t_entry, j_entry in zip(tc, jc):
            for name, w in j_entry.items():
                w = to_torch(w)
                if name.endswith("_s"):
                    torch.testing.assert_close(t_entry[name], w, rtol=1e-4,
                                               atol=0.0)
                else:
                    assert_close_as(t_entry[name], w, name)
        assert kmod._freqs == {}  # the CPU path made no kernel buffers

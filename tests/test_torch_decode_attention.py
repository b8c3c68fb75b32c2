"""The cached step's two kernels on the CPU: the cache write
(``kernels/kv_append.py``) and the cached attention
(``kernels/decode_attention.py``) against the JAX package, their wrappers
(the plain version on the CPU, the checks), the launch plan, and the
attention kernel's tiled online softmax emulated in float32 against the
plain version. The kernels themselves run in ``tests/test_torch_gpu.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch import parallel
from tpu_operator_libs_torch.convert import kv_cache_from_jax, params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.kernels import decode_attention as dmod
from tpu_operator_libs_torch.kernels import kv_append as kmod
from tpu_operator_libs_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_reference,
    plan,
)
from tpu_operator_libs_torch.kernels.kv_append import (
    kv_append,
    kv_append_reference,
)

#: f32 on both sides; the tolerance of tests/test_llama_decode.py:69.
TOL = 1e-4
#: the kernel's float32 sums against the plain version's: the same terms
#: in another order (tiles of keys, a rescale a tile), as the f32 flash
#: kernel holds (chip_smoke.KERNEL_TOL)
F32_RTOL, F32_ATOL = 1e-5, 2e-5

#: the small test config, with GQA (8 heads over 4 KV heads of 8)
JCFG = jllama.LlamaConfig()
TCFG = tllama.LlamaConfig()
#: prefill of 8 tokens, then 3 steps
CALLS = [(0, 8), (8, 9), (9, 10), (10, 11)]
MAX_SEQ = 16


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_llama_params(one_device_mesh(), JCFG)
    return jp, params_from_jax(jp, device="cpu")


def tokens(seed, batch, seq):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab, (batch, seq)).astype(np.int32)


def bits(x) -> np.ndarray:
    """A port or JAX array as numpy, bfloat16 as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def assert_cache_equal(port, jax_cache):
    assert len(port) == len(jax_cache)
    for layer, (t_entry, j_entry) in enumerate(zip(port, jax_cache)):
        assert set(t_entry) == set(j_entry)
        for name in j_entry:
            np.testing.assert_array_equal(bits(t_entry[name]),
                                          bits(j_entry[name]),
                                          err_msg=f"layer {layer} {name}")


class TestCacheWritesEqualJax:
    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["f32_cache", "int8_cache"])
    def test_writes_bit_equal_to_jax_new_cache(self, weights, monkeypatch,
                                               quantize_kv):
        """JAX's forward_with_cache through a prefill of 8 and 3 steps;
        the port's kv_append fed the keys and values that JAX wrote in each
        call (for an int8 cache the activations JAX quantized, for a float
        one the block it wrote) at the same positions: every cache leaf
        equals JAX's new_cache bit for bit, the rows never written zero in
        both."""
        jp, _ = weights
        quantized = []

        def recorder(x):
            quantized.append(np.asarray(x))
            return real(x)

        real = jdecode._quantize_kv_block
        monkeypatch.setattr(jdecode, "_quantize_kv_block", recorder)
        toks = tokens(30, 2, CALLS[-1][1])
        jc = jdecode.init_kv_cache(one_device_mesh(), JCFG, 2, MAX_SEQ,
                                   quantize_kv=quantize_kv)
        written = []
        for a, b in CALLS:
            _, jc = jdecode.forward_with_cache(jp, jnp.asarray(toks[:, a:b]),
                                               jc, a, JCFG)
            if quantize_kv:
                blocks = quantized[-2 * JCFG.n_layers:]
                written.append([(blocks[2 * i], blocks[2 * i + 1])
                                for i in range(JCFG.n_layers)])
            else:
                written.append([(np.asarray(e["k"])[:, a:b],
                                 np.asarray(e["v"])[:, a:b]) for e in jc])
        assert len(quantized) == (2 * JCFG.n_layers * len(CALLS)
                                  if quantize_kv else 0)
        tc = tdecode.init_kv_cache(TCFG, 2, MAX_SEQ, quantize_kv=quantize_kv,
                                   device="cpu")
        for (a, _), blocks in zip(CALLS, written):
            # the prefill at an int, the steps at a 0-d tensor
            pos = a if a == 0 else torch.tensor(a)
            for entry, (k, v) in zip(tc, blocks):
                assert kv_append(entry, torch.from_numpy(np.array(k)),
                                 torch.from_numpy(np.array(v)), pos) is entry
        assert_cache_equal(tc, jc)
        assert not any(e["k"][:, CALLS[-1][1]:].any() for e in tc)

    @pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    def test_write_of_one_block_bit_equal_to_jax(self, cache_dtype, x_dtype):
        """One block of seeded activations through the reference's write
        (``_quantize_kv_block`` or the cast, then dynamic_update_slice) and
        through kv_append: the casts round to nearest even, and the codes
        break ties to even (halves planted)."""
        rng = np.random.default_rng(31)
        shape = (2, 3, 4, 16)
        k = (rng.standard_normal(shape) * 2).astype(np.float32)
        v = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        k[0, 0, 0, :4] = [63.5, -63.5, 127.0, 0.5]  # ties at the codes
        v[1, 2] = 0.0  # all-zero rows take the 1e-8 floor
        if x_dtype == "bfloat16":
            k, v = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
                    for x in (k, v))
        start = 5

        def update(buf, block):
            return jax.lax.dynamic_update_slice(
                buf, block, (0, start) + (0,) * (buf.ndim - 2))

        if cache_dtype == "int8":
            want = {}
            for name, x in (("k", k), ("v", v)):
                codes, scales = jdecode._quantize_kv_block(jnp.asarray(x))
                want[name] = update(jnp.zeros((2, 12, 4, 16), jnp.int8),
                                    codes)
                want[f"{name}_s"] = update(jnp.zeros((2, 12, 4)), scales)
        else:
            dt = jnp.dtype(cache_dtype)
            want = {name: update(jnp.zeros((2, 12, 4, 16), dt),
                                 jnp.asarray(x).astype(dt))
                    for name, x in (("k", k), ("v", v))}
        entry = {name: torch.zeros(w.shape, dtype=getattr(torch, w.dtype.name))
                 for name, w in want.items()}

        def to_torch(x):
            return params_from_jax({"x": x}, device="cpu")["x"]

        kv_append(entry, to_torch(k), to_torch(v), start)
        assert_cache_equal([entry], [want])


class TestStepOnAJaxCache:
    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["f32_cache", "int8_cache"])
    def test_one_port_step_matches_one_jax_step(self, weights, quantize_kv):
        """A cache that JAX prefilled, carried across by
        kv_cache_from_jax: one port step at the next position (a device
        position, as the captured step has it) gives JAX's step's logits
        within the decode tests' tolerance, and its cache write lands at
        that position and nowhere else."""
        jp, tp = weights
        toks = tokens(32, 2, 9)
        jc = jdecode.init_kv_cache(one_device_mesh(), JCFG, 2, MAX_SEQ,
                                   quantize_kv=quantize_kv)
        _, jc = jdecode.forward_with_cache(jp, jnp.asarray(toks[:, :8]), jc,
                                           0, JCFG)
        tc = kv_cache_from_jax(jc, device="cpu")
        assert_cache_equal(tc, jc)
        before = [{n: t.clone() for n, t in e.items()} for e in tc]
        want, _ = jdecode.forward_with_cache(jp, jnp.asarray(toks[:, 8:]),
                                             jc, 8, JCFG)
        got, _ = tdecode.forward_with_cache(
            tp, torch.from_numpy(toks[:, 8:]), tc, torch.tensor(8), TCFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        for entry, old in zip(tc, before):
            for name, t in entry.items():
                assert torch.equal(t[:, :8], old[name][:, :8])
                assert torch.equal(t[:, 9:], old[name][:, 9:])
                assert t[:, 8].any()

    def test_cache_from_jax_takes_the_rank_block(self):
        """With a mesh, a rank's dp block of the rows and tp block of the
        KV heads, of the codes and the scales alike."""
        rng = np.random.default_rng(33)
        cache = [{"k": rng.integers(-127, 128, (4, 6, 4, 8)).astype(np.int8),
                  "k_s": rng.random((4, 6, 4)).astype(np.float32)}]
        mesh = parallel.Mesh(dp=2, tp=2, dp_rank=1, tp_rank=0,
                             dp_group=None, tp_group=None,
                             device=torch.device("cpu"))
        got = kv_cache_from_jax(cache, mesh=mesh)[0]
        np.testing.assert_array_equal(got["k"].numpy(),
                                      cache[0]["k"][2:, :, :2])
        np.testing.assert_array_equal(got["k_s"].numpy(),
                                      cache[0]["k_s"][2:, :, :2])
        assert got["k"].is_contiguous()
        with pytest.raises(ValueError, match="split"):
            kv_cache_from_jax([{"k": np.zeros((3, 2, 4, 8))}], mesh=mesh)


def random_entry(gen, batch, seq, kv_heads, dim, cache):
    """One layer's cache, filled: float (seeded normal values) or int8
    codes with scales as the quantizer would give them."""
    x = torch.randn((batch, seq, kv_heads, dim), generator=gen)
    y = torch.randn((batch, seq, kv_heads, dim), generator=gen)
    if cache == "int8":
        (kq, ks), (vq, vs) = (kmod._quantize_kv_block(t) for t in (x, y))
        return {"k": kq, "k_s": ks, "v": vq, "v_s": vs}
    dtype = getattr(torch, cache)
    return {"k": x.to(dtype), "v": y.to(dtype)}


def upcast(entry):
    """The plain version's float32 oracle inputs: a float cache in
    float32, an int8 one as it is (its scales are float32)."""
    return {n: t if t.dtype == torch.int8 else t.float()
            for n, t in entry.items()}


def emulate_kernel(q, entry, start_pos):
    """The kernel's schedule (``csrc/decode_attention.cu``) in float32:
    per (batch row, kv head, tile of MAX_ROWS query rows, row r being the
    (t, g) pair divmod(r, group)), the keys in ``plan``'s tiles, each with
    its scores (times the K scale), the visible keys s <= start_pos + t,
    the running max and sum rescaled once a tile, the weights times the V
    scale before the values, and one division at the end."""
    batch, t_new, heads, dim = q.shape
    seq, kv_heads = entry["k"].shape[1:3]
    group = heads // kv_heads
    p = plan(batch, t_new, heads, kv_heads, dim, entry["k"].dtype)
    k, v = entry["k"].float(), entry["v"].float()
    quant = "k_s" in entry
    out = torch.empty(q.shape)
    for b in range(batch):
        for kvh in range(kv_heads):
            for row_tile in range(p.grid[0]):
                rows = torch.arange(row_tile * dmod.MAX_ROWS,
                                    min((row_tile + 1) * dmod.MAX_ROWS,
                                        t_new * group))
                ts, hs = rows // group, kvh * group + rows % group
                qr = q[b, ts, hs].float()
                m = torch.full((len(rows),), -math.inf)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), dim)
                for s0 in range(0, seq, p.key_tile):
                    keys = torch.arange(s0, min(s0 + p.key_tile, seq))
                    sc = qr @ k[b, keys, kvh].T * dim ** -0.5
                    if quant:
                        sc = sc * entry["k_s"][b, keys, kvh]
                    seen = keys[None, :] <= (start_pos + ts)[:, None]
                    m_new = torch.maximum(m, torch.where(
                        seen, sc, -math.inf).amax(dim=1))
                    w = torch.where(seen, torch.exp(sc - m_new[:, None]), 0.0)
                    corr = torch.exp(m - m_new)
                    l = l * corr + w.sum(dim=1)
                    if quant:
                        w = w * entry["v_s"][b, keys, kvh]
                    acc = acc * corr[:, None] + w @ v[b, keys, kvh]
                    m = m_new
                out[b, ts, hs] = acc / l[:, None]
    return out


#: (B, T, n_heads, n_kv_heads, S, head_dim, start_pos) of the emulation:
#: decode, GQA, a prefill block of 3 row tiles (40 rows of 2 heads a kv
#: head), a start mid-sequence, a ragged last key tile, a long f32 row
#: (32-key tiles)
EMULATED = [
    (2, 1, 4, 4, 70, 16, 69),
    (2, 1, 8, 2, 70, 16, 41),
    (1, 20, 4, 2, 100, 8, 0),
    (1, 5, 4, 4, 130, 16, 60),
    (1, 2, 2, 1, 67, 256, 30),
]


class TestKernelSchedule:
    @pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("shape", EMULATED,
                             ids=["decode", "gqa", "prefill_row_tiles",
                                  "mid_sequence", "long_rows"])
    def test_emulated_schedule_matches_plain_version(self, shape, cache):
        batch, t_new, heads, kv_heads, seq, dim, start = shape
        gen = torch.Generator().manual_seed(34)
        entry = random_entry(gen, batch, seq, kv_heads, dim, cache)
        q = torch.randn((batch, t_new, heads, dim), generator=gen)
        want = decode_attention_reference(q, upcast(entry), start)
        got = emulate_kernel(q, entry, torch.tensor(start))
        torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_ATOL)


class TestPlan:
    def test_bench_decode_and_prefill(self):
        decode = plan(8, 1, 16, 16, 128, torch.bfloat16)
        assert decode.vec and decode.key_tile == 64
        assert decode.grid == (1, 16, 8)  # 128 blocks on 132 SMs
        assert plan(8, 64, 16, 16, 128, torch.int8).grid == (4, 16, 8)
        assert plan(2, 1, 16, 4, 128, torch.float32).grid == (1, 4, 2)

    @pytest.mark.parametrize("dim,cache,vec", [
        (128, torch.bfloat16, True), (64, torch.bfloat16, True),
        (16, torch.bfloat16, True), (8, torch.bfloat16, True),
        (8, torch.int8, False), (16, torch.int8, True),
        (6, torch.bfloat16, False), (2, torch.float32, False),
        (4, torch.float32, True), (100, torch.int8, False)])
    def test_sixteen_byte_loads_where_a_row_allows(self, dim, cache, vec):
        assert plan(1, 1, 2, 2, dim, cache).vec is vec
        assert not plan(1, 1, 2, 2, dim, cache, aligned=False).vec

    @pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16,
                                       torch.int8])
    def test_every_even_head_dim_fits_shared_memory(self, cache):
        for dim in range(2, dmod.MAX_HEAD_DIM + 1, 2):
            p = plan(1, 64, 16, 4, dim, cache)
            assert p.smem_bytes <= dmod.MAX_SMEM, dim
            assert p.key_tile >= dmod.MIN_KEY_TILE and p.key_tile % 2 == 0
            assert p.row_stride % 16 == 0
            assert p.row_stride >= dim * cache.itemsize


def small_case(q_dtype=torch.float32, cache="float32", seq=10, t_new=2):
    gen = torch.Generator().manual_seed(35)
    entry = random_entry(gen, 2, seq, 2, 8, cache)
    q = torch.randn((2, t_new, 4, 8), generator=gen).to(q_dtype)
    return q, entry


def kv_of(q):
    """A (B, T, 2, 8) key block in q's dtype and on q's device."""
    return q[:, :, :2].contiguous()


class TestWrappers:
    @pytest.mark.parametrize("q_dtype,cache", [
        (torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
        (torch.bfloat16, "float32"), (torch.bfloat16, "int8"),
        (torch.float32, "int8")])
    def test_cpu_takes_the_plain_version(self, q_dtype, cache):
        q, entry = small_case(q_dtype, cache)
        before = (decode_attention.launches, kv_append.launches)
        got = decode_attention(q, entry, 3)
        assert torch.equal(got, decode_attention_reference(q, entry, 3))
        assert got.dtype == dmod.output_dtype(q_dtype, entry["k"].dtype)
        new = {n: t.clone() for n, t in entry.items()}
        k = torch.randn((2, 2, 2, 8)).to(q_dtype)
        kv_append(entry, k, k * 2, 3)
        kv_append_reference(new, k, k * 2, 3)
        assert all(torch.equal(entry[n], new[n]) for n in entry)
        assert (decode_attention.launches, kv_append.launches) == before

    @pytest.mark.parametrize("cache", ["bfloat16", "int8"])
    def test_int_and_tensor_start_pos_give_the_same_bits(self, cache):
        q, entry = small_case(torch.bfloat16, cache)
        other = {n: t.clone() for n, t in entry.items()}
        k = torch.randn((2, 2, 2, 8)).bfloat16()
        kv_append(entry, k, -k, 6)
        pos = torch.tensor(6)
        kv_append(other, k, -k, pos)
        assert all(torch.equal(entry[n], other[n]) for n in entry)
        assert torch.equal(decode_attention(q, entry, 6),
                           decode_attention(q, other, pos))
        assert int(pos) == 6

    def test_kv_append_writes_only_its_rows(self):
        _, entry = small_case(cache="int8")
        old = {n: t.clone() for n, t in entry.items()}
        k = torch.randn((2, 3, 2, 8))
        kv_append(entry, k, k, torch.tensor(4))
        for name, t in entry.items():
            assert torch.equal(t[:, :4], old[name][:, :4])
            assert torch.equal(t[:, 7:], old[name][:, 7:])
        codes, scales = kmod._quantize_kv_block(k)
        assert torch.equal(entry["v"][:, 4:7], codes)
        assert torch.equal(entry["v_s"][:, 4:7], scales)

    @pytest.mark.parametrize("bad", [
        "q_float16", "q_float64", "cache_float16", "int8_without_scales",
        "scales_float64", "k_v_dtypes_differ", "float_cache_with_scales"])
    def test_bad_dtypes_raise(self, bad):
        q, entry = small_case(cache="int8" if "scales" in bad else "float32")
        if bad == "q_float16":
            q = q.half()
        elif bad == "q_float64":
            q = q.double()
        elif bad == "cache_float16":
            entry = {n: t.half() for n, t in entry.items()}
        elif bad == "int8_without_scales":
            entry = {"k": entry["k"], "v": entry["v"]}
        elif bad == "scales_float64":
            entry["k_s"] = entry["k_s"].double()
        elif bad == "k_v_dtypes_differ":
            entry["v"] = entry["v"].bfloat16()
        else:
            entry = {"k": entry["k"].float(), "k_s": entry["k_s"],
                     "v": entry["v"].float(), "v_s": entry["v_s"]}
        with pytest.raises(ValueError):
            decode_attention(q, entry, 3)
        with pytest.raises(ValueError):
            kv_append(entry, kv_of(q), kv_of(q), 3)

    @pytest.mark.parametrize("bad", [
        "q_head_dim", "heads_not_a_multiple", "batch", "q_3d",
        "cache_shapes_differ", "scale_shape", "not_contiguous"])
    def test_bad_attention_shapes_raise(self, bad):
        q, entry = small_case(cache="int8")
        if bad == "q_head_dim":
            q = q[..., :6].contiguous()
        elif bad == "heads_not_a_multiple":
            q = q[:, :, :3].contiguous()
        elif bad == "batch":
            q = q[:1]
        elif bad == "q_3d":
            q = q[0]
        elif bad == "cache_shapes_differ":
            entry["v"] = entry["v"][:, :5].contiguous()
        elif bad == "scale_shape":
            entry["k_s"] = entry["k_s"][:, :5].contiguous()
        else:
            q = q.transpose(1, 2)
        with pytest.raises(ValueError):
            decode_attention(q, entry, 3)

    @pytest.mark.parametrize("bad", [
        "block_past_the_cache", "t_longer_than_the_cache", "kv_heads",
        "head_dim", "k_v_shapes_differ", "int_dtype"])
    def test_bad_append_shapes_raise(self, bad):
        _, entry = small_case(seq=10)
        k = v = torch.randn((2, 2, 2, 8))
        pos = 3
        if bad == "block_past_the_cache":
            pos = 9
        elif bad == "t_longer_than_the_cache":
            k = v = torch.randn((2, 11, 2, 8))
            pos = 0
        elif bad == "kv_heads":
            k = v = torch.randn((2, 2, 4, 8))
        elif bad == "head_dim":
            k = v = torch.randn((2, 2, 2, 6))
        elif bad == "k_v_shapes_differ":
            v = torch.randn((2, 1, 2, 8))
        else:
            k = v = torch.ones((2, 2, 2, 8), dtype=torch.int32)
        with pytest.raises(ValueError):
            kv_append(entry, k, v, pos)

    def test_odd_head_dims_raise(self):
        entry = {"k": torch.zeros((1, 4, 1, 7)), "v": torch.zeros((1, 4, 1, 7))}
        with pytest.raises(ValueError, match="even"):
            decode_attention(torch.zeros((1, 1, 1, 7)), entry, 0)
        with pytest.raises(ValueError, match="even"):
            kv_append(entry, torch.zeros((1, 1, 1, 7)),
                      torch.zeros((1, 1, 1, 7)), 0)

    @pytest.mark.parametrize("pos", [-1, True, 2.0, "1", np.int64(2)])
    def test_bad_start_pos_raise(self, pos):
        q, entry = small_case()
        with pytest.raises(ValueError, match="start_pos"):
            decode_attention(q, entry, pos)
        with pytest.raises(ValueError, match="start_pos"):
            kv_append(entry, kv_of(q), kv_of(q), pos)

    @pytest.mark.parametrize("pos", [
        torch.tensor([3]), torch.tensor(3, dtype=torch.int32),
        torch.tensor(3.0)], ids=["1d", "int32", "float"])
    def test_bad_start_pos_tensors_raise(self, pos):
        q, entry = small_case()
        with pytest.raises(ValueError, match="start_pos"):
            decode_attention(q, entry, pos)
        with pytest.raises(ValueError, match="start_pos"):
            kv_append(entry, kv_of(q), kv_of(q), pos)

    def test_another_device_raises_rather_than_running_the_plain_version(
            self):
        """Tensors on a device that is neither the CPU nor CUDA (``meta``)
        pass the checks and then raise: no plain fallback."""
        q, entry = small_case(cache="int8")
        q = q.to("meta")
        entry = {n: t.to("meta") for n, t in entry.items()}
        pos = torch.tensor(3, device="meta")
        before = (decode_attention.launches, kv_append.launches)
        with pytest.raises(ValueError, match="unsupported device"):
            decode_attention(q, entry, pos)
        with pytest.raises(ValueError, match="unsupported device"):
            kv_append(entry, kv_of(q), kv_of(q), pos)
        assert (decode_attention.launches, kv_append.launches) == before

    def test_mixed_devices_raise(self):
        q, entry = small_case()
        with pytest.raises(ValueError, match="meta"):
            decode_attention(q.to("meta"), entry, 3)
        with pytest.raises(ValueError, match="start_pos"):
            decode_attention(q, entry, torch.tensor(3, device="meta"))


class TestForwardWithCacheThroughTheWrappers:
    @pytest.mark.parametrize("quantize_kv", [False, True])
    def test_each_layer_calls_both_wrappers_once(self, weights, monkeypatch,
                                                 quantize_kv):
        """forward_with_cache writes each layer's cache with kv_append and
        reads it with decode_attention, once a layer, at the position it
        was given (the plain versions on the CPU)."""
        _, tp = weights
        calls = []

        def spy(name, fn):
            def wrapped(*args):
                calls.append((name, args[-1]))
                return fn(*args)
            return wrapped

        monkeypatch.setattr(tdecode, "kv_append",
                            spy("kv_append", tdecode.kv_append))
        monkeypatch.setattr(tdecode, "decode_attention",
                            spy("decode_attention", tdecode.decode_attention))
        cache = tdecode.init_kv_cache(TCFG, 2, 8, quantize_kv=quantize_kv,
                                      device="cpu")
        pos = torch.tensor(2)
        tdecode.forward_with_cache(tp, torch.zeros((2, 3), dtype=torch.long),
                                   cache, pos, TCFG)
        assert [c[0] for c in calls] == ["kv_append", "decode_attention"] \
            * TCFG.n_layers
        assert all(c[1] is pos for c in calls)

"""The cached step's two kernels on the CPU: the cache write
(``kernels/kv_append.py``) and the cached attention
(``kernels/decode_attention.py``) against the JAX package, their wrappers
(the plain version on the CPU, the checks), the launch plan, and the
attention kernel's tiled online softmax emulated in float32 against the
plain version. The kernels themselves run in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
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


def in_order(x, dim):
    """The sum of ``x`` over ``dim`` taken term by term in index order
    (a scan's last prefix), so that terms of exactly 0 appended to it
    change no bit; a reduction may group the terms by their count."""
    return x.cumsum(dim=dim).select(dim, -1)


def combine(states):
    """(m, l, acc) states of the same rows combined in their order: m =
    max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m), an
    empty state (m = -inf) weighing 0."""
    ms = torch.stack([s[0] for s in states])
    m = ms.amax(dim=0)
    w = torch.where(ms == -math.inf, 0.0, torch.exp(ms - m))
    l = in_order(torch.stack([s[1] for s in states]) * w, 0)
    acc = in_order(torch.stack([s[2] for s in states]) * w[..., None], 0)
    return m, l, acc


def emulate_kernel(q, entry, start_pos, walk_all=False):
    """The kernel's schedule (``csrc/decode_attention.cu``) in float32:
    per (batch row, kv head, tile of MAX_ROWS query rows, row r being the
    (t, g) pair divmod(r, group)), ``plan``'s splits, which share the
    keys up to the last one visible to the tile's last row in equal runs
    of whole tiles (``split_ranges``; ``walk_all``: every split walks its
    whole run, past that key, to show that the early stop changes no
    bit), the splits past the last run skipped. Each part (the
    tensor cores' four warps, keys 16w .. 16w + 15 of every 64-key tile;
    the CUDA cores' whole block) keeps an online softmax: its scores (times
    the K scale), the visible keys s <= start_pos + t, the running max and
    sum rescaled once a tile, the weights times the V scale (on the tensor
    cores then split into hi + lo bf16, two products) before the values.
    The parts combine in order into the split's (m, l, acc), the splits in
    split order (one nonempty split stands alone), and one division ends
    it."""
    batch, t_new, heads, dim = q.shape
    seq, kv_heads = entry["k"].shape[1:3]
    group = heads // kv_heads
    p = plan(batch, t_new, heads, kv_heads, seq, dim, q.dtype,
             entry["k"].dtype)
    tensor = p.route == "tensor_cores"
    part_keys = 16 if tensor else p.key_tile
    k, v = entry["k"].float(), entry["v"].float()
    quant = "k_s" in entry
    pos = int(start_pos)
    out = torch.empty(q.shape)
    for b in range(batch):
        for kvh in range(kv_heads):
            for row_tile in range(p.grid[0] // p.splits):
                rows = torch.arange(row_tile * dmod.MAX_ROWS,
                                    min((row_tile + 1) * dmod.MAX_ROWS,
                                        t_new * group))
                ts, hs = rows // group, kvh * group + rows % group
                # every key's score at once: a tile's slice of it does not
                # depend on how far the walk goes
                sc_all = q[b, ts, hs].float() @ k[b, :, kvh].T * dim ** -0.5
                if quant:
                    sc_all = sc_all * entry["k_s"][b, :, kvh]
                vis_end = min(seq, pos + int(ts[-1]) + 1)
                ranges = dmod.split_ranges(p, vis_end)
                if walk_all:  # every split to its run's end, past vis_end
                    tiles = -(-vis_end // p.key_tile)
                    run = max(1, -(-tiles // p.splits)) * p.key_tile
                    ranges = [(i * run, min(seq, (i + 1) * run))
                              for i in range(p.splits)]
                states = []
                for k_begin, k_end in ranges:
                    parts = []
                    for part in range(p.key_tile // part_keys):
                        m = torch.full((len(rows),), -math.inf)
                        l = torch.zeros(len(rows))
                        acc = torch.zeros(len(rows), dim)
                        for s0 in range(k_begin, k_end, p.key_tile):
                            lo = s0 + part * part_keys
                            hi = min(lo + part_keys, k_end)
                            if lo >= hi:
                                continue
                            keys = torch.arange(lo, hi)
                            sc = sc_all[:, keys]
                            seen = keys[None, :] <= (pos + ts)[:, None]
                            m_new = torch.maximum(m, torch.where(
                                seen, sc, -math.inf).amax(dim=1))
                            w = torch.where(seen,
                                            torch.exp(sc - m_new[:, None]),
                                            0.0)
                            corr = torch.where(m_new == -math.inf, 1.0,
                                               torch.exp(m - m_new))
                            l = l * corr + in_order(w, 1)
                            if quant:
                                w = w * entry["v_s"][b, keys, kvh]
                            terms = (w,)
                            if tensor:  # hi + lo bf16, two products
                                w_hi = w.bfloat16().float()
                                terms = (w_hi, (w - w_hi).bfloat16().float())
                            acc = acc * corr[:, None]
                            for term in terms:
                                acc = acc + in_order(
                                    term[:, :, None] * v[b, keys, kvh], 1)
                            m = m_new
                        parts.append((m, l, acc))
                    states.append(combine(parts))
                _, l, acc = states[0] if len(states) == 1 \
                    else combine(states)
                out[b, ts, hs] = acc / l[:, None]
    return out


#: (B, T, n_heads, n_kv_heads, S, head_dim, start_pos) of the emulation:
#: decode, GQA, a prefill block of 3 row tiles (40 rows of 2 heads a kv
#: head), a start mid-sequence, a ragged last key tile, a long f32 row
#: (32-key tiles); the last visible key at the end and at the start of a
#: key tile (4 splits of one tile: three, or two, wholly past it), and
#: where two splits' runs grow from one tile to two (8 x 16 groups: runs
#: [0, 64) and [64, 128), then [0, 128) and [128, 129))
EMULATED = [
    (2, 1, 4, 4, 70, 16, 69),
    (2, 1, 8, 2, 70, 16, 41),
    (1, 20, 4, 2, 100, 8, 0),
    (1, 5, 4, 4, 130, 16, 60),
    (1, 2, 2, 1, 67, 256, 30),
    (2, 1, 4, 4, 200, 16, 63),
    (2, 1, 4, 4, 200, 16, 64),
    (8, 1, 16, 16, 300, 16, 127),
    (8, 1, 16, 16, 300, 16, 128),
]
EMULATED_IDS = ["decode", "gqa", "prefill_row_tiles", "mid_sequence",
                "long_rows", "tile_end", "tile_start", "run_end",
                "run_grows"]
#: a bf16 output against the plain version in float32: one rounding of
#: the output and of each weight (chip_smoke.KERNEL_TOL's bf16 limit)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3


def emulation_case(shape, cache, q_dtype):
    batch, t_new, heads, kv_heads, seq, dim, start = shape
    gen = torch.Generator().manual_seed(34)
    entry = random_entry(gen, batch, seq, kv_heads, dim, cache)
    q = torch.randn((batch, t_new, heads, dim), generator=gen).to(q_dtype)
    return q, entry, start


class TestKernelSchedule:
    @pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("shape", EMULATED, ids=EMULATED_IDS)
    def test_emulated_schedule_matches_plain_version(self, shape, cache):
        """float32 q (the CUDA cores) against the plain version in
        float32: the same terms summed in another order."""
        q, entry, start = emulation_case(shape, cache, torch.float32)
        assert plan(*q.shape[:3], entry["k"].shape[2], entry["k"].shape[1],
                    q.shape[3], q.dtype, entry["k"].dtype).route \
            == "cuda_cores"
        want = decode_attention_reference(q, upcast(entry), start)
        got = emulate_kernel(q, entry, torch.tensor(start))
        torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_ATOL)

    @pytest.mark.parametrize("cache", ["bfloat16", "int8"])
    @pytest.mark.parametrize("shape", EMULATED, ids=EMULATED_IDS)
    def test_tensor_core_schedule_matches_plain_version(self, shape, cache):
        """bf16 q over a bf16 or int8 cache (the tensor cores where
        head_dim is a multiple of 16): the weights as hi + lo bf16 in the
        value product, the output rounded once, against the plain version
        in float32 on the same inputs."""
        q, entry, start = emulation_case(shape, cache, torch.bfloat16)
        p = plan(*q.shape[:3], entry["k"].shape[2], entry["k"].shape[1],
                 q.shape[3], q.dtype, entry["k"].dtype)
        assert (p.route == "tensor_cores") == (q.shape[3] % 16 == 0)
        want = decode_attention_reference(q.float(), upcast(entry), start)
        got = emulate_kernel(q, entry, start).bfloat16().float()
        torch.testing.assert_close(got, want, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)

    @pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                             ids=["cuda_cores", "tensor_cores"])
    @pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("shape", EMULATED, ids=EMULATED_IDS)
    def test_early_stop_equals_walking_every_tile(self, shape, cache,
                                                  q_dtype):
        """Stopping at the last visible key and skipping the splits past
        it changes no bit: a masked key weighs exactly 0, a tile of them
        rescales by exactly 1, an empty split weighs 0."""
        q, entry, start = emulation_case(shape, cache, q_dtype)
        assert torch.equal(emulate_kernel(q, entry, start),
                           emulate_kernel(q, entry, start, walk_all=True))

    @pytest.mark.parametrize("vis_end,ranges", [
        (0, [(0, 0)]), (1, [(0, 1)]), (64, [(0, 64)]),
        (65, [(0, 64), (64, 65)]), (128, [(0, 64), (64, 128)]),
        (129, [(0, 128), (128, 129)]), (300, [(0, 192), (192, 300)])])
    def test_splits_share_the_visible_keys(self, vis_end, ranges):
        """The two splits of the split shapes deal the visible key tiles
        in equal runs; a split past the last run reads nothing."""
        p = plan(8, 1, 16, 16, 300, 16, torch.bfloat16, torch.int8)
        assert p.splits == 2
        assert dmod.split_ranges(p, vis_end) == ranges

    @pytest.mark.parametrize("splits", [1, 2, 3, 4, 16, 32])
    def test_split_ranges_cover_the_visible_keys(self, splits):
        p = dataclasses.replace(plan(1, 1, 1, 1, 2048, 128, torch.bfloat16,
                                     torch.bfloat16), splits=splits)
        for vis_end in range(1, 2049, 7):
            ranges = dmod.split_ranges(p, vis_end)
            assert 1 <= len(ranges) <= splits
            assert ranges[0][0] == 0 and ranges[-1][1] == vis_end
            assert all(a % p.key_tile == 0 and a < b for a, b in ranges)
            assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))


class TestPlan:
    def test_bench_decode_and_prefill(self):
        decode = plan(8, 1, 16, 16, 1024, 128, torch.bfloat16,
                      torch.bfloat16)
        assert decode.route == "tensor_cores" and decode.vec
        # 128 groups, 2 splits: 256 blocks on 132 SMs, three fit an SM
        assert decode.splits == 2 and decode.grid == (2, 16, 8)
        assert (decode.key_tile, decode.stages) == (64, 2)
        assert dmod.blocks_that_fit(decode.smem_bytes) == 3
        prefill = plan(8, 64, 16, 16, 1024, 128, torch.bfloat16, torch.int8)
        assert prefill.route == "tensor_cores" and prefill.splits == 1
        assert prefill.grid == (4, 16, 8)
        tp2 = plan(4, 1, 8, 8, 1024, 128, torch.bfloat16, torch.bfloat16)
        assert (tp2.splits, tp2.blocks) == (8, 256)
        gqa = plan(2, 1, 16, 4, 1000, 128, torch.float32, torch.float32)
        assert gqa.route == "cuda_cores" and gqa.grid == (16, 4, 2)
        assert gqa.splits == 16  # one key tile each

    @pytest.mark.parametrize("dim,cache,vec", [
        (128, torch.bfloat16, True), (64, torch.bfloat16, True),
        (16, torch.bfloat16, True), (8, torch.bfloat16, True),
        (8, torch.int8, False), (16, torch.int8, True),
        (6, torch.bfloat16, False), (2, torch.float32, False),
        (4, torch.float32, True), (100, torch.int8, False)])
    def test_sixteen_byte_loads_where_a_row_allows(self, dim, cache, vec):
        assert plan(1, 1, 2, 2, 64, dim, torch.bfloat16, cache).vec is vec
        assert not plan(1, 1, 2, 2, 64, dim, torch.bfloat16, cache,
                        aligned=False).vec

    @pytest.mark.parametrize("q_dtype,cache,dim,route", [
        (torch.bfloat16, torch.bfloat16, 128, "tensor_cores"),
        (torch.bfloat16, torch.int8, 16, "tensor_cores"),
        (torch.bfloat16, torch.int8, 256, "tensor_cores"),
        (torch.bfloat16, torch.bfloat16, 8, "cuda_cores"),
        (torch.bfloat16, torch.int8, 8, "cuda_cores"),
        (torch.bfloat16, torch.float32, 128, "cuda_cores"),
        (torch.float32, torch.bfloat16, 128, "cuda_cores"),
        (torch.float32, torch.int8, 128, "cuda_cores")])
    def test_route(self, q_dtype, cache, dim, route):
        assert plan(2, 1, 4, 4, 100, dim, q_dtype, cache).route == route
        if route == "tensor_cores":
            p = plan(2, 1, 4, 4, 100, dim, q_dtype, cache, aligned=False)
            assert p.route == "cuda_cores"

    @pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16,
                                       torch.int8])
    def test_every_even_head_dim_fits_shared_memory(self, cache, q_dtype):
        for dim in range(2, dmod.MAX_HEAD_DIM + 1, 2):
            p = plan(1, 64, 16, 4, 1024, dim, q_dtype, cache)
            assert p.smem_bytes <= dmod.MAX_SMEM, dim
            assert p.key_tile >= dmod.MIN_KEY_TILE and p.key_tile % 2 == 0
            assert dmod.MIN_STAGES <= p.stages <= dmod.MAX_STAGES
            assert p.row_stride % 16 == 0
            assert p.row_stride >= dim * cache.itemsize
            assert p.smem_bytes == dmod.smem_bytes(
                p.route, dim, cache, p.key_tile, p.row_stride, p.stages)
            if p.route == "tensor_cores":
                assert p.key_tile == 64 and dim % 16 == 0
                assert p.row_stride == dim * cache.itemsize + (
                    16 if cache == torch.bfloat16 else 0)

    @pytest.mark.parametrize("seq", [1, 63, 64, 65, 300, 997, 1024, 8192])
    @pytest.mark.parametrize("batch,heads", [(1, 1), (2, 4), (4, 8),
                                             (8, 16), (64, 16)])
    def test_splits_fit_the_cache_and_the_counters(self, seq, batch, heads):
        p = plan(batch, 1, heads, heads, seq, 128, torch.bfloat16,
                 torch.bfloat16)
        assert 1 <= p.splits <= min(dmod.MAX_SPLITS, -(-seq // p.key_tile))
        if p.splits > 1:
            assert p.groups <= dmod.COUNTERS
        assert p.blocks <= max(dmod.TARGET_BLOCKS, p.groups)

    @pytest.mark.parametrize("shape", chip_smoke.DECODE_SHAPES,
                             ids=lambda s: f"{s[0]}-{s[-1]}")
    def test_chip_smoke_shapes_fill_the_card(self, shape):
        """Every phase-3e shape runs at least a wave of blocks on an
        H100's 132 SMs, or one block for each of its key tiles, within
        shared memory; bf16 q over a bf16 or int8 cache on the tensor
        cores where head_dim allows."""
        _, batch, t_new, heads, kv_heads, seq, _, dim, q_dtype, cache = shape
        p = plan(batch, t_new, heads, kv_heads, seq, dim, q_dtype, cache)
        assert p.blocks >= 132 or p.splits == -(-seq // p.key_tile)
        assert dmod.blocks_that_fit(p.smem_bytes) >= 1
        assert p.smem_bytes <= dmod.MAX_SMEM
        assert (p.route == "tensor_cores") == (
            q_dtype == torch.bfloat16 and cache != torch.float32
            and dim % 16 == 0)


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
        """forward_with_cache rotates q and k and writes each layer's cache
        with rope_kv_append and reads it with decode_attention, once a
        layer, at the position it was given (the plain versions on the
        CPU), with the config's theta; the rotation-free kv_append is not
        called."""
        _, tp = weights
        calls = []

        def spy(name, fn, pos_arg):
            def wrapped(*args):
                calls.append((name, args[pos_arg], args[pos_arg + 1:]))
                return fn(*args)
            return wrapped

        monkeypatch.setattr(tdecode, "rope_kv_append",
                            spy("rope_kv_append", tdecode.rope_kv_append, 4))
        monkeypatch.setattr(tdecode, "decode_attention",
                            spy("decode_attention", tdecode.decode_attention,
                                2))
        monkeypatch.setattr(kmod, "kv_append",
                            spy("kv_append", kmod.kv_append, 3))
        cache = tdecode.init_kv_cache(TCFG, 2, 8, quantize_kv=quantize_kv,
                                      device="cpu")
        pos = torch.tensor(2)
        tdecode.forward_with_cache(tp, torch.zeros((2, 3), dtype=torch.long),
                                   cache, pos, TCFG)
        assert [c[0] for c in calls] == ["rope_kv_append",
                                         "decode_attention"] * TCFG.n_layers
        assert all(c[1] is pos for c in calls)
        assert all(c[2] == (TCFG.rope_theta,) for c in calls[::2])

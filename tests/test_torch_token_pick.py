"""The port's token pick against the JAX package's ``_pick_next`` on the
CPU: greedy tokens bit for bit (bfloat16 and float32, planted ties, a
NaN), sampled tokens equal when the port's plain version is fed JAX's own
uniforms (``jax.random.uniform(key, (B, V), minval=tiny, maxval=1.)``,
what ``jax.random.categorical`` draws its Gumbel noise from), logprobs
within 1e-6, and a few cached sampled steps of the small Llama through
both packages. Also the wrapper's own contract: the plain version for
CPU tensors (no launch), its checks, and ``_pick_next`` as one pick."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_operator_libs.examples import llama as jllama
from tpu_operator_libs.examples import llama_decode as jdecode
from tpu_operator_libs_torch.convert import params_from_jax
from tpu_operator_libs_torch.examples import llama as tllama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.kernels import SOURCES, WRAPPERS
from tpu_operator_libs_torch.kernels import token_pick as tpick

TINY = float(np.finfo(np.float32).tiny)
#: logprobs: float32 log-softmax on both sides, the row's sum of exps in
#: another order (a few float32 ulps of a value near -8)
LOGPROB_ATOL = 1e-6
#: the cached steps' logprobs: the two packages' logits agree to ~1e-6
#: (tests/test_torch_llama_decode.py holds them to 1e-4)
SLICE_LOGPROB_ATOL = 1e-5
#: (top_k, top_p); "V" is the row's width
SETTINGS = [(None, None), (50, None), (None, 0.9), (50, 0.9), (1, None),
            (None, 1e-9), ("V", 1.0)]
TEMPERATURES = [0.05, 0.8, 1.0]
#: (B, V, keys): the bench decode's width over 20 keys, and two odd ones
SHAPES = [(8, 2048, 20), (8, 17, 5), (4, 1001, 5)]


def logits_for(seed, batch, vocab, dtype=np.float32):
    """(B, V) logits, 3 x a standard normal, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((batch, vocab))).astype(dtype)


def jax_uniform(key, shape):
    """JAX's uniforms of ``categorical``'s Gumbel noise, as numpy."""
    return np.array(jax.random.uniform(key, shape, jnp.float32,
                                       minval=TINY, maxval=1.0))


class TestGreedy:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bit_equal_to_jax(self, dtype):
        x = logits_for(0, 8, 2048)
        # planted ties: row 1's maximum twice, row 2's three times
        x[1, [7, 900]] = 50.0
        x[2, [3, 4, 2047]] = 50.0
        # a NaN wins, as in jnp.argmax
        x[3, 1000] = np.nan
        # an all -inf row picks its first index
        x[4] = -np.inf
        jx = jnp.asarray(x).astype(jnp.dtype(dtype))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        want = np.asarray(jnp.argmax(jx, axis=-1))
        jtok, _ = jdecode._pick_next(jx, 0.0, None, None)
        got, lp = tpick.pick_reference(tx, None, 0.0)
        assert lp is None and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtok)[:, 0])
        assert list(got[1:5]) == [7, 3, 1000, 0]

    def test_logprob_within_tolerance_of_jax(self):
        x = logits_for(1, 8, 2048)
        jtok, jlp = jdecode._pick_next(jnp.asarray(x), 0.0, None, None,
                                       want_logprob=True)
        got, lp = tpick.pick_reference(torch.from_numpy(x), None, 0.0,
                                       want_logprob=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtok)[:, 0])
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                                   atol=LOGPROB_ATOL)


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("top_k,top_p", SETTINGS,
                         ids=[f"k{k}_p{p}" for k, p in SETTINGS])
def test_sampled_equal_to_jax_on_jax_noise(top_k, top_p, temperature):
    """``pick_reference`` on ``jax.random.uniform``'s noise draws JAX's
    ``_pick_next`` tokens from the same key, row for row, and its logprobs
    within LOGPROB_ATOL."""
    for batch, vocab, keys in SHAPES:
        k = vocab if top_k == "V" else top_k
        if k is not None and k > vocab:
            k = vocab
        for i in range(keys):
            x = logits_for(100 + i, batch, vocab)
            key = jax.random.PRNGKey(1000 * vocab + i)
            jtok, jlp = jdecode._pick_next(jnp.asarray(x), temperature, k,
                                           key, top_p, want_logprob=True)
            u = torch.from_numpy(jax_uniform(key, (batch, vocab)))
            got, lp = tpick.pick_reference(torch.from_numpy(x), u,
                                           temperature, k, top_p,
                                           want_logprob=True)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jtok)[:, 0],
                err_msg=f"V={vocab} key {i}")
            np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                                       atol=LOGPROB_ATOL)


def test_sampled_masks_hold_on_planted_rows():
    """Top-k keeps every tie of the k-th largest; top-p 1e-9 keeps only
    the maximum (and its ties); -inf logits are never drawn."""
    x = logits_for(7, 4, 64)
    x[0, [5, 6, 7]] = 20.0  # the top three tie
    x[1, 10:] = -np.inf
    x[2, [1, 2]] = 30.0
    tx = torch.from_numpy(x)
    for seed in range(30):
        u = torch.rand((4, 64), generator=torch.Generator().manual_seed(seed))
        tok, _ = tpick.pick_reference(tx, u, 1.0, top_k=2)
        assert int(tok[0]) in (5, 6, 7)
        assert int(tok[1]) < 10
        tok, _ = tpick.pick_reference(tx, u, 1.0, top_p=1e-9)
        assert int(tok[0]) in (5, 6, 7) and int(tok[2]) in (1, 2)


@pytest.fixture(scope="module")
def small_llama():
    jcfg = jllama.LlamaConfig()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    jp = jllama.init_llama_params(mesh, jcfg)
    return jcfg, mesh, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, 0.9)],
                         ids=["plain", "k8_p0.9"])
def test_cached_sampled_steps_equal_to_jax(small_llama, top_k, top_p):
    """A prompt through the cache and five sampled steps: JAX's
    ``generate`` (``forward_with_cache`` + ``_pick_next`` with a key split
    a pick) against the port's ``forward_with_cache`` on the converted
    parameters + ``pick_reference`` fed JAX's uniforms from the same
    split keys: tokens equal, logprobs within SLICE_LOGPROB_ATOL."""
    jcfg, mesh, jp, tp = small_llama
    tcfg = tllama.LlamaConfig()
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab, (4, 6)).astype(np.int32)
    new, temperature = 6, 0.8
    key = jax.random.PRNGKey(11)
    jtok, jlp = jdecode.generate(jp, jnp.asarray(prompt), jcfg, mesh, new,
                                 temperature=temperature, top_k=top_k,
                                 key=key, top_p=top_p, return_logprobs=True)
    cache = tdecode.init_kv_cache(tcfg, 4, 6 + new, device="cpu")
    logits, cache = tdecode.forward_with_cache(
        tp, torch.from_numpy(prompt).long(), cache, 0, tcfg)
    toks, lps = [], []
    for i in range(new):
        key, sub = jax.random.split(key)
        u = torch.from_numpy(jax_uniform(sub, (4, jcfg.vocab)))
        last, lp = tpick.pick_reference(logits[:, -1], u, temperature,
                                        top_k, top_p, want_logprob=True)
        toks.append(last)
        lps.append(lp)
        if i + 1 < new:
            logits, cache = tdecode.forward_with_cache(
                tp, last[:, None], cache, 6 + i, tcfg)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.asarray(jtok)[:, 6:])
    np.testing.assert_allclose(torch.stack(lps, 1).numpy(), np.asarray(jlp),
                               rtol=0, atol=SLICE_LOGPROB_ATOL)


class TestWrapper:
    def test_listed_with_its_source_and_count(self):
        assert WRAPPERS["token_pick"] is tpick.pick
        assert tpick.SOURCE in SOURCES
        assert isinstance(tpick.pick.launches, int)

    @pytest.mark.parametrize("temperature,top_k,top_p,want_logprob", [
        (0.0, None, None, False), (0.0, None, None, True),
        (0.7, 5, 0.8, True), (1.0, None, None, False)])
    def test_cpu_runs_the_plain_version_without_a_launch(
            self, temperature, top_k, top_p, want_logprob):
        x = torch.from_numpy(logits_for(5, 3, 40))
        u = torch.rand((3, 40), generator=torch.Generator().manual_seed(1))
        before = tpick.pick.launches
        got = tpick.pick(x, u, temperature, top_k, top_p, want_logprob)
        want = tpick.pick_reference(x, u, temperature, top_k, top_p,
                                    want_logprob)
        assert tpick.pick.launches == before
        assert torch.equal(got[0], want[0])
        if want_logprob:
            assert torch.equal(got[1], want[1])
        else:
            assert got[1] is None

    def test_strided_rows(self):
        """The prefill pick's ``logits[:, -1, :]``: rows a stride apart."""
        full = torch.from_numpy(logits_for(6, 2 * 3, 40)).reshape(2, 3, 40)
        view = full[:, -1, :]
        assert not view.is_contiguous()
        got, _ = tpick.pick(view, None, 0.0)
        assert torch.equal(got, torch.argmax(view.contiguous(), dim=-1))

    @pytest.mark.parametrize("kwargs,match", [
        ({"logits": torch.zeros(3)}, "(B, V)"),
        ({"logits": torch.zeros((2, 4), dtype=torch.float16)}, "dtype"),
        ({"logits": torch.zeros((4, 2)).t()}, "contiguous"),
        ({"u": None}, "uniforms"),
        ({"u": torch.zeros((2, 4), dtype=torch.float64)}, "uniforms"),
        ({"u": torch.zeros((4, 2)).t()}, "contiguous"),
        ({"top_k": 5}, "top_k"),
        ({"top_k": 0}, "top_k"),
        ({"top_p": 0.0}, "top_p"),
        ({"top_p": 1.5}, "top_p"),
    ])
    def test_refuses(self, kwargs, match):
        args = {"logits": torch.zeros((2, 4)), "u": torch.full((2, 4), 0.5),
                "temperature": 1.0, "top_k": None, "top_p": None,
                **kwargs}
        with pytest.raises(ValueError, match=match):
            tpick.pick(**args)

    def test_greedy_reads_no_sampling_setting(self):
        got, _ = tpick.pick(torch.zeros((2, 4)), None, 0.0, top_k=99,
                            top_p=5.0)
        assert got.tolist() == [0, 0]

    def test_vector_width(self):
        x = torch.zeros((2, 3, 2048), dtype=torch.bfloat16)
        assert tpick.vector_width(x[:, -1]) == 8
        assert tpick.vector_width(x[:, -1].float()) == 4
        assert tpick.vector_width(torch.zeros((2, 1001))) == 1
        # rows that start 8 bytes off a 16-byte boundary
        assert tpick.vector_width(torch.zeros((2, 2056))[:, 2:2050]) == 1


def test_pick_next_is_one_pick_behind_one_draw():
    """``_pick_next`` draws (B, V) float32 uniforms from its generator
    once (none when greedy) and hands them to ``pick``: its tokens are
    ``pick_reference``'s on the same draw, as (B, 1)."""
    x = torch.from_numpy(logits_for(9, 3, 40))
    gen = torch.Generator().manual_seed(4)
    tok, lp = tdecode._pick_next(x, 0.9, 5, gen, 0.8, True)
    u = torch.rand((3, 40), generator=torch.Generator().manual_seed(4))
    want, want_lp = tpick.pick_reference(x, u, 0.9, 5, 0.8, True)
    assert tok.shape == (3, 1) and torch.equal(tok[:, 0], want)
    assert torch.equal(lp, want_lp)
    # the generator advanced by exactly one (B, V) draw
    state = torch.Generator().manual_seed(4)
    torch.rand((3, 40), generator=state)
    assert torch.equal(gen.get_state(), state.get_state())
    greedy_gen = torch.Generator().manual_seed(4)
    before = greedy_gen.get_state()
    tok, lp = tdecode._pick_next(x, 0.0, None, greedy_gen)
    assert lp is None and torch.equal(tok[:, 0], torch.argmax(x, dim=-1))
    assert torch.equal(greedy_gen.get_state(), before)


def _order_key(x):
    """The kernel's unsigned order of float32 values, as int64: float
    order, every NaN last."""
    b = x.contiguous().view(torch.int32).long() & 0xffffffff
    key = torch.where(b >= 0x80000000, 0xffffffff - b, b | 0x80000000)
    return torch.where(torch.isnan(x), 0xffffffff, key)


def _from_key(k):
    b = torch.where(k >= 0x80000000, k & 0x7fffffff, 0xffffffff - k)
    return b.to(torch.int64).where(b < 0x80000000, b - (1 << 32)) \
        .to(torch.int32).view(torch.float32)


def kernel_model(x, u, temperature, top_k, top_p):
    """The algorithm of ``csrc/token_pick.cu`` on the CPU, row-vectorised:
    top-k's threshold and the nucleus's p* by bisection over bit patterns
    (no sort), then the draw. Sums in torch's order, not the kernel's."""
    xf = x.float()
    batch, vocab = xf.shape
    inv_t = float(np.float32(1.0) / np.float32(temperature))
    if top_k is not None and top_k < vocab:
        keys, t = _order_key(xf), torch.zeros(batch, dtype=torch.int64)
        for bit in range(31, -1, -1):
            cand = t | (1 << bit)
            held = (keys >= cand[:, None]).sum(-1) >= top_k
            t = torch.where(held, cand, t)
        xf = xf.masked_fill(xf < _from_key(t)[:, None], float("-inf"))
    if top_p is not None:
        y = xf * inv_t
        e = torch.exp(y - y.max(-1, keepdim=True).values)
        pr = e / e.sum(-1, keepdim=True)
        bits = pr.view(torch.int32).long()

        def held(cand):
            return torch.where(bits > cand[:, None], pr, 0.0).sum(-1) >= top_p

        t = torch.zeros(batch, dtype=torch.int64)
        first = held(t)
        for bit in range(30, -1, -1):
            cand = t | (1 << bit)
            t = torch.where(held(cand), cand, t)
        t0 = torch.where(first, t + 1, 0)
        xf = xf.masked_fill(bits < t0[:, None], float("-inf"))
    u = torch.clamp_min(u, TINY)
    return torch.argmax(xf * inv_t - torch.log(-torch.log(u)), dim=-1)


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("top_k,top_p", SETTINGS,
                         ids=[f"k{k}_p{p}" for k, p in SETTINGS])
def test_bisection_finds_the_sorted_thresholds(top_k, top_p, temperature):
    """The kernel's sort-free thresholds (modelled on the CPU) draw the
    plain version's tokens on every row but those where either token's
    nucleus decision rests on a mass within 1e-5 of top_p (at most two
    of 96 rows), over random rows and planted ones (tied
    maxima, half a row -inf, three finite logits, equal pairs, a uniform
    row, bfloat16 ties). Temperatures are powers of two, so that the
    model's product with the reciprocal is the plain version's
    quotient."""
    import chip_smoke

    exempt_rows = 0
    for seed in range(6):
        x = torch.from_numpy(logits_for(200 + seed, 16, 2048))
        x[0, :3] = x[0].max() + 1.0
        x[1, 1024:] = float("-inf")
        x[2, 3:] = float("-inf")
        x[3, 1::2] = x[3, 0::2]
        x[4] = 0.0
        x[5:8] = x[5:8].bfloat16().float()  # many ties
        k = 2048 if top_k == "V" else top_k
        u = torch.rand(x.shape, generator=torch.Generator().manual_seed(seed))
        want, _ = tpick.pick_reference(x, u, temperature, k, top_p)
        got = kernel_model(x, u, temperature, k, top_p)
        uncertain = chip_smoke.nucleus_uncertain(x, temperature, k, top_p,
                                                 1e-5)
        exempt = (uncertain.gather(-1, got[:, None])
                  | uncertain.gather(-1, want[:, None]))[:, 0]
        exempt_rows += int(exempt.sum())
        assert bool(((got == want) | exempt).all()), (seed, got.tolist(),
                                                      want.tolist())
    assert exempt_rows <= 2


class TestCardScripts:
    """What ``chip_smoke.py`` and ``decode_step_profile.py`` read of the
    pick, on the CPU: its ptxas instances, its profiler rows, its launch
    accounting."""

    def test_build_phase_reads_the_pick_instances(self, monkeypatch,
                                                  capsys):
        import chip_smoke

        prefix = "_ZN46_GLOBAL__N__803aae80_13_token_pick_cu_fbc93af9"
        block = (" '{name}' for 'sm_90a'\n"
                 "ptxas info    : Function properties for {name}\n"
                 "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                 "spill loads\n"
                 "ptxas info    : Used {regs} registers, used 0 barriers\n")
        report = "".join(
            "Compiling entry function" + block.format(
                name=f"{prefix}22token_pick_{kind}_kernelILi{vec}ELb"
                     f"{sample}EEEvNS_6ParamsE", regs=regs)
            for kind, vec, sample, regs in (("block", 8, 1, 219),
                                            ("block", 8, 0, 99),
                                            ("wide", 1, 1, 34)))

        class Built:
            ptxas_report, build_seconds = report, 1.0

        monkeypatch.setattr(chip_smoke, "SOURCES", ["token_pick.cu"])
        monkeypatch.setattr(chip_smoke._build, "build_all",
                            lambda sources: [Built()])
        monkeypatch.setattr(chip_smoke, "BUILT_INSTANCES", {})
        chip_smoke.phase_build()
        out = capsys.readouterr().out
        assert "a block a row of up to 2,048" in out
        assert "a cluster of 8 blocks a row" in out
        assert chip_smoke.instance_ptxas(
            "token_pick.cu", "token_pick_block_kernel", vec=8,
            sample=True)["registers"] == 219
        assert chip_smoke.instance_ptxas(
            "token_pick.cu", "token_pick_block_kernel", vec=8,
            sample=False)["registers"] == 99
        assert chip_smoke.instance_ptxas(
            "token_pick.cu", "token_pick_wide_kernel", vec=1,
            sample=True)["registers"] == 34

    @pytest.mark.parametrize("key", [
        "void (anonymous namespace)::token_pick_block_kernel<8, true>("
        "(anonymous namespace)::Params)",
        "_ZN12_GLOBAL__N_122token_pick_wide_kernelILi1ELb0EEEvNS_6ParamsE"])
    def test_profile_names_the_pick(self, key):
        import decode_step_profile

        assert decode_step_profile.port_kernel(key) == "token_pick"

    def test_decode_launches_count_a_pick_a_forward(self, monkeypatch):
        import chip_smoke

        n = chip_smoke.CONFIG_277M.n_layers
        before = dict.fromkeys(chip_smoke.KERNELS, 0)
        after = {**before, "decode_attention": 3 * n, "rope_kv_append": 3 * n,
                 **chip_smoke.block_launches(3), "token_pick": 3}
        monkeypatch.setattr(chip_smoke, "launch_counts", lambda: after)
        assert chip_smoke.expect_decode_launches(before, 3, "test") == 3 * n
        with pytest.raises(RuntimeError, match="token_pick"):
            chip_smoke.expect_decode_launches(before, 3, "test", picks=0)
        with pytest.raises(RuntimeError, match="expected"):
            chip_smoke.expect_launches({**before, "token_pick": 1}, 0, 0,
                                       "a train path")

    def test_cases_name_valid_settings(self):
        import chip_smoke

        labels = [case[0] for case in chip_smoke.PICK_CASES]
        assert len(set(labels)) == len(labels)
        assert labels[0] == "bench_greedy"  # the kernels line's row
        for _, batch, vocab, dtype, settings, kind, draws, _ in \
                chip_smoke.PICK_CASES:
            x = torch.zeros((batch, vocab), dtype=dtype)
            u = torch.full((batch, vocab), 0.5)
            tok, lp = tpick.pick(x, u, settings["temperature"],
                                 settings["top_k"], settings["top_p"],
                                 settings["want_logprob"])
            assert tok.shape == (batch,)
            assert (lp is None) != settings["want_logprob"]
            assert kind in ("randn", "strided", "planted") and draws >= 1

    def test_sampling_settings_live_in_one_place(self):
        """The decode contract's settings and the served ones are
        ``decode_step_profile``'s, which phase 6 and phase 3h read: the
        pick's settings follow them, the logprob asked for apart."""
        import chip_smoke
        import decode_step_profile as dsp

        assert chip_smoke.SAMPLING is dsp.SAMPLING
        assert chip_smoke.SAMPLED_CELLS == {"contract": dsp.SAMPLING,
                                            "served": dsp.SERVED_SAMPLING}
        assert chip_smoke.PICK_SAMPLED == {
            "temperature": 1.0, "top_k": 50, "top_p": 0.9,
            "want_logprob": False}
        assert chip_smoke.PICK_SERVED == {
            "temperature": dsp.SERVED_SAMPLING["temperature"],
            "top_k": None, "top_p": None, "want_logprob": False}

    def test_served_sampling_is_what_the_server_sends(self, monkeypatch):
        """``DecodeServer(temperature=)`` hands ``generate_on_device`` its
        temperature and no top-k, top-p or logprob: SERVED_SAMPLING's
        settings, each at ``generate_on_device``'s default where absent."""
        import inspect

        import decode_step_profile as dsp
        from tpu_operator_libs_torch.examples.llama_serving_job import (
            DecodeServer,
        )

        calls = []

        def spy(params, prompt, config, max_new_tokens, **kw):
            calls.append(kw)
            return prompt

        spy.last_call = {"graph_launches": 0}
        defaults = inspect.signature(tdecode.generate_on_device).parameters
        monkeypatch.setattr(tdecode, "generate_on_device", spy)
        server = DecodeServer(None, {"embed": torch.zeros(1)}, None,
                              temperature=dsp.SERVED_SAMPLING["temperature"])
        server._generate(torch.zeros((1, 4), dtype=torch.long), None)
        for key, value in dsp.SERVED_SAMPLING.items():
            assert calls[0].get(key, defaults[key].default) == value, key

"""The port's KV-cache decode against the JAX package's on the CPU (int8
recipes bit for bit, cached logits, greedy tokens), and the port's own
contract: its host loop and device loop give the same tokens."""

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

#: f32 on both sides; the tolerance of tests/test_llama_decode.py:69.
TOL = 1e-4
#: A greedy token is compared across the two packages only where the
#: top-2 logit gap exceeds this: the logits agree to ~1e-5, so a larger
#: gap cannot flip, and a smaller one is a near-tie, not a port fault.
MIN_TOP2_GAP = 1e-3

JCFG = jllama.LlamaConfig()
TCFG = tllama.LlamaConfig()


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_llama_params(one_device_mesh(), JCFG)
    return jp, params_from_jax(jp, device="cpu")


def tokens(seed, batch, seq):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab, (batch, seq)).astype(np.int32)


class TestInt8Recipes:
    @pytest.mark.parametrize("axis", [0, 1, -1])
    def test_sym_int8_bit_equal_to_jax(self, axis):
        rng = np.random.default_rng(10)
        x = (rng.standard_normal((6, 5, 16)) * 3.0).astype(np.float32)
        x[2] = 0.0  # all-zero slices hit the 1e-8 floor
        x[3, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # ties round half to even
        jq, js = jdecode._sym_int8(jnp.asarray(x), axis)
        tq, ts = tdecode._sym_int8(torch.from_numpy(x), axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_quantize_params_int8_leaves_equal(self, weights):
        jp, tp = weights
        jq = jdecode.quantize_params_int8(jp)
        tq = tdecode.quantize_params_int8(tp)
        jleaves, jtree = jax.tree_util.tree_flatten(jq)
        tleaves, ttree = jax.tree_util.tree_flatten(tq)
        assert jtree == ttree
        for a, b in zip(jleaves, tleaves):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    def test_quantized_cache_buffers(self):
        cache = tdecode.init_kv_cache(TCFG, 2, 8, torch.bfloat16,
                                      quantize_kv=True, device="cpu")
        assert len(cache) == TCFG.n_layers
        for entry in cache:
            assert entry["k"].dtype == entry["v"].dtype == torch.int8
            assert entry["k_s"].shape == (2, 8, TCFG.n_kv_heads)
        ptrs = [t.data_ptr() for e in cache for t in e.values()]
        assert len(ptrs) == len(set(ptrs))  # one fresh buffer per leaf


def test_stepwise_cache_matches_jax_batch_forward(weights):
    jp, tp = weights
    toks = tokens(11, 2, JCFG.seq_len)
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), JCFG))
    batch, seq = toks.shape
    cache = tdecode.init_kv_cache(TCFG, batch, seq, device="cpu")
    outs = []
    for pos in range(seq):
        logits, returned = tdecode.forward_with_cache(
            tp, torch.from_numpy(toks[:, pos:pos + 1]), cache, pos, TCFG)
        assert returned is cache  # written in place
        outs.append(logits[:, 0].numpy())
    np.testing.assert_allclose(np.stack(outs, axis=1), want, rtol=TOL,
                               atol=TOL)


def test_chunked_prefill_then_steps_match_port_batch_forward(weights):
    _, tp = weights
    toks = torch.from_numpy(tokens(12, 2, 16))
    full = tllama.forward(tp, toks, TCFG)
    cache = tdecode.init_kv_cache(TCFG, 2, 16, device="cpu")
    logits, cache = tdecode.forward_with_cache(tp, toks[:, :8], cache, 0,
                                               TCFG)
    torch.testing.assert_close(logits, full[:, :8], rtol=TOL, atol=TOL)
    for pos in range(8, 16):
        logits, cache = tdecode.forward_with_cache(
            tp, toks[:, pos:pos + 1], cache, pos, TCFG)
        torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=TOL,
                                   atol=TOL)


def _cached_logits(params, seq, prompt_len, quantize_kv):
    """Logits at every generated position, computed as generate does."""
    seq = torch.as_tensor(seq)
    cache = tdecode.init_kv_cache(TCFG, seq.shape[0], seq.shape[1],
                                  quantize_kv=quantize_kv, device="cpu")
    logits, cache = tdecode.forward_with_cache(params, seq[:, :prompt_len],
                                               cache, 0, TCFG)
    out = [logits[:, -1]]
    for pos in range(prompt_len, seq.shape[1] - 1):
        logits, cache = tdecode.forward_with_cache(
            params, seq[:, pos:pos + 1], cache, pos, TCFG)
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("int8", [False, True],
                         ids=["f32", "int8_weights_int8_kv"])
def test_greedy_tokens_equal_jax(weights, int8):
    jp, tp = weights
    if int8:
        jp, tp = (jdecode.quantize_params_int8(jp),
                  tdecode.quantize_params_int8(tp))
    prompt = tokens(13, 2, 8)
    want = np.asarray(jdecode.generate(jp, jnp.asarray(prompt), JCFG,
                                       one_device_mesh(), 6,
                                       quantize_kv=int8))
    got = tdecode.generate(tp, prompt, TCFG, 6, quantize_kv=int8)
    top2 = torch.topk(_cached_logits(tp, got, 8, int8), 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).min().item()
    assert gap > MIN_TOP2_GAP, f"near-tie: top-2 gap {gap}"
    np.testing.assert_array_equal(got.numpy(), want)


class TestHostLoopEqualsDeviceLoop:
    @pytest.mark.parametrize("dtype,int8_weights,quantize_kv", [
        (torch.bfloat16, False, False),
        (torch.float32, True, False),
        (torch.float32, False, True),
        (torch.bfloat16, True, True),
    ])
    def test_greedy(self, dtype, int8_weights, quantize_kv):
        params = tllama.init_llama_params(TCFG, param_dtype=dtype, seed=4,
                                          device="cpu")
        if int8_weights:
            params = tdecode.quantize_params_int8(params)
        prompt = tokens(14, 3, 5)
        kw = {"param_dtype": dtype, "quantize_kv": quantize_kv}
        host = tdecode.generate(params, prompt, TCFG, 6, **kw)
        dev = tdecode.generate_on_device(params, prompt, TCFG, 6, **kw)
        assert dev.shape == (3, 11)
        assert torch.equal(host, dev)
        assert ((dev >= 0) & (dev < TCFG.vocab)).all()

    def test_eos_pads_and_loops_agree(self, weights):
        _, tp = weights
        prompt = tokens(15, 2, 4)
        free = tdecode.generate(tp, prompt, TCFG, 6)
        eos = int(free[0, 4 + 1])
        host = tdecode.generate(tp, prompt, TCFG, 6, eos_id=eos)
        dev = tdecode.generate_on_device(tp, prompt, TCFG, 6, eos_id=eos)
        assert torch.equal(host, dev)
        assert (host[0, 4 + 1:] == eos).all()
        # rows are independent: the expected output follows from the
        # unconstrained run
        expect = free.clone()
        for b in range(2):
            hits = torch.nonzero(free[b, 4:] == eos)
            if len(hits):
                expect[b, 4 + int(hits[0]):] = eos
        assert torch.equal(host, expect)

    def test_all_rows_done_stops_the_host_loop(self, weights):
        _, tp = weights
        prompt = tokens(16, 1, 4)
        first = int(tdecode.generate(tp, prompt, TCFG, 1)[0, 4])
        host = tdecode.generate(tp, prompt, TCFG, 5, eos_id=first)
        dev = tdecode.generate_on_device(tp, prompt, TCFG, 5, eos_id=first)
        assert (host[0, 4:] == first).all()
        assert torch.equal(host, dev)

    @pytest.mark.parametrize("chunk", [3, 64])
    def test_prefill_chunk(self, weights, chunk):
        _, tp = weights
        prompt = tokens(17, 2, 10)
        base = tdecode.generate(tp, prompt, TCFG, 4)
        host = tdecode.generate(tp, prompt, TCFG, 4, prefill_chunk=chunk)
        dev = tdecode.generate_on_device(tp, prompt, TCFG, 4,
                                         prefill_chunk=chunk)
        assert torch.equal(base, host) and torch.equal(host, dev)

    @pytest.mark.parametrize("top_k,top_p", [(4, None), (None, 0.5),
                                             (5, 0.7)])
    def test_sampled_draws_pinned(self, weights, top_k, top_p):
        _, tp = weights
        prompt = tokens(18, 3, 4)
        kw = {"temperature": 0.9, "top_k": top_k, "top_p": top_p,
              "return_logprobs": True}
        ht, hl = tdecode.generate(
            tp, prompt, TCFG, 6,
            generator=torch.Generator().manual_seed(5), **kw)
        dt, dl = tdecode.generate_on_device(
            tp, prompt, TCFG, 6,
            generator=torch.Generator().manual_seed(5), **kw)
        assert torch.equal(ht, dt)
        torch.testing.assert_close(hl, dl, rtol=0, atol=0)
        again = tdecode.generate(
            tp, prompt, TCFG, 6,
            generator=torch.Generator().manual_seed(5), **kw)[0]
        assert torch.equal(again, ht)

    def test_top_k_samples_stay_in_the_top_k(self, weights):
        _, tp = weights
        prompt = tokens(19, 3, 4)
        out = tdecode.generate_on_device(
            tp, prompt, TCFG, 4, temperature=1.0, top_k=3,
            generator=torch.Generator().manual_seed(6))
        for step in range(4):
            logits = tllama.forward(tp, out[:, :4 + step], TCFG)[:, -1]
            top = torch.topk(logits, 3, dim=-1).indices
            assert (top == out[:, 4 + step, None]).any(dim=-1).all()


class TestPositionOnTheDevice:
    """``forward_with_cache`` with its position as a 0-d device tensor
    (what the captured step advances in place) against the int one."""

    @pytest.mark.parametrize("t_new", [1, 3], ids=["step", "block"])
    @pytest.mark.parametrize("dtype,int8_weights,quantize_kv", [
        (torch.bfloat16, False, False),
        (torch.bfloat16, True, True),
        (torch.float32, False, True),
    ], ids=["bf16", "bf16_int8_weights_int8_kv", "f32_int8_kv"])
    def test_tensor_start_pos_bit_equal_to_int(self, dtype, int8_weights,
                                                quantize_kv, t_new):
        params = tllama.init_llama_params(TCFG, param_dtype=dtype, seed=8,
                                          device="cpu")
        if int8_weights:
            params = tdecode.quantize_params_int8(params)
        toks = torch.from_numpy(tokens(23, 2, 12)).long()
        caches = [tdecode.init_kv_cache(TCFG, 2, 12, dtype,
                                        quantize_kv=quantize_kv,
                                        device="cpu") for _ in range(2)]
        for cache in caches:
            tdecode.forward_with_cache(params, toks[:, :5], cache, 0, TCFG)
        block = toks[:, 5:5 + t_new]
        at_int, _ = tdecode.forward_with_cache(params, block, caches[0], 5,
                                               TCFG)
        pos = torch.tensor(5, dtype=torch.long)
        at_tensor, _ = tdecode.forward_with_cache(params, block, caches[1],
                                                  pos, TCFG)
        assert int(pos) == 5  # read, not advanced
        assert torch.equal(at_int, at_tensor)
        for a, b in zip(*caches):
            assert a.keys() == b.keys()
            for name in a:
                assert torch.equal(a[name], b[name]), name
        # the block landed at positions 5 .. 5 + t_new - 1 and nowhere else
        k = caches[1][0]["k"]
        assert (k[:, 5:5 + t_new] != 0).any()
        assert not (k[:, 5 + t_new:] != 0).any()


class TestDecodeStep:
    """The device loop's step on preallocated buffers, looped on the CPU
    (the card replays it from a graph: ``tests/test_torch_gpu.py``)."""

    def test_step_writes_at_the_device_position_and_advances_it(
            self, weights):
        _, tp = weights
        prompt = torch.from_numpy(tokens(24, 2, 4)).long()
        cache = tdecode.init_kv_cache(TCFG, 2, 7, device="cpu")
        logits, cache = tdecode.forward_with_cache(tp, prompt, cache, 0,
                                                   TCFG)
        last = logits[:, -1].argmax(-1)[:, None]
        out = torch.full((2, 7), -1, dtype=torch.long)
        out[:, :4], out[:, 4] = prompt, last[:, 0]
        state = tdecode._DecodeState(
            last=last.clone(), pos=torch.tensor(4), done=None, out=out,
            logprobs=None, cache=cache)

        def pick(logits):
            return tdecode._pick_next(logits[:, -1], 0.0, None, None)

        for step in range(2):
            tdecode._decode_step(state, tp, TCFG, None, pick, None, 4)
            assert int(state.pos) == 5 + step
            assert torch.equal(state.out[:, 5 + step], state.last[:, 0])
        assert (out[:, :7] >= 0).all()  # every column written once
        assert torch.equal(out, tdecode.generate(tp, prompt, TCFG, 3))

    @pytest.mark.parametrize("case", ["greedy_bf16",
                                      "greedy_int8_weights_int8_kv",
                                      "sampled_int8_eos_logprobs"])
    def test_looped_step_equals_host_loop(self, case):
        int8 = "int8" in case
        dtype = torch.bfloat16 if case == "greedy_bf16" else torch.float32
        params = tllama.init_llama_params(TCFG, param_dtype=dtype, seed=9,
                                          device="cpu")
        if int8:
            params = tdecode.quantize_params_int8(params)
        prompt = tokens(25, 3, 5)
        kw = {"param_dtype": dtype, "quantize_kv": int8}
        if case.startswith("sampled"):
            kw.update(temperature=1.0, top_k=6, top_p=0.8,
                      return_logprobs=True)
            free, _ = tdecode.generate(
                params, prompt, TCFG, 7,
                generator=torch.Generator().manual_seed(3), **kw)
            kw["eos_id"] = int(free[0, 5 + 2])

        def run(fn):
            gen = (torch.Generator().manual_seed(3)
                   if "temperature" in kw else None)
            return fn(params, prompt, TCFG, 7, generator=gen, **kw)

        host, dev = run(tdecode.generate), run(tdecode.generate_on_device)
        assert tdecode.generate_on_device.last_call == {
            "eager_steps": 6, "graph_launches": 0, "capture_ms": 0.0}
        if "return_logprobs" in kw:
            (host, host_lp), (dev, dev_lp) = host, dev
            assert torch.equal(host_lp, dev_lp)
            assert (dev[0, 5 + 2:] == kw["eos_id"]).all()
            assert (dev_lp[0, 3:] == 0.0).all()
        assert torch.equal(host, dev)


def test_greedy_logprobs_match_batch_forward(weights):
    _, tp = weights
    prompt = tokens(20, 2, 4)
    toks, lps = tdecode.generate_on_device(tp, prompt, TCFG, 4,
                                           return_logprobs=True)
    assert lps.shape == (2, 4)
    for step in range(4):
        logits = tllama.forward(tp, toks[:, :4 + step], TCFG)[:, -1]
        ref = torch.log_softmax(logits.double(), dim=-1)
        want = ref.gather(-1, toks[:, 4 + step, None])[:, 0]
        torch.testing.assert_close(lps[:, step].double(), want, rtol=0,
                                   atol=TOL)


class TestArgumentChecks:
    def test_sampling_needs_a_generator(self, weights):
        _, tp = weights
        with pytest.raises(ValueError, match="Generator"):
            tdecode.generate_on_device(tp, tokens(21, 1, 4), TCFG, 2,
                                       temperature=0.8)

    @pytest.mark.parametrize("kw", [{"top_p": 1.5}, {"prefill_chunk": 0},
                                    {"max_new_tokens": 0}])
    def test_invalid_arguments_rejected_by_both_loops(self, weights, kw):
        _, tp = weights
        kw = {"max_new_tokens": 2, **kw}
        for fn in (tdecode.generate, tdecode.generate_on_device):
            with pytest.raises(ValueError):
                fn(tp, tokens(22, 1, 4), TCFG, temperature=0.8,
                   generator=torch.Generator().manual_seed(0), **kw)

    def test_cache_requires_the_einsum_path(self, weights):
        _, tp = weights
        cfg = tllama.LlamaConfig(attention_impl="flash")
        cache = tdecode.init_kv_cache(cfg, 1, 4, device="cpu")
        with pytest.raises(ValueError, match="xla"):
            tdecode.forward_with_cache(
                tp, torch.zeros((1, 1), dtype=torch.long), cache, 0, cfg)

"""The float32 reference against the port's CPU path, at small sizes and
in float32, where the two must agree to rounding: the batch forward, the
int8 weights and cache as the configuration states them, the served
model's logits through the cache, the greedy pick, and the training
step's loss, first gradient and change."""

import time

import pytest
import torch

from port_bench import harness, run, weights
from port_bench.reference import llama_f32
from tpu_operator_libs_torch.examples import llama, llama_decode
from tpu_operator_libs_torch.examples.llama import LlamaConfig
from tpu_operator_libs_torch.kernels.kv_append import _quantize_kv_block

SMALL = LlamaConfig(vocab=97, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=96, seq_len=24, rope_theta=1e6)
EPS = 1e-5
SEED = 2147483771


def params(c=SMALL, dtype=torch.float32):
    return weights.make_params(c, SEED, "cpu", dtype)


def tokens(rows, seq, vocab=SMALL.vocab, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (rows, seq), generator=g)


def reference_logits(p, toks, c, **kw):
    h = p["embed"][toks].float()
    for layer in p["layers"]:
        h = llama_f32.layer_forward(h, {k: v.float() for k, v in
                                        layer.items()}, c, EPS, **kw)
    h = llama_f32.rms_norm(h, p["final_norm"].float(), EPS)
    return h @ p["lm_head"].float()


def test_the_block_matches_the_ports_forward():
    p, toks = params(), tokens(3, SMALL.seq_len)
    ours = llama.forward(p, toks, SMALL)
    ref = reference_logits(p, toks, SMALL)
    torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-5)


def test_int8_weights_are_the_ports():
    w = params()["layers"][0]["w_gate"]
    q = llama_decode.quantize_params_int8(params())["layers"][0]["w_gate"]
    ours = q["q"].float() * q["s"]
    torch.testing.assert_close(llama_f32.dequantized_weight(w, 8), ours,
                               rtol=0, atol=0)


def test_int8_cache_rows_are_the_ports():
    g = torch.Generator().manual_seed(1)
    k = torch.randn(2, 5, 3, 16, generator=g)
    codes, scales = _quantize_kv_block(k)
    torch.testing.assert_close(llama_f32.quantize_sym(k, -1, 8),
                               codes.float() * scales[..., None],
                               rtol=0, atol=0)


def test_served_logits_match_the_ports_cached_forward():
    c = SMALL
    p = llama_decode.quantize_params_int8(params())
    toks = tokens(2, 11)
    cache = llama_decode.init_kv_cache(c, 2, 11, quantize_kv=True,
                                       device="cpu")
    ours, _ = llama_decode.forward_with_cache(p, toks[:, :7], cache, 0, c)
    steps = [ours[:, -1]]
    for pos in range(7, 10):
        out, _ = llama_decode.forward_with_cache(p, toks[:, pos:pos + 1],
                                                 cache, pos, c)
        steps.append(out[:, -1])
    ours = torch.stack(steps, dim=1)
    raw = params()
    ref = llama_f32.served_logits(
        c, EPS, toks, 6, lambda i: raw["layers"][i],
        {k: raw[k] for k in ("embed", "final_norm", "lm_head")}, bits=8)
    torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4)


def test_a_greedy_token_has_no_gap_and_another_has_one():
    logits = torch.tensor([[0.5, 2.0, -1.0], [3.0, 1.0, 2.5]])
    best = logits.argmax(-1)
    assert llama_f32.token_gaps(logits, best).tolist() == [0.0, 0.0]
    assert llama_f32.token_gaps(logits, torch.tensor([0, 2])).tolist() == \
        [1.5, 0.5]


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_the_reference_draws_the_ports_noise(temperature):
    """A request's pick, drawn by the port from a generator seeded with
    the request's seed, is the argmax of the reference's scores with the
    noise the reference draws from that seed: no gap."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 4, 50, generator=g)  # rows, new tokens, vocab
    gen = torch.Generator().manual_seed(SEED)
    served = torch.stack([
        llama_decode._pick_next(logits[:, i], temperature, None, gen)[0][:, 0]
        for i in range(4)], dim=1)
    noise = llama_f32.pick_noise(SEED, 3, 50, 4, "cpu", temperature)
    assert (noise is None) == (temperature == 0.0)
    scores = llama_f32.pick_scores(logits, noise, temperature)
    assert torch.equal(scores.argmax(-1), served)
    assert llama_f32.token_gaps(scores, served).max().item() == 0.0


@pytest.mark.parametrize("bits,lo,hi", [(8, 1e-3, 2e-2), (4, 2e-2, 0.3)])
def test_quantization_error_scales_with_the_grid(bits, lo, hi):
    g = torch.Generator().manual_seed(2)
    w = torch.randn(256, 64, generator=g)
    err = (llama_f32.dequantized_weight(w, bits) - w).norm() / w.norm()
    assert lo < err < hi


def test_the_training_step_matches_the_ports_in_float32():
    ctx = run.context("train.mistral7b-stage8.s4096", SEED, 1.0, False,
                      "cpu", time.perf_counter())
    model = {**ctx.config["model"], "vocab": 97, "d_model": 64,
             "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
             "seq_len": 24}
    ctx.config = {**ctx.config, "model": model,
                  "precision": {**ctx.config["precision"],
                                "params": "float32"}}
    ctx.model = harness.llama_config(ctx.config)
    ctx.traffic = {**ctx.traffic, "batch": 3, "seq_len": 24}
    driver = harness.load_module("drivers", "train")
    step, state = driver.build(ctx)
    _, program = driver.program_readings(ctx, step, state, 3)
    reference = driver.reference_readings(ctx, 3)
    gaps = llama_f32.train_gaps(program, reference)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4
    assert len(program["first_grad"]) == 3 + 2 * 9

"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the look for a card skipped, the rest of the run as
it is): a sound run is correct; a run whose timed path is broken
underneath is not, for each fault a cell can have; and the control, the
reference one precision step below the configuration, fails the cell's
limits."""

import time

import numpy as np
import pytest
import torch

from port_bench import calibrate, harness, run
from port_bench.reference import llama_f32
from tpu_operator_libs_torch.examples import llama, llama_decode
from tpu_operator_libs_torch.examples.llama_serving_job import DecodeServer

TRAIN = "train.mistral7b-stage8.s4096"
SERVE = "serve.ds7b-w8kv8.chat"
SMALL = {"vocab": 256, "d_model": 128, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 256, "seq_len": 64}


def small_context(cell: str, seed: int = 2147483999, dtype="float32"):
    """The cell's context at a small size on the CPU, in ``dtype``."""
    ctx = run.context(cell, seed, 1.0, False, "cpu", time.perf_counter())
    model = {**ctx.config["model"], **SMALL}
    if ctx.config["model"]["n_kv_heads"] == ctx.config["model"]["n_heads"]:
        model["n_kv_heads"] = model["n_heads"]
    ctx.config = {**ctx.config, "model": model,
                  "precision": {**ctx.config["precision"], "params": dtype}}
    ctx.model = harness.llama_config(ctx.config)
    if ctx.cell["driver"] == "train":
        ctx.traffic = {**ctx.traffic, "batch": 4, "seq_len": 64}
    else:
        ctx.traffic = {**ctx.traffic, "rows": 4, "prompt_lengths": [8, 16],
                       "new_tokens": 8}
    return ctx


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_a_sound_run_is_correct(cell):
    line = run.result(small_context(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


def unchanged_state(monkeypatch):
    make = llama.make_train_step

    def broken(config, **kw):
        optimizer, step = make(config, **kw)

        def same(state, tokens):
            _, loss = step(state, tokens)
            return state, loss
        return optimizer, same
    monkeypatch.setattr(llama, "make_train_step", broken)


def half_batch(monkeypatch):
    make = llama.make_train_step

    def broken(config, **kw):
        optimizer, step = make(config, **kw)
        return optimizer, lambda state, tokens: step(
            state, tokens[: tokens.shape[0] // 2])
    monkeypatch.setattr(llama, "make_train_step", broken)


def altered_token(monkeypatch):
    pick = llama_decode._pick_next

    def broken(logits_last, *args, **kwargs):
        choice, lp = pick(logits_last, *args, **kwargs)
        choice = choice.clone()
        choice[0] = (choice[0] + 1) % logits_last.shape[-1]
        return choice, lp
    monkeypatch.setattr(llama_decode, "_pick_next", broken)


def other_noise(monkeypatch):
    """Each request sampled from the next seed's noise, not its own."""
    handle = DecodeServer.handle

    def broken(self, prompt, generator=None, seed=None):
        return handle(self, prompt, seed=seed + 1)
    monkeypatch.setattr(DecodeServer, "handle", broken)


def half_rows(monkeypatch):
    generate = llama_decode.generate_on_device

    def broken(params, prompt, *args, **kwargs):
        half = prompt.shape[0] // 2
        out = generate(params, prompt[:half], *args, **kwargs)
        broken.last_call = generate.last_call
        return torch.cat([out, out], dim=0)
    monkeypatch.setattr(llama_decode, "generate_on_device", broken)


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, unchanged_state), (TRAIN, half_batch),
    (SERVE, altered_token), (SERVE, other_noise), (SERVE, half_rows)],
    ids=["train-unchanged_state", "train-half_batch",
         "serve-altered_token", "serve-other_noise", "serve-half_rows"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run.result(small_context(cell))
    assert not line["correct"], line["checks"]


def test_the_training_control_fails_the_limits():
    ctx = small_context(TRAIN)
    driver = harness.load_module("drivers", "train")
    steps = ctx.cell["check_steps"]
    reference = driver.reference_readings(ctx, steps)
    low = driver.reference_readings(ctx, steps, matmul=llama_f32.fp8_matmul)
    checks = ctx.checks(llama_f32.train_gaps(low, reference))
    assert not harness.correct(checks), checks


def test_the_serving_control_fails_the_limit():
    ctx = small_context(SERVE)
    driver = harness.load_module("drivers", "serve_closed")
    out = calibrate.serve_seed(ctx, driver, True, False)["program"]
    assert out["control_gap"] > ctx.limits["logit_gap"], out


def test_the_fp8_matmul_rounds_and_its_gradient_flows():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 8, generator=g, requires_grad=True)
    y = llama_f32.fp8_matmul(x, w)
    assert not torch.equal(y, x @ w)
    assert torch.allclose(y, x @ w, rtol=0.2, atol=0.5)
    y.sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert np.isfinite(x.grad.numpy()).all()


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_a_traced_run_reads_its_stretch_and_stays_correct(cell):
    ctx = small_context(cell)
    ctx.trace = True
    ctx.seconds = 3.0
    ctx.traffic = {**ctx.traffic, "trace_after": 1, "trace_steps": 1,
                   "trace_requests": 2}
    line = run.result(ctx)
    assert line["correct"], line["checks"]
    # on the CPU no device operation is recorded: the device readers
    # leave their metrics out, the counters' readers still read
    assert "window_s" in line["device"] and line["device"]["busy_s"] == 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name in line["metrics"]:
        assert name in ("server_ms_p50.latency", "capture_ms.decode",
                        "mfu.train", "mfu.decode")


def test_a_pod_that_bypasses_the_wrapper_stops_the_run(monkeypatch):
    """Where ``DecodeServer`` no longer looks ``generate_on_device`` up in
    its module at each call, the harness's span and counters would read
    nothing: the run stops after the warm-up instead."""
    bound = llama_decode.generate_on_device

    def generate(self, prompt, generator):
        return bound(self.params, prompt, self.config, self.max_new_tokens,
                     temperature=self.temperature, generator=generator,
                     quantize_kv=self.quantize_kv)
    monkeypatch.setattr(DecodeServer, "_generate", generate)
    with pytest.raises(RuntimeError, match="generate_on_device"):
        run.result(small_context(SERVE))

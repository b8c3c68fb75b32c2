"""The tensor-parallel pod's cell (``serve.yi34b-bf16-tp4.chat``): its
configuration against its published keys, its cell file, the bf16
products' bounds at the cell's shard shapes by hand, the four readers
on synthetic stretches (NCCL by name, nothing to read gives None, the
collectives' count from the program's counters), the reference's
imports, and whole runs of its driver at a tiny size on four gloo ranks
of the CPU: a sound run is correct, an altered token is not, and the
controls (an int4 cache, int4 weights) lie over the cell's limit."""

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness, program_spans, rooflines, rooflines_tp, \
    run, trace
from tpu_operator_libs_torch.examples import llama_decode

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "serve.yi34b-bf16-tp4.chat"
CONFIG = "yi-34b.bf16kv8.tp4"
READERS = ("collective_share.pod", "collective_us.pod",
           "bf16_matmul_roofline.pod", "idle_share.pod")
YI = harness.llama_config(harness.load_json("configs", CONFIG))


def test_the_configuration_is_the_published_model_uncut():
    data = harness.load_json("configs", CONFIG)
    published, model = data["published"], data["model"]
    assert data["reduced"] == {}
    assert model["vocab"] == published["vocab_size"] == 64000
    assert model["d_model"] == published["hidden_size"] == 7168
    assert model["n_layers"] == published["num_hidden_layers"] == 60
    assert model["n_heads"] == published["num_attention_heads"] == 56
    assert model["n_kv_heads"] == published["num_key_value_heads"] == 8
    assert model["d_ff"] == published["intermediate_size"] == 20480
    assert model["seq_len"] == published["max_position_embeddings"]
    assert model["rope_theta"] == published["rope_theta"] == 5e6
    assert not published["tie_word_embeddings"]
    assert data["precision"]["weights"] == "bfloat16"
    assert data["precision"]["kv_cache"] == "int8"
    YI.validate_for(4)
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and entry["source"] == data["source"]


def test_the_cell_runs_on_four_chips_over_an_existing_traffic_mix():
    data = harness.load_json("workloads", CELL)
    entry = next(c for c in BENCH["workloads"] if c["name"] == CELL)
    assert data["chips"] == entry["chips"] == 4
    assert data["config"] == entry["config"] == CONFIG
    assert data["traffic"] == entry["traffic"] == "chat"
    assert (ROOT / "port_bench" / "traffic" / "chat.json").is_file()
    assert data["why"] == entry["why"] and len(data["why"]) <= 200
    harness.load_module("drivers", data["driver"])


def test_at_most_one_cell_asks_for_four_chips():
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= 1
    for m in BENCH["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL]
    for m in BENCH["end_to_end"]:
        if m["name"] in ("decode_tokens_per_s", "request_p90_ms"):
            assert CELL in m["workloads"]


def test_the_shard_shapes_and_bytes_of_a_rank():
    # 14 query heads and 2 KV heads of 128, 5,120 FFN columns, 16,000 of
    # the head's
    assert rooflines_tp.shard_matmuls(YI, 4) == [
        (7168, 1792), (7168, 256), (7168, 256), (1792, 7168),
        (7168, 5120), (7168, 5120), (5120, 7168)]
    per_layer = (7168 * 1792 * 2 + 7168 * 256 * 2 + 7168 * 5120 * 3)
    assert per_layer == 139_460_608
    assert rooflines_tp.shard_weight_bytes(YI, 4) == \
        2 * (60 * per_layer + 7168 * 16000)  # 16.96 GB


def test_the_decode_steps_bound_by_hand():
    # 16 rows: bytes bound; weights, inputs and outputs in bf16
    per_layer = 139_460_608
    ks = 7168 * 3 + 1792 + 7168 * 2 + 5120  # the inputs' widths
    ns = 1792 + 256 * 2 + 7168 + 5120 * 2 + 7168  # the outputs'
    nbytes = 2 * (60 * per_layer + 7168 * 16000
                  + 60 * 16 * (ks + ns) + 16 * (7168 + 16000))
    flops = 2 * 16 * (60 * per_layer + 7168 * 16000)
    want = max(flops / 989e12, nbytes / 3.35e12)
    # 5.06 ms of weight blocks, 0.04 ms of inputs and outputs
    assert want == pytest.approx(nbytes / 3.35e12)
    assert 5.1e-3 < want < 5.11e-3
    assert rooflines_tp.forward_bf16_bound_s(YI, 4, 16, 16) == \
        pytest.approx(want)


def test_the_prefill_is_bound_by_its_flops_and_a_request_sums_its_calls():
    per_layer = 139_460_608
    flops = 2 * 4096 * 60 * per_layer + 2 * 16 * 7168 * 16000
    assert rooflines_tp.forward_bf16_bound_s(YI, 4, 4096, 16) == \
        pytest.approx(flops / 989e12)  # ~69 ms
    want = (rooflines_tp.forward_bf16_bound_s(YI, 4, 16 * 256, 16)
            + 31 * rooflines_tp.forward_bf16_bound_s(YI, 4, 16, 16))
    assert rooflines_tp.request_bf16_bound_s(YI, 4, 16, 256, 32) == \
        pytest.approx(want)
    assert rooflines.forward_calls(YI, 16, 256, 32)[0] == (256, 0)


# -- the readers -------------------------------------------------------------

NCCL_AR = "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)"
NCCL_AG = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)"
GEMM = "nvjet_tst_64x8_64x16_4x1_v_bz_TNT"
OPS = [("Memcpy HtoD (Pageable -> Device)", 0, 5),
       (NCCL_AR, 5, 8),  # the round's broadcast: outside the generation
       ("void at::native::vectorized_elementwise_kernel<4>(int)", 12, 14),
       (GEMM, 20, 60),
       ("void (anonymous namespace)::rms_norm_fwd_kernel<8, 2, true>()",
        60, 62),
       (NCCL_AR, 62, 72),
       ("void (anonymous namespace)::decode_attention_mma_kernel<1>()",
        72, 80),
       ("cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64", 80, 90),
       (NCCL_AG, 90, 100),
       ("void (anonymous namespace)::token_pick_wide_kernel<8, true>()",
        100, 104),
       ("Memset (Device)", 104, 105)]
GENERATION = [types.SimpleNamespace(name="decode.generate", start=10,
                                    end=110)]


def reading(ops, counts=None, requests=((16, 64),)):
    return trace.Reading(
        t0=0, t1=200, ops=ops, spans=[],
        counters={"traced_collectives": counts} if counts is not None
        else {},
        work={"requests": list(requests), "new_tokens": 32, "tp": 4},
        config=YI, traffic={})


@pytest.fixture
def generations(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda r: GENERATION)


def read(metric, r):
    return harness.load_module("metrics", metric).read(r)


def test_the_nccl_share_inside_the_generations(generations):
    # inside decode.generate: 2+40+2+10+8+10+10+4+1 = 87 ns, 20 of NCCL
    assert read("collective_share.pod", reading(OPS)) == \
        pytest.approx(100 * 20 / 87)


def test_microseconds_a_collective_from_the_programs_count(generations):
    assert read("collective_us.pod", reading(OPS, counts=[2])) == \
        pytest.approx(1e6 * 20e-9 / 2)
    assert read("collective_us.pod", reading(OPS, counts=[1, 3])) == \
        pytest.approx(1e6 * 20e-9 / 4)


def test_the_bf16_products_are_what_is_left_of_the_stretch():
    r = reading(OPS)
    bound = rooflines_tp.request_bf16_bound_s(YI, 4, 16, 64, 32)
    assert read("bf16_matmul_roofline.pod", r) == pytest.approx(
        100 * bound / 50e-9)


def test_the_pods_idle_share_is_the_decode_cells_reader():
    r = reading(OPS)
    assert read("idle_share.pod", r) == pytest.approx(
        read("idle_share.decode", r))
    assert 0 < read("idle_share.pod", r) < 100


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_with_nothing_to_read_gives_none(metric, monkeypatch):
    # an empty stretch, no generation's span, and no requests
    monkeypatch.setattr(program_spans, "records", lambda r: [])
    assert read(metric, reading([], counts=[], requests=())) is None


def test_the_nccl_readers_need_the_programs_spans_and_counters(monkeypatch):
    # a program without the recorder: no generation to read inside
    monkeypatch.setattr(program_spans, "records", lambda r: [])
    assert read("collective_share.pod", reading(OPS)) is None
    assert read("collective_us.pod", reading(OPS, counts=[2])) is None
    # a program without the counters: generations recorded, no count
    monkeypatch.setattr(program_spans, "records", lambda r: GENERATION)
    assert read("collective_us.pod", reading(OPS)) is None
    assert read("collective_us.pod", reading(OPS, counts=[None])) is None
    # no NCCL kernel: nothing to divide
    no_nccl = [op for op in OPS if "nccl" not in op[0]]
    assert read("collective_us.pod", reading(no_nccl, counts=[2])) is None
    assert read("collective_share.pod", reading(no_nccl)) == 0.0


def test_the_reference_imports_no_jax_and_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from port_bench.reference import served_grids; "
            "from port_bench import rooflines_tp; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, check=True, cwd=ROOT)
    tops = {name.split(".")[0] for name in json.loads(out.stdout)}
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpu_operator_libs",
                       "tpu_operator_libs_torch"}


# -- whole runs on four gloo ranks -------------------------------------------

SMALL = {"vocab": 512, "d_model": 448, "n_layers": 3, "n_heads": 28,
         "n_kv_heads": 4, "d_ff": 640, "seq_len": 64}


def small_context(seed: int = 2147483999):
    """The cell's context at a small Yi-shaped size on the CPU: each of
    the four ranks holds 7 query heads over one KV head, as on the
    cards. One prompt length and one request checked, so the check reads
    the window's first request whatever the window held: at this size an
    int4 cache reads 0.54-0.59 there (seeds 7, 42, 123456789012 and
    this one), the program 0-0.033; their mean gaps 0.016-0.026 and
    0-0.00044 (seeds 7, 42 and this one)."""
    ctx = run.context(CELL, seed, 1.0, False, "cpu", time.perf_counter())
    ctx.config = {**ctx.config, "model": {**ctx.config["model"], **SMALL}}
    ctx.model = harness.llama_config(ctx.config)
    ctx.traffic = {**ctx.traffic, "rows": 8, "prompt_lengths": [32],
                   "new_tokens": 16, "check_requests": 1}
    return ctx


def test_a_sound_run_is_correct():
    line = run.result(small_context())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"logit_gap", "logit_gap_mean"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"decode_tokens_per_s",
                                    "request_p90_ms", "setup_s"}
    assert line["device"]["platform"] == "cpu"


def test_an_altered_token_is_not_correct(monkeypatch):
    pick = llama_decode._pick_next

    def broken(logits_last, *args, **kwargs):
        choice, lp = pick(logits_last, *args, **kwargs)
        choice = choice.clone()
        choice[0] = (choice[0] + 1) % logits_last.shape[-1]
        return choice, lp

    monkeypatch.setattr(llama_decode, "_pick_next", broken)
    line = run.result(small_context())
    assert not line["correct"], line["checks"]


def test_the_mean_gap_counts_every_served_token(monkeypatch):
    """A token's gap is 0 where its pick stands: the mean is the widest
    gap over the served tokens where one token alone is off."""
    ctx = small_context()
    driver = harness.load_module("drivers", "serve_closed_tp")
    rows, new = ctx.traffic["rows"], ctx.traffic["new_tokens"]
    one = torch.zeros(rows, new)
    one[1, 2] = 0.5
    monkeypatch.setattr(driver.llama_f32, "token_gaps",
                        lambda ref, chosen: one)
    monkeypatch.setattr(driver, "served_grids", types.SimpleNamespace(
        served_logits=lambda *a, **k: torch.zeros(rows, new, 1)))
    sample = [{"prompt": np.zeros((rows, 32), np.int64), "length": 32,
               "seed": 5, "tokens": np.zeros((rows, 32 + new), np.int64)}]
    gaps = driver.logit_gaps(ctx, sample)
    assert gaps["logit_gap"] == 0.5
    assert gaps["logit_gap_mean"] == pytest.approx(0.5 / (rows * new))
    assert gaps["served_tokens"] == rows * new
    missing = driver.logit_gaps(ctx, [{**sample[0], "tokens": None}])
    assert missing["logit_gap"] == missing["logit_gap_mean"] == float("inf")


def test_each_rank_runs_on_its_own_share_of_the_cores():
    from port_bench import tp_ranks

    shares = tp_ranks.core_shares(4)
    assert len(shares) == 4 and len({len(s) for s in shares}) == 1
    flat = [c for s in shares for c in s]
    assert len(flat) == len(set(flat))
    assert set(flat) <= os.sched_getaffinity(0)


def test_rank_zero_gives_its_cores_back_after_a_run():
    cores, threads = os.sched_getaffinity(0), torch.get_num_threads()
    run.result(small_context())
    assert os.sched_getaffinity(0) == cores
    assert torch.get_num_threads() == threads


def test_the_controls_lie_over_the_limit():
    ctx = small_context()
    driver = harness.load_module("drivers", "serve_closed_tp")
    out = driver.run(ctx, controls=True)
    gaps = out["gaps"]
    for check, limit in ctx.limits.items():
        assert gaps[check] <= limit, (check, gaps)
        # each of these fails both checks, the widest gap and the mean
        for name in ("int4_cache_gap", "int4_weights_gap",
                     "altered_token_gap", "other_noise_gap"):
            name = name + check[len("logit_gap"):]
            assert gaps[name] > limit, (name, gaps)
    # every follower took every round: the warm-up's, the window's and
    # the two faults' over the sample
    rounds = len(ctx.traffic["prompt_lengths"]) + out["attempted"] \
        + 2 * len(out["sample"])
    assert out["followers"] == [rounds] * 3

"""Operation and byte counts against hand counts at one toy shape, and
each per-layer reader on a synthetic stretch of profiler events,
including patterns that match nothing (the reader gives None, never 0)."""

import pytest

from port_bench import harness, rooflines, trace
from tpu_operator_libs_torch.examples.llama import LlamaConfig

#: vocab 10, d 8, 1 layer, 2 heads of 4 over 1 KV head, FFN 12
TOY = LlamaConfig(vocab=10, d_model=8, n_layers=1, n_heads=2, n_kv_heads=1,
                  d_ff=12, seq_len=4)


def test_matmul_params_by_hand():
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8, gate/up 8x12, down 12x8, head 8x10
    assert rooflines.matmul_params(TOY) == 64 + 32 + 32 + 64 + 3 * 96 + 80


def test_train_step_flops_by_hand():
    # 6 * 560 params * 2 * 4 tokens, attention 4*B*H*D*pairs = 4*2*2*4*10
    # three times over
    assert rooflines.train_step_flops(TOY, 2, 4) == 6 * 560 * 8 + 3 * 640


def test_visible_pairs_by_hand():
    assert rooflines.visible_pairs(4, 4) == 10
    assert rooflines.visible_pairs(1, 9, start=5) == 6
    assert rooflines.visible_pairs(2, 9, start=5) == 6 + 7
    assert rooflines.visible_pairs(3, 5, causal=False) == 15


def test_int8_bound_by_hand():
    # M 2, K 8, N 4: codes 32 B, x 2*8*2 B, out 2*4*2 B, scales 16 B
    nbytes = 32 + 32 + 16 + 16
    assert rooflines.int8_bound_s(2, 8, 4) == pytest.approx(
        nbytes / rooflines.PEAK_BYTES)
    # compute-bound when M is large: 2*M*K*N over the bf16 peak
    m, k, n = 4096, 4096, 4096
    assert rooflines.int8_bound_s(m, k, n) == pytest.approx(
        2 * m * k * n / rooflines.PEAK_BF16_FLOPS)


def test_decode_attention_bound_by_hand():
    # B 1, one new token at position 5 of a cache of 9, 1 KV head of 4:
    # keys 0..5 (6) K and V int8 + f32 scales, q and out bf16 2 heads x 4
    nbytes = 2 * 6 * 4 + 2 * 6 * 4 + 2 * 4 * 2 * 2
    assert rooflines.decode_attention_bound_s(TOY, 1, 1, 5, 9) == \
        pytest.approx(nbytes / rooflines.PEAK_BYTES)


def test_flash_train_bound_by_hand():
    c = LlamaConfig(vocab=8, d_model=8192, n_layers=2, n_heads=64,
                    n_kv_heads=8, d_ff=8, seq_len=8192)
    pairs = 8192 * 8193 // 2
    fwd = 4 * 1 * 64 * 128 * pairs / rooflines.PEAK_BF16_FLOPS
    assert rooflines.flash_train_bound_s(c, 1, 8192) == pytest.approx(
        2 * 3.5 * fwd)


def test_request_counts_each_call_once():
    calls = rooflines.forward_calls(TOY, 2, 5, 3)
    assert calls == [(5, 0), (1, 5), (1, 6)]
    # the projections at every new token, the head at the picked one
    one = sum(rooflines.int8_bound_s(m, k, n)
              for m in (10, 2, 2)
              for k, n in rooflines.layer_matmuls(TOY))
    one += 3 * rooflines.int8_bound_s(2, 8, 10)
    assert rooflines.request_int8_bound_s(TOY, 2, 5, 3) == \
        pytest.approx(one)
    assert rooflines.request_least_s(TOY, 2, 5, 3) > 0


def reading(ops, **work):
    return trace.Reading(t0=0, t1=1_000_000_000, ops=ops,
                         spans=[("train_step", 0, 600_000_000)],
                         counters={}, work=work, config=TOY, traffic={})


OPS = [("void adamw_kernel<8>(Table)", 100, 300),
       ("void global_norm_kernel<8>(Table)", 300, 400),
       ("void flash_fwd_wgmma_kernel<128>(Params)", 500, 900),
       ("void flash_bwd_dq_wgmma_kernel<128>(Params)", 900, 1500),
       ("void int8_matmul_mma_kernel<2>(Args)", 2000, 2600),
       ("void decode_attention_mma_kernel<1>(Args)", 3000, 3100),
       ("sm90_xmma_gemm_bf16bf16", 600_000_000, 900_000_000)]


def test_busy_idle_and_breakdown():
    r = reading(OPS, steps=1, batch=2, seq=4)
    assert trace.busy_s(r) == pytest.approx((200 + 100 + 1000 + 600 + 100
                                             + 300_000_000) / 1e9)
    out = trace.breakdown(r)
    assert out["device_ops"][0][0] == "sm90_xmma_gemm_bf16bf16"
    names = dict(out["idle_gaps"])
    assert set(names) == {"train_step", "no span"}
    assert sum(names.values()) == pytest.approx(1 - trace.busy_s(r))


@pytest.mark.parametrize("metric,work,expected", [
    ("update_ms.train", {"steps": 2}, 1e3 * 300e-9 / 2),
    ("idle_share.train", {}, None),
])
def test_train_readers(metric, work, expected):
    value = harness.load_module("metrics", metric).read(reading(OPS, **work))
    if expected is not None:
        assert value == pytest.approx(expected)
    else:
        assert 0 < value < 100


def test_roofline_readers_divide_the_bound_by_the_kernels_time():
    r = reading(OPS, steps=1, batch=2, seq=4)
    att = harness.load_module("metrics", "attention_roofline.train").read(r)
    assert att == pytest.approx(
        100 * rooflines.flash_train_bound_s(TOY, 2, 4) / 1000e-9)
    r = reading(OPS, requests=[(2, 5)], new_tokens=3)
    mm = harness.load_module("metrics", "int8_matmul_roofline.decode").read(r)
    assert mm == pytest.approx(
        100 * rooflines.request_int8_bound_s(TOY, 2, 5, 3) / 600e-9)
    at = harness.load_module("metrics", "attention_roofline.decode").read(r)
    assert at == pytest.approx(
        100 * rooflines.request_attention_bound_s(TOY, 2, 5, 3) / 100e-9)
    mfu = harness.load_module("metrics", "mfu.decode").read(r)
    assert mfu == pytest.approx(
        100 * rooflines.request_least_s(TOY, 2, 5, 3) / 1.0)
    mfu = harness.load_module("metrics", "mfu.train").read(
        reading(OPS, steps=4, batch=2, seq=4))
    assert mfu == pytest.approx(100 * rooflines.train_step_flops(TOY, 2, 4)
                                / (0.25 * rooflines.PEAK_BF16_FLOPS))


@pytest.mark.parametrize("metric", [
    "update_ms.train", "attention_roofline.train",
    "int8_matmul_roofline.decode", "attention_roofline.decode", "idle_share.train", "idle_share.decode",
    "mfu.decode", "mfu.train", "server_ms_p50.latency", "capture_ms.decode"])
def test_a_reader_with_nothing_to_read_gives_none(metric):
    # no matching kernel, no requests, no steps, no counters
    r = reading([("some_other_kernel", 0, 10)])
    if metric.startswith("idle_share"):
        r = reading([])
    assert harness.load_module("metrics", metric).read(r) is None


def test_counter_readers_take_medians():
    r = reading([])
    r.counters = {"request_seconds": [0.3, 0.1, 0.2],
                  "capture_ms": [40.0, 50.0, 45.0, 47.0]}
    assert harness.load_module("metrics", "server_ms_p50.latency").read(r) \
        == pytest.approx(200.0)
    assert harness.load_module("metrics", "capture_ms.decode").read(r) \
        == pytest.approx(46.0)


def test_percentile_and_within():
    assert harness.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert trace.within(OPS, 100, 500) == OPS[:3]


def test_an_idle_gap_takes_the_innermost_span():
    spans = [("handle", 0, 100), ("generate_on_device", 10, 50),
             ("handle", 5, 200)]  # another client, waiting
    assert trace.open_span(spans, 30) == "generate_on_device"
    assert trace.open_span(spans, 70) == "handle"
    assert trace.open_span(spans, 300) == "no span"

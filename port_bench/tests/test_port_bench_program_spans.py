"""The readers of the program's spans (``program_spans`` and the four
``program_span`` metrics) on synthetic stretches: idle time given to the
innermost span open at a gap's middle and split over the traced
requests, device milliseconds of the train step's spans, None with
nothing to read (no recorder, no span of the name, no request), and a
reader's file for every ``program_span`` entry of ``BENCHMARK.json``."""

import json
import sys
import types
from pathlib import Path

import pytest

from port_bench import harness, program_spans, trace

ROOT = Path(__file__).resolve().parents[2]
CHAT_READERS = ("capture_idle_ms.decode", "dispatch_idle_ms.decode")
TRAIN_READERS = ("forward_ms.train", "backward_ms.train")


def span(name, start, end, device_ms=None):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 device_ms=device_ms)


def reading(ops, t0=0, t1=1_000, requests=2, steps=None):
    work = {"requests": [(16, 64)] * requests, "new_tokens": 32}
    if steps is not None:
        work = {"steps": steps, "batch": 8, "seq": 4096}
    return trace.Reading(t0=t0, t1=t1, ops=ops, spans=[], counters={},
                         work=work, config=None, traffic={})


def with_spans(monkeypatch, spans):
    """The recorder's ring as ``spans``, read over the stretch as
    ``tracing.records`` reads it."""
    def records(r):
        return [s for s in spans if s.end >= r.t0 and s.start <= r.t1]
    monkeypatch.setattr(program_spans, "records", records)


def read(metric, r):
    return harness.load_module("metrics", metric).read(r)


#: two requests in [0, 1000] ns; the card busy where no span idles it
TWO_REQUESTS = [
    span("serve.request", 0, 480), span("decode.generate", 10, 470),
    span("decode.cache_alloc", 10, 20), span("decode.prefill", 20, 60),
    span("decode.first_pick", 60, 70), span("decode.eager_step", 70, 90),
    span("decode.capture", 90, 150), span("decode.replay", 150, 160),
    span("decode.wait", 160, 400), span("decode.release", 400, 470),
    span("serve.request", 500, 1_000), span("decode.generate", 510, 990),
    span("decode.prefill", 510, 560), span("decode.capture", 590, 700),
]
OPS = [("k", 0, 12), ("k", 30, 95), ("k", 140, 402), ("k", 470, 520),
       ("k", 540, 600), ("k", 690, 1_000)]


def test_idle_goes_to_the_innermost_span_at_its_middle(monkeypatch):
    with_spans(monkeypatch, TWO_REQUESTS)
    r = reading(OPS)
    idle = program_spans.idle_by_span(r, program_spans.records(r))
    # gaps: 12-30 (middle 21, prefill), 95-140 (117, capture),
    # 402-470 (436, release), 520-540 (530, prefill), 600-690 (645,
    # capture)
    assert dict(idle) == pytest.approx({
        "decode.prefill": 38e-9, "decode.capture": 135e-9,
        "decode.release": 68e-9})
    assert read("capture_idle_ms.decode", r) == pytest.approx(
        1e3 * 135e-9 / 2)
    assert read("dispatch_idle_ms.decode", r) == pytest.approx(
        1e3 * 38e-9 / 2)


def test_spans_are_clipped_to_the_stretch(monkeypatch):
    # the gap 101-140 (middle 120) lies in both spans: clipped to the
    # stretch from 100 the capture is the shorter (50 against 60), though
    # it began long before
    with_spans(monkeypatch, [span("decode.capture", 0, 150),
                             span("decode.wait", 90, 160)])
    r = reading([("k", 100, 101), ("k", 140, 1_000)], t0=100)
    idle = program_spans.idle_by_span(r, program_spans.records(r))
    assert dict(idle) == pytest.approx({"decode.capture": 39e-9})


def test_a_gap_outside_every_span_is_no_span(monkeypatch):
    with_spans(monkeypatch, [span("decode.capture", 0, 10)])
    r = reading([("k", 0, 10), ("k", 50, 1_000)])
    idle = program_spans.idle_by_span(r, program_spans.records(r))
    assert dict(idle) == pytest.approx({"no span": 40e-9})
    assert read("capture_idle_ms.decode", r) == 0.0


def test_train_readers_take_the_mean_of_the_stretch_steps(monkeypatch):
    with_spans(monkeypatch, [
        span("train.forward", -50, -10, 999.0),  # before the stretch
        span("train.forward", 0, 10, 240.0),
        span("train.backward", 10, 20, 470.0),
        span("train.forward", 30, 40, 260.0),
        span("train.backward", 40, 50, 490.0),
        span("train.forward", 60, 70, None),  # its events not complete
        span("train.forward", 1_001, 1_010, 999.0),  # after it
    ])
    r = reading([("k", 0, 1_000)], steps=2)
    assert read("forward_ms.train", r) == pytest.approx(250.0)
    assert read("backward_ms.train", r) == pytest.approx(480.0)


@pytest.mark.parametrize("metric", CHAT_READERS + TRAIN_READERS)
def test_nothing_to_read_gives_none(metric, monkeypatch):
    # a ring without a span of the reader's names in the stretch
    with_spans(monkeypatch, [span("serve.admit", 0, 10),
                             span("train.update", 20, 30, 16.0),
                             span("decode.capture", 2_000, 2_100),
                             span("train.forward", 2_000, 2_100, 250.0),
                             span("train.backward", 2_000, 2_100, 470.0)])
    assert read(metric, reading([("k", 0, 5)])) is None


@pytest.mark.parametrize("metric", CHAT_READERS)
def test_no_request_or_no_device_operation_gives_none(metric, monkeypatch):
    with_spans(monkeypatch, TWO_REQUESTS)
    assert read(metric, reading(OPS, requests=0)) is None
    # a trace without the card's operations (the CPU) has no idle to name
    assert read(metric, reading([])) is None


@pytest.mark.parametrize("metric", CHAT_READERS + TRAIN_READERS)
def test_a_port_without_the_recorder_gives_none(metric, monkeypatch):
    # a checkout before the recorder: importing it fails
    import tpu_operator_libs_torch

    monkeypatch.delattr(tpu_operator_libs_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "tpu_operator_libs_torch.tracing",
                        None)
    assert program_spans.records(reading(OPS)) == []
    assert read(metric, reading(OPS, steps=2)) is None
    assert read(metric, reading(OPS)) is None


def test_the_recorder_is_read_over_the_stretch():
    from tpu_operator_libs_torch import tracing

    tracing.clear()
    with tracing.span("decode.capture") as inside:
        pass
    r = reading([], t0=inside.start, t1=inside.end)
    assert program_spans.records(r) == [inside]
    assert program_spans.records(reading([], t0=inside.end + 1,
                                         t1=inside.end + 2)) == []
    tracing.clear()


def test_every_program_span_metric_has_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]
             if m["source"] == "program_span"]
    assert set(CHAT_READERS + TRAIN_READERS) <= set(names)
    for name in names:
        assert (ROOT / "port_bench" / "metrics" / f"{name}.py").is_file()
        assert callable(harness.load_module("metrics", name).read)

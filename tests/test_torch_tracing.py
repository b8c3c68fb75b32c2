"""The port's span recorder (``tpu_operator_libs_torch.tracing``) and the
spans of the serving endpoint, the decode loop and the train step, on the
CPU."""

import collections
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_operator_libs_torch import tracing
from tpu_operator_libs_torch.examples import llama
from tpu_operator_libs_torch.examples import llama_decode as tdecode
from tpu_operator_libs_torch.examples.llama_serving_job import build_server

REQUEST_TREE = {
    "serve.request": None, "serve.admit": "serve.request",
    "serve.queue": "serve.request", "decode.generate": "serve.request",
    "decode.cache_alloc": "decode.generate",
    "decode.prefill": "decode.generate",
    "decode.first_pick": "decode.generate",
    "decode.steps": "decode.generate", "serve.readback": "serve.request"}
GRAPH_SPANS = ["decode.eager_step", "decode.capture", "decode.replay",
               "decode.wait", "decode.release"]


@pytest.fixture(scope="module")
def server():
    return build_server(device="cpu", max_new_tokens=4)


def prompt(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (2, 4))


def trees(found):
    """{request id: {name: span}}, each name once a tree."""
    out = collections.defaultdict(dict)
    for s in found:
        assert s.name not in out[s.request_id], s.name
        out[s.request_id][s.name] = s
    return dict(out)


def assert_tree(tree, parents):
    assert set(tree) == set(parents)
    for name, parent in parents.items():
        s = tree[name]
        if parent is None:
            assert s.parent_id is None and s.request_id == s.span_id
        else:
            up = tree[parent]
            assert s.parent_id == up.span_id
            assert up.start <= s.start <= s.end <= up.end, name


def test_a_request_is_one_tree_of_spans(server):
    tracing.clear()
    assert server.handle(prompt(0, server.config.vocab)) is not None
    (tree,) = trees(tracing.records()).values()
    assert_tree(tree, REQUEST_TREE)
    order = sorted(tree, key=lambda name: tree[name].start)
    assert order == ["serve.request", "serve.admit", "serve.queue",
                     "decode.generate", "decode.cache_alloc",
                     "decode.prefill", "decode.first_pick", "decode.steps",
                     "serve.readback"]


def test_concurrent_requests_keep_their_own_ids(server):
    tracing.clear()
    go = threading.Barrier(2)
    errors = []

    def client(seed):
        try:
            go.wait(timeout=60)
            assert server.handle(prompt(seed, server.config.vocab)) \
                is not None
        except BaseException as exc:  # re-raised in the test's thread
            errors.append(exc)
            raise

    threads = [threading.Thread(target=client, args=(s,)) for s in (1, 2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors
    found = trees(tracing.records())
    assert len(found) == 2
    for tree in found.values():
        assert_tree(tree, REQUEST_TREE)
    # one generation at a time: the second waited in its queue span
    first, second = sorted(found.values(),
                           key=lambda t: t["decode.generate"].start)
    assert second["decode.generate"].start >= first["decode.generate"].end


def test_request_seconds_and_last_call_are_as_before(server):
    tracing.clear()
    before = len(server.request_seconds)
    for seed in (3, 4):
        server.handle(prompt(seed, server.config.vocab))
    assert len(server.request_seconds) == before + 2
    assert set(tdecode.generate_on_device.last_call) == {
        "eager_steps", "graph_launches", "capture_ms"}
    assert tdecode.generate_on_device.last_call == {
        "eager_steps": server.max_new_tokens - 1, "graph_launches": 0,
        "capture_ms": 0.0}
    # each request's seconds: its queue span's start to its readback's end
    spans = sorted(trees(tracing.records()).values(),
                   key=lambda t: t["serve.request"].start)
    want = [(t["serve.readback"].end - t["serve.queue"].start) / 1e9
            for t in spans]
    assert server.request_seconds[before:] == want


def test_a_parked_request_has_no_generation(server):
    tracing.clear()
    server.endpoint.begin_drain()
    try:
        assert server.handle(prompt(5, server.config.vocab)) is None
    finally:
        server.endpoint.resume()
    (tree,) = trees(tracing.records()).values()
    assert_tree(tree, {"serve.request": None, "serve.admit": "serve.request"})


class _Graph:
    """A CUDA graph's surface, recording when it is freed."""
    freed_at = []

    def register_generator_state(self, generator):
        pass

    def capture_begin(self, capture_error_mode):
        time.sleep(0.002)

    def capture_end(self):
        pass

    def replay(self):
        pass

    def __del__(self):
        _Graph.freed_at.append(time.time_ns())


class _Stream:
    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


def test_the_graph_decode_spans_and_capture_ms(monkeypatch):
    """The card's path with the CUDA pieces faked: the eager step, the
    capture, the replays, the wait and the release in order under
    decode.generate, last_call's capture_ms from the capture span, and
    the graph freed inside the release span."""
    monkeypatch.setattr(tdecode, "_captures", lambda device, mesh: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    _Graph.freed_at.clear()
    server = build_server(device="cpu", max_new_tokens=4)
    tracing.clear()
    server.handle(prompt(6, server.config.vocab))
    (tree,) = trees(tracing.records()).values()
    parents = {k: v for k, v in REQUEST_TREE.items() if k != "decode.steps"}
    parents.update({name: "decode.generate" for name in GRAPH_SPANS})
    assert_tree(tree, parents)
    ordered = [tree[name] for name in GRAPH_SPANS]
    assert all(a.end <= b.start for a, b in zip(ordered, ordered[1:]))
    capture = tree["decode.capture"]
    assert tdecode.generate_on_device.last_call == {
        "eager_steps": 1, "graph_launches": 2,
        "capture_ms": (capture.end - capture.start) / 1e6}
    release = tree["decode.release"]
    assert len(_Graph.freed_at) == 1
    assert release.start <= _Graph.freed_at[0] <= release.end


def test_a_train_step_is_one_tree_of_spans():
    config = llama.LlamaConfig(vocab=64, d_model=32, n_layers=1, n_heads=4,
                               n_kv_heads=4, d_ff=64, seq_len=8,
                               learning_rate=1e-3, grad_clip_norm=1.0)
    optimizer, step = llama.make_train_step(config, device="cpu")
    params = llama.init_llama_params(config, device="cpu")
    state = {"params": params, "opt": optimizer.init(params), "step": 0}
    tracing.clear()
    step(state, torch.zeros((2, config.seq_len), dtype=torch.int32))
    (tree,) = trees(tracing.records()).values()
    assert_tree(tree, {"train.step": None, "train.forward": "train.step",
                       "train.backward": "train.step",
                       "train.update": "train.step"})
    assert tree["train.forward"].end <= tree["train.backward"].start \
        <= tree["train.backward"].end <= tree["train.update"].start
    # device spans, but no card: no events, no device time
    assert all(s.device_ms is None for s in tree.values())


@pytest.mark.parametrize("device", [True, torch.device("cpu"), "cpu"])
def test_a_device_span_without_a_card_has_no_device_ms(device):
    with tracing.span("x", device=device) as s:
        pass
    assert s.device_ms is None
    assert s.start <= s.end


def test_the_ring_keeps_the_newest():
    tracing.clear()
    for i in range(tracing.RING + 10):
        with tracing.span(str(i)):
            pass
    found = tracing.records()
    assert len(found) == tracing.RING
    assert [found[0].name, found[-1].name] == ["10", str(tracing.RING + 9)]
    tracing.clear()
    assert tracing.records() == []


def test_records_overlapping_a_stretch():
    tracing.clear()
    with tracing.span("a") as a:
        time.sleep(0.001)
    time.sleep(0.001)
    with tracing.span("b") as b:
        time.sleep(0.001)
    names = lambda t0, t1: [s.name for s in tracing.records(t0, t1)]  # noqa
    assert names(None, None) == ["a", "b"]
    assert names(a.end + 1, None) == ["b"]
    assert names(None, b.start - 1) == ["a"]
    assert names(a.end, b.start) == ["a", "b"]
    assert names(a.end + 1, b.start - 1) == []


def test_a_request_span_opens_a_new_tree():
    tracing.clear()
    with tracing.span("outer") as outer:
        with tracing.span("inner") as inner:
            with tracing.span("request", request=True) as req:
                with tracing.span("child") as child:
                    pass
            with tracing.span("after") as after:
                pass
    assert (inner.parent_id, inner.request_id) == (outer.span_id,
                                                   outer.span_id)
    assert (req.parent_id, req.request_id) == (None, req.span_id)
    assert (child.parent_id, child.request_id) == (req.span_id, req.span_id)
    # the request's span closed: its sibling is the outer tree's again
    assert (after.parent_id, after.request_id) == (inner.span_id,
                                                   outer.span_id)


def test_threads_keep_their_trees_under_switching():
    """More threads than cores, switching every microsecond: every
    child's parent and request are its own thread's root."""
    tracing.clear()
    n_threads, rounds = 32, 200
    errors = []

    def work(t):
        try:
            for _ in range(rounds):
                with tracing.span(f"root{t}", request=True):
                    with tracing.span(f"child{t}"):
                        with tracing.span(f"leaf{t}"):
                            pass
        except BaseException as exc:  # re-raised in the test's thread
            errors.append(exc)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    found = trees(tracing.records())
    assert len(found) == n_threads * rounds
    for tree in found.values():
        (root,) = [n for n in tree if n.startswith("root")]
        t = root[len("root"):]
        assert_tree(tree, {root: None, f"child{t}": root,
                           f"leaf{t}": f"child{t}"})

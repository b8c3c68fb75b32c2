"""The serving pod over several ranks (``examples/llama_serving_job.py``
with a mesh): the drain contract of tests/test_serving_job.py on a pod of
four gloo ranks (dp 2 x tp 2) — a mid-burst drain parks new requests and
drops none — with greedy tokens equal to a one-rank server's for the
same prompts, a stop that one follower asks for agreed by every rank,
and ``main`` serving on every visible card by default.

Both servers hold float32 weights, so the tp ranks' partial sums round
like the one rank's whole ones up to float32 noise, far below any gap
between the top two logits that greedy decoding could trip on."""

import numpy as np
import pytest
import torch

import test_torch_rank_workers as workers
from tpu_operator_libs_torch.examples import llama_serving_job as job
from tpu_operator_libs_torch.parallel import run_ranks

DEMO = {"n_requests": 8, "drain_after": 4, "workers": 3}


def prompts(vocab=64):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (2, 4)) for _ in range(3)]


@pytest.fixture(scope="module")
def pod():
    return run_ranks(workers.serving_pod_rank, 4, prompts(), DEMO,
                     device="cpu")


def test_pod_tokens_equal_one_ranks(pod):
    one = job.build_server(device="cpu", param_dtype=torch.float32)
    for prompt, got in zip(prompts(), pod[0]["tokens"]):
        want = one.handle(prompt)
        assert got.shape == (2, 4 + one.max_new_tokens)
        np.testing.assert_array_equal(got, want)


def test_mid_burst_drain_drops_nothing(pod):
    summary = pod[0]["summary"]
    assert summary["dropped"] == 0
    assert summary["parked"] >= 1
    assert summary["draining"] is True
    assert set(summary["served_request_ids"]) <= set(range(DEMO["n_requests"]))
    assert len(summary["request_seconds"]) \
        == len(summary["served_request_ids"])


def test_every_follower_took_every_round(pod):
    # the three fixed prompts, the demo's warm-up call and its served
    # requests: one round each, on every rank
    rounds = 3 + 1 + len(pod[0]["summary"]["served_request_ids"])
    assert [r["served"] for r in pod[1:]] == [rounds] * 3


def test_a_followers_stop_is_agreed_by_every_rank(pod):
    stopped = pod[0]["stopped"]
    assert stopped["refused"]
    assert stopped["dropped"] == 1  # the request being admitted
    assert stopped["completed"] == 0
    assert [r["stopped_served"] for r in pod[1:]] == [0, 0, 0]


def test_main_serves_on_every_visible_card_by_default(monkeypatch):
    asked = []

    def fake_run_ranks(fn, n, *args, device=None, **kw):
        asked.append((fn, n, device.type))
        return [{"completed": 1, "dropped": 0, "parked": 1}]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(job, "run_ranks", fake_run_ranks)
    assert job.main(["--demo"]) == 0
    assert asked == [(job.serve_rank, 4, "cuda")]


def test_a_pod_samples_from_a_seed_not_a_generator():
    from tpu_operator_libs_torch.parallel import Mesh

    mesh = Mesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                tp_group=None, device=torch.device("cpu"))
    server = job.build_server(device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="seed"):
        server.handle(prompts()[0], generator=torch.Generator())

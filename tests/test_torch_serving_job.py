"""The port's drainable decode server on the CPU: the first five tests of
tests/test_serving_job.py against tpu_operator_libs_torch. The contract
is the gate's unit of loss: a mid-burst drain parks new requests and
drops ZERO in-flight generations; a kill surfaces drops."""

import numpy as np
import pytest

from tpu_operator_libs_torch.examples.llama_serving_job import (
    build_server,
    run_demo,
)


def prompt(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (2, 4))


@pytest.fixture(scope="module")
def server():
    return build_server(device="cpu")


class TestDecodeServer:
    def test_handle_serves_valid_tokens(self, server):
        out = server.handle(prompt(0, server.config.vocab))
        assert out is not None
        assert out.shape == (2, 4 + server.max_new_tokens)
        assert ((out >= 0) & (out < server.config.vocab)).all()
        assert server.endpoint.completed >= 1
        assert server.endpoint.in_flight == 0

    def test_draining_parks_instead_of_serving(self, server):
        server.endpoint.begin_drain()
        try:
            before = server.parked
            assert server.handle(prompt(1, server.config.vocab)) is None
            assert server.parked == before + 1
            assert server.endpoint.dropped == 0  # parked, not dropped
        finally:
            server.endpoint.resume()

    def test_int8_stack_serves(self):
        srv = build_server(quantize=True, quantize_kv=True,
                           max_new_tokens=4, device="cpu")
        out = srv.handle(prompt(2, srv.config.vocab))
        assert out is not None and out.shape == (2, 8)


class TestDemoDrainSequence:
    def test_mid_burst_drain_drops_nothing(self):
        srv = build_server(max_new_tokens=4, device="cpu")
        summary = run_demo(srv, n_requests=10, drain_after=5, workers=3)
        assert summary["dropped"] == 0
        assert summary["draining"] is True
        assert summary["parked"] >= 1
        assert summary["completed"] >= 5
        assert set(summary["served_request_ids"]) <= set(range(10))
        assert summary["completed"] == \
            len(summary["served_request_ids"]) + 1  # + warm-up call
        assert len(summary["request_seconds"]) \
            == len(summary["served_request_ids"])

    def test_kill_mid_flight_surfaces_drops(self):
        srv = build_server(max_new_tokens=4, device="cpu")
        assert srv.endpoint.try_begin()
        assert srv.endpoint.try_begin()
        dropped = srv.endpoint.kill()
        assert dropped == 2
        assert srv.summary()["dropped"] == 2
        assert srv.endpoint.draining

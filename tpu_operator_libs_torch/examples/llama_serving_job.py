#!/usr/bin/env python3
"""Drainable PyTorch serving job: a decode server behind a ServingEndpoint.

Mirrors ``tpu_operator_libs/examples/llama_serving_job.py``:
``DecodeServer``, ``build_server``, ``run_demo`` and ``main``. The
request intake is a :class:`~tpu_operator_libs_torch.health.serving_gate
.ServingEndpoint` and the compute is
:func:`~tpu_operator_libs_torch.examples.llama_decode.generate_on_device`.
During a rolling upgrade the operator flips the endpoint to draining:
new requests are parked (never dropped), in-flight generations run to
completion, and only then does eviction proceed. ``make_mesh`` of the
JAX job becomes device selection: the server runs on one device.

Run the self-contained demo on the card:

    python -m tpu_operator_libs_torch.examples.llama_serving_job --demo

It serves a burst of concurrent requests, begins draining mid-burst,
lets the in-flight generations finish, and prints one JSON summary line
— ``dropped`` is 0 and ``parked`` counts the requests the drain turned
away. On SIGTERM it marks any still-in-flight generations dropped.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
import time

import numpy as np
import torch

from tpu_operator_libs_torch import resolve_device

logger = logging.getLogger("llama-serving-job")


class DecodeServer:
    """One serving pod: a ServingEndpoint fronting the device decode.

    ``handle`` is the whole request path — admission, generation,
    accounting. It returns the generated tokens as a numpy array, or
    ``None`` when the endpoint is draining (the request was PARKED: it
    never started, so it is not a drop)."""

    def __init__(self, config, params, endpoint,
                 max_new_tokens: int = 8, temperature: float = 0.0,
                 quantize_kv: bool = False):
        self.config = config
        self.params = params
        self.endpoint = endpoint
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.quantize_kv = quantize_kv
        self.parked = 0
        #: wall seconds of each served request, admission to readback
        self.request_seconds: "list[float]" = []
        self._lock = threading.Lock()
        # One generation on the device at a time: the card is one
        # device set, so serializing dispatch models real contention;
        # admission and drain stay concurrent (try_begin/finish are
        # outside the lock).
        self._dispatch_lock = threading.Lock()

    def handle(self, prompt, generator=None):
        from tpu_operator_libs_torch.examples.llama_decode import (
            generate_on_device,
        )

        if not self.endpoint.try_begin():
            with self._lock:
                self.parked += 1
            return None
        start = time.perf_counter()
        try:
            with self._dispatch_lock:
                out = generate_on_device(
                    self.params, prompt, self.config, self.max_new_tokens,
                    temperature=self.temperature, generator=generator,
                    quantize_kv=self.quantize_kv)
                tokens = out.cpu().numpy()  # the one readback
            with self._lock:
                self.request_seconds.append(time.perf_counter() - start)
            return tokens
        finally:
            try:
                self.endpoint.finish()
            except RuntimeError:
                # the endpoint was kill()ed (eviction) while this
                # generation ran: its loss is already counted in
                # ``dropped``, and the finish of that dead epoch must
                # not crash the worker thread during shutdown
                pass

    def summary(self) -> dict:
        return {
            "completed": self.endpoint.completed,
            "dropped": self.endpoint.dropped,
            "parked": self.parked,
            "draining": self.endpoint.draining,
        }


def build_server(n_layers: int = 2, d_model: int = 64,
                 quantize: bool = False, quantize_kv: bool = False,
                 max_new_tokens: int = 8, *, device=None):
    """A small Llama-style decode server with random bf16 weights
    (demo-sized). ``quantize``/``quantize_kv`` switch on the int8
    weight / int8 KV-cache serving stack."""
    from tpu_operator_libs_torch.examples.llama import (
        LlamaConfig,
        init_llama_params,
    )
    from tpu_operator_libs_torch.examples.llama_decode import (
        quantize_params_int8,
    )
    from tpu_operator_libs_torch.health.serving_gate import ServingEndpoint

    config = LlamaConfig(vocab=d_model, d_model=d_model,
                         n_layers=n_layers,
                         n_heads=max(4, d_model // 16),
                         n_kv_heads=max(4, d_model // 16),
                         d_ff=4 * d_model, seq_len=64,
                         learning_rate=1e-4)
    params = init_llama_params(config, param_dtype=torch.bfloat16,
                               device=resolve_device(device))
    if quantize:
        params = quantize_params_int8(params)
    endpoint = ServingEndpoint("llama-serving-demo")
    return DecodeServer(config, params, endpoint,
                        max_new_tokens=max_new_tokens,
                        quantize_kv=quantize_kv)


def run_demo(server, n_requests: int = 12, drain_after: int = 6,
             workers: int = 3, batch: int = 2, prompt_len: int = 4,
             seed: int = 0) -> dict:
    """Serve a burst of concurrent requests of ``batch`` prompts of
    ``prompt_len`` tokens each (drawn from a numpy generator seeded with
    ``seed``), begin draining mid-burst, and wait for quiescence. The
    drain fires synchronously in the worker that picks request
    ``drain_after``, BEFORE it submits that request, so at least that
    request is parked. Returns the summary dict plus the served request
    ids and their wall seconds."""
    # a drain index past the burst would never fire: clamp so a tiny
    # burst still exercises the drain
    drain_after = min(drain_after, n_requests - 1)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, server.config.vocab, (batch, prompt_len),
                            dtype=np.int64)
               for _ in range(n_requests)]
    # warm once so the drain window doesn't race first-call set-up (a
    # real server warms at startup too)
    server.handle(prompts[0])
    warm_count = len(server.request_seconds)

    served = []
    idx_lock = threading.Lock()
    next_idx = [0]

    def worker():
        while True:
            with idx_lock:
                i = next_idx[0]
                if i >= n_requests:
                    return
                next_idx[0] = i + 1
            if i == drain_after:
                # the "upgrade reconcile": the first evaluation that
                # wants this pod gone begins the drain
                server.endpoint.begin_drain()
            out = server.handle(prompts[i])
            if out is not None:
                with idx_lock:
                    served.append(i)

    start = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - start
    if any(t.is_alive() for t in threads) or not server.endpoint.quiesced:
        raise RuntimeError("demo did not quiesce")
    out = server.summary()
    out["served_request_ids"] = sorted(served)
    out["burst_seconds"] = wall
    out["request_seconds"] = server.request_seconds[warm_count:]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0])
    parser.add_argument("--demo", action="store_true",
                        help="serve a burst, drain mid-burst, print a "
                             "JSON summary line")
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--drain-after", type=int, default=6)
    parser.add_argument("--int8", action="store_true",
                        help="serve the int8 weight + int8 KV stack")
    parser.add_argument("--max-new-tokens", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if not args.demo:
        parser.error("only --demo mode is implemented standalone; "
                     "real deployments embed DecodeServer")

    server = build_server(quantize=args.int8, quantize_kv=args.int8,
                          max_new_tokens=args.max_new_tokens,
                          device=args.device)

    def on_sigterm(signum, frame):
        # eviction arriving BEFORE the gate opened: every in-flight
        # generation is lost, and the summary shows it
        dropped = server.endpoint.kill()
        logger.warning("SIGTERM: %d in-flight generation(s) dropped",
                       dropped)
        print(json.dumps(server.summary()))
        sys.exit(1)

    signal.signal(signal.SIGTERM, on_sigterm)
    summary = run_demo(server, n_requests=args.requests,
                       drain_after=args.drain_after)
    print(json.dumps(summary))
    return 0 if summary["dropped"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

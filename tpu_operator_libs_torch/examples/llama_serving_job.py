#!/usr/bin/env python3
"""Drainable PyTorch serving job: a decode server behind a ServingEndpoint.

Mirrors ``tpu_operator_libs/examples/llama_serving_job.py``:
``DecodeServer``, ``build_server``, ``run_demo`` and ``main``. The
request intake is a :class:`~tpu_operator_libs_torch.health.serving_gate
.ServingEndpoint` and the compute is
:func:`~tpu_operator_libs_torch.examples.llama_decode.generate_on_device`.
During a rolling upgrade the operator flips the endpoint to draining:
new requests are parked (never dropped), in-flight generations run to
completion, and only then does eviction proceed.

The JAX job serves on ``make_mesh()``, one program over every device.
Here every card is a rank (``parallel.run_ranks``) over the same dp x tp
mesh, and each request is one round that all ranks take together: rank 0
holds the endpoint and its dispatch lock, and for each admitted request
broadcasts a header (prompt shape and sampling seed, or stop) and the
prompt; the ranks agree whether any of them was told to stop
(``parallel.any_rank``), every rank runs the sharded
``generate_on_device(..., mesh=mesh)``, and rank 0 returns the gathered
tokens. On the cards each rank replays that decode's step from one
captured CUDA graph, its NCCL collectives inside, as one card does. The
followers wait for the next header; rank 0 always sends one more, stop,
before it leaves, so no follower is left in a collective.

Run the self-contained demo on the card:

    python -m tpu_operator_libs_torch.examples.llama_serving_job --demo

(on every visible card; ``--n-devices 4 --device cpu`` runs four gloo
ranks). It serves a burst of concurrent requests, begins draining mid-burst,
lets the in-flight generations finish, and prints one JSON summary line
— ``dropped`` is 0 and ``parked`` counts the requests the drain turned
away. On SIGTERM it marks any still-in-flight generations dropped (on
several ranks: the request that the next round would have served).
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
import torch.distributed as dist

from tpu_operator_libs_torch import resolve_device, tracing
from tpu_operator_libs_torch.parallel import any_rank, run_ranks, \
    spawn_context

logger = logging.getLogger("llama-serving-job")


#: a round's header operations
_STOP, _GENERATE = 0, 1


class DecodeServer:
    """One serving pod: a ServingEndpoint fronting the device decode.

    ``handle`` is the whole request path — admission, generation,
    accounting. It returns the generated tokens as a numpy array, or
    ``None`` when the endpoint is draining (the request was PARKED: it
    never started, so it is not a drop).

    With a ``mesh`` the server is built on every rank: rank 0 calls
    ``handle`` and, before it leaves, ``shutdown``; every other rank
    calls ``serve``, which takes rounds until rank 0 says stop.
    ``stop_event`` (an ``Event``, on any rank) asks the pod to stop: at
    the next round the ranks agree on it, and rank 0 kills its endpoint,
    which counts the generation it was admitting as dropped."""

    def __init__(self, config, params, endpoint,
                 max_new_tokens: int = 8, temperature: float = 0.0,
                 quantize_kv: bool = False, mesh=None, stop_event=None):
        self.config = config
        self.params = params
        self.endpoint = endpoint
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.quantize_kv = quantize_kv
        self.mesh = mesh
        self.stop_event = stop_event
        self.device = params["embed"].device
        self.parked = 0
        #: this rank's decode steps replayed from a CUDA graph, over every
        #: generation (``generate_on_device.last_call``)
        self.graph_launches = 0
        #: wall seconds of each served request, from the wait for the
        #: dispatch lock to the readback (the ``serve.queue`` span's start
        #: to the ``serve.readback`` span's end)
        self.request_seconds: "list[float]" = []
        self._lock = threading.Lock()
        # One generation on the device(s) at a time: the card (or the
        # ranks' cards) is one device set, so serializing dispatch models
        # real contention, and with a mesh it keeps the rounds in order;
        # admission and drain stay concurrent (try_begin/finish are
        # outside the lock).
        self._dispatch_lock = threading.Lock()
        self._stopped = False

    def _generate(self, prompt, generator):
        from tpu_operator_libs_torch.examples.llama_decode import (
            generate_on_device,
        )

        out = generate_on_device(
            self.params, prompt, self.config, self.max_new_tokens,
            temperature=self.temperature, generator=generator,
            quantize_kv=self.quantize_kv, mesh=self.mesh)
        self.graph_launches += generate_on_device.last_call["graph_launches"]
        return out

    def _round(self, op, prompt=None, seed=None):
        """One round on every rank: rank 0's header (and prompt) reach
        every rank, the ranks agree on a stop, and on a go they all
        generate. Returns (go, tokens on the device or None)."""
        header = torch.zeros(4, dtype=torch.long, device=self.device)
        if prompt is not None:
            header.copy_(torch.tensor(
                [op, *prompt.shape, -1 if seed is None else seed]))
        dist.broadcast(header, src=0)
        stop = self.stop_event is not None and self.stop_event.is_set()
        if any_rank(stop, self.mesh) or int(header[0]) == _STOP:
            self._stopped = True
            return False, None
        batch, prompt_len, seed = (int(x) for x in header[1:])
        if prompt is None:
            prompt = torch.empty((batch, prompt_len), dtype=torch.long,
                                 device=self.device)
        else:
            prompt = torch.as_tensor(prompt, dtype=torch.long,
                                     device=self.device)
        dist.broadcast(prompt, src=0)
        generator = (None if seed < 0 else
                     torch.Generator(device=self.device).manual_seed(seed))
        return True, self._generate(prompt, generator)

    def handle(self, prompt, generator=None, seed=None):
        """Serve one request of (B, prompt_len) tokens. ``generator`` (one
        rank) or ``seed`` (any number of ranks: each makes an equally
        seeded generator) drives sampling when ``temperature`` > 0. The
        request is a ``serve.request`` span (``tracing``) around
        ``serve.admit``, ``serve.queue``, the generation and
        ``serve.readback``."""
        if self.mesh is not None and generator is not None:
            raise ValueError("a pod of several ranks samples from a seed, "
                             "not a generator")
        with tracing.span("serve.request", request=True):
            if seed is not None and self.mesh is None:
                generator = torch.Generator(
                    device=self.device).manual_seed(seed)
            with tracing.span("serve.admit"):
                admitted = self.endpoint.try_begin()
            if not admitted:
                with self._lock:
                    self.parked += 1
                return None
            try:
                with tracing.span("serve.queue") as queued:
                    self._dispatch_lock.acquire()
                try:
                    if self.mesh is None:
                        out = self._generate(prompt, generator)
                    else:
                        go, out = (False, None) if self._stopped else \
                            self._round(_GENERATE, np.asarray(prompt), seed)
                        if not go:
                            # the pod is stopping: this generation is lost
                            self.endpoint.kill()
                            return None
                    with tracing.span("serve.readback") as readback:
                        tokens = out.cpu().numpy()  # the one readback
                finally:
                    self._dispatch_lock.release()
                with self._lock:
                    self.request_seconds.append(
                        (readback.end - queued.start) / 1e9)
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

    def serve(self) -> int:
        """A follower rank's loop: take rounds until rank 0 says stop (or
        a rank was told to); returns the number of generations run."""
        served = 0
        while True:
            go, _ = self._round(_STOP)
            if not go:
                return served
            served += 1

    def shutdown(self) -> None:
        """Rank 0: the last round, stop, so every follower leaves its
        loop; a no-op once the pod has stopped or without a mesh."""
        with self._dispatch_lock:
            if self.mesh is not None and not self._stopped:
                self._round(_STOP, np.zeros((0, 0), dtype=np.int64))

    def summary(self) -> dict:
        return {
            "completed": self.endpoint.completed,
            "dropped": self.endpoint.dropped,
            "parked": self.parked,
            "draining": self.endpoint.draining,
            "graph_launches": self.graph_launches,
        }


def build_server(n_layers: int = 2, d_model: int = 64,
                 quantize: bool = False, quantize_kv: bool = False,
                 max_new_tokens: int = 8, *, device=None, mesh=None,
                 param_dtype=torch.bfloat16, stop_event=None, config=None):
    """A small Llama-style decode server with random weights, bfloat16
    by default (demo-sized; ``config``, a ``LlamaConfig``, serves that
    model instead of ``n_layers`` x ``d_model``). ``quantize``/
    ``quantize_kv`` switch on the int8 weight / int8 KV-cache serving
    stack. With a ``mesh`` every rank builds its part of the pod (the
    same weights, its tp shards)."""
    from tpu_operator_libs_torch.examples.llama import (
        LlamaConfig,
        init_llama_params,
    )
    from tpu_operator_libs_torch.examples.llama_decode import (
        quantize_params_int8,
    )
    from tpu_operator_libs_torch.health.serving_gate import ServingEndpoint

    config = config or LlamaConfig(vocab=d_model, d_model=d_model,
                                   n_layers=n_layers,
                                   n_heads=max(4, d_model // 16),
                                   n_kv_heads=max(4, d_model // 16),
                                   d_ff=4 * d_model, seq_len=64,
                                   learning_rate=1e-4)
    params = init_llama_params(
        config, param_dtype=param_dtype,
        device=None if mesh is not None else resolve_device(device),
        mesh=mesh)
    if quantize:
        params = quantize_params_int8(params, mesh)
    endpoint = ServingEndpoint("llama-serving-demo")
    return DecodeServer(config, params, endpoint,
                        max_new_tokens=max_new_tokens,
                        quantize_kv=quantize_kv, mesh=mesh,
                        stop_event=stop_event)


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


def serve_rank(mesh, server_kw, demo_kw, stop_event=None):
    """One rank of a pod over the mesh: every rank builds its part of
    the server; rank 0 runs the demo burst and returns its summary, the
    others serve until it stops them and return their generations; each
    rank reports its decode steps replayed from a graph."""
    server = build_server(mesh=mesh, stop_event=stop_event, **server_kw)
    if dist.get_rank() != 0:
        return {"follower_generations": server.serve(),
                "graph_launches": server.graph_launches}
    try:
        return run_demo(server, **demo_kw)
    finally:
        server.shutdown()


def main(argv=None) -> int:
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
    parser.add_argument("--n-devices", type=int, default=None,
                        help="ranks over a dp x tp mesh, one per card "
                             "(gloo processes with --device cpu); "
                             "default: every visible card (1 with "
                             "--device cpu)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if not args.demo:
        parser.error("only --demo mode is implemented standalone; "
                     "real deployments embed DecodeServer")
    device = resolve_device(args.device)
    n = args.n_devices
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        parser.error(f"--n-devices must be >= 1, got {n}")
    server_kw = {"quantize": args.int8, "quantize_kv": args.int8,
                 "max_new_tokens": args.max_new_tokens}
    demo_kw = {"n_requests": args.requests,
               "drain_after": args.drain_after}

    if n > 1:
        stop = spawn_context().Event()
        # eviction: the ranks agree on it at the next round, and rank 0
        # counts the generation it was admitting as dropped
        signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
        summary = run_ranks(serve_rank, n, server_kw, demo_kw, stop,
                            device=device)[0]
        print(json.dumps({"ranks": n, **summary}))
        return 0 if summary["dropped"] == 0 else 1

    server = build_server(device=device, **server_kw)

    def on_sigterm(signum, frame):
        # eviction arriving BEFORE the gate opened: every in-flight
        # generation is lost, and the summary shows it
        dropped = server.endpoint.kill()
        logger.warning("SIGTERM: %d in-flight generation(s) dropped",
                       dropped)
        print(json.dumps(server.summary()))
        sys.exit(1)

    signal.signal(signal.SIGTERM, on_sigterm)
    summary = run_demo(server, **demo_kw)
    print(json.dumps(summary))
    return 0 if summary["dropped"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

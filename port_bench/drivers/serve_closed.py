"""Closed-loop clients of one ``DecodeServer`` pod.

Set-up makes the weights on the card from the seed, quantizes them with
the port's ``quantize_params_int8`` where the configuration serves int8
weights, and builds the pod: one ``DecodeServer`` behind one
``ServingEndpoint``, at the traffic's temperature. It warms each prompt
length once.

In the window each of the traffic's ``clients`` sends its next request
when its last has come back, until ``--seconds`` have passed; the window
closes when the requests in flight have completed. A request is ``rows``
prompts of one length, sampled from a seed of its own; the lengths come
in blocks that hold each length once, in an order drawn from the seed,
so every seed sends the same mix.

After the window the program's state is freed, and the float32
reference runs once over a sample of the requests (the one with the
longest prompt and others drawn from the seed): the int8 weights and the
int8 cache worked out again from the bf16 draws, every prompt and its
served tokens through the whole model. A sampled token is judged by the
Gumbel-max trick's scores, the reference's logits over the temperature
plus the noise that the request's seed gives PyTorch's ``torch.rand``
(one (rows, vocab) draw a token, as the pick draws it): the widest gap by
which a served token's score lies below the best.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from port_bench import harness, trace, weights
from port_bench.reference import llama_f32


def plan(ctx, client: int, index: int):
    """(prompt (rows, length) int64, sampling seed) of a client's
    ``index``-th request."""
    t = ctx.traffic
    lengths = t["prompt_lengths"]
    block, slot = divmod(index, len(lengths))
    order = np.random.default_rng(
        weights.stream_seed(ctx.seed, "order", client, block)).permutation(
            len(lengths))
    length = lengths[order[slot]]
    rng = np.random.default_rng(
        weights.stream_seed(ctx.seed, "prompt", client, index))
    prompt = rng.integers(0, ctx.model.vocab, (t["rows"], length),
                          dtype=np.int64)
    return prompt, weights.stream_seed(ctx.seed, "sample", client, index)


class TraceGate:
    """The traced stretch: generations ``first`` .. ``first + count - 1``.
    The profiler is started and stopped by the thread that made it (the
    main thread: kineto binds itself to one thread), while the client
    whose generation begins or ends the stretch waits inside the
    dispatch lock, so that no generation runs across either edge."""

    def __init__(self, device, first: int, count: int):
        self.device = device
        self.first, self.last = first, first + count - 1
        self.want_start, self.started = threading.Event(), threading.Event()
        self.want_stop, self.stopped = threading.Event(), threading.Event()
        self.traced = None

    def at_start(self, index: int) -> None:
        if index == self.first:
            self.want_start.set()
            self.started.wait()

    def at_end(self, index: int) -> None:
        if index == self.last:
            self.want_stop.set()
            self.stopped.wait()

    def serve(self, running) -> None:
        """The main thread's side, while ``running()`` is true."""
        def wait(event) -> bool:
            while not event.wait(0.05):
                if not running():
                    return False
            return True

        if not wait(self.want_start):
            return
        profile = trace.Profile(self.device)
        profile.start()
        self.started.set()
        if not wait(self.want_stop):
            profile.stop()
            return
        ops = profile.stop()
        self.traced = (profile.t0, profile.t1, ops)
        self.stopped.set()


class Pod:
    """The pod under test, with the harness's span around every
    ``generate_on_device`` call (and, in a traced run, the edges of the
    traced stretch between two generations). ``DecodeServer`` looks the
    function up in ``llama_decode`` at each call, where the pod puts its
    wrapper; ``run`` checks after the warm-up that the wrapper saw every
    generation."""

    def __init__(self, ctx):
        from tpu_operator_libs_torch.examples import llama_decode
        from tpu_operator_libs_torch.examples.llama_serving_job import (
            DecodeServer,
        )
        from tpu_operator_libs_torch.health.serving_gate import (
            ServingEndpoint,
        )

        self.ctx = ctx
        t = ctx.traffic
        params = weights.make_params(ctx.model, ctx.seed, ctx.device,
                                     ctx.dtype())
        precision = ctx.config["precision"]
        if precision["weights"] == "int8":
            params = llama_decode.quantize_params_int8(params)
        harness.synchronize(ctx.device)
        self.server = DecodeServer(
            ctx.model, params, ServingEndpoint("port-bench"),
            max_new_tokens=t["new_tokens"], temperature=t["temperature"],
            quantize_kv=precision["kv_cache"] == "int8")
        self.generations = []  # (start ns, end ns, rows, prompt length)
        self.capture_ms = []
        self.gate = None
        self._module = llama_decode
        self._original = llama_decode.generate_on_device
        llama_decode.generate_on_device = self._wrapped()

    def _wrapped(self):
        original = self._original

        def generate_on_device(params, prompt, *args, **kwargs):
            index = len(self.generations)
            if self.gate is not None:
                self.gate.at_start(index)
            start = time.time_ns()
            out = original(params, prompt, *args, **kwargs)
            end = time.time_ns()
            # the original records the call under its module's name, which
            # is this wrapper while the pod runs; DecodeServer reads it there
            record = self._module.generate_on_device.last_call
            self.generations.append((start, end, *prompt.shape))
            self.capture_ms.append(record["capture_ms"])
            self.ctx.spans.add("generate_on_device", start, end)
            if self.gate is not None:
                self.gate.at_end(index)
            return out

        return generate_on_device

    def handle(self, prompt, seed: int):
        return self.server.handle(prompt, seed=seed)

    def close(self) -> None:
        self._module.generate_on_device = self._original
        self.server = None


def warm_up(ctx, pod) -> None:
    """One request at each prompt length; the wrapper has to have seen
    each one's generation."""
    t = ctx.traffic
    rng = np.random.default_rng(weights.stream_seed(ctx.seed, "warm"))
    for i, length in enumerate(t["prompt_lengths"]):
        prompt = rng.integers(0, ctx.model.vocab, (t["rows"], length),
                              dtype=np.int64)
        if pod.handle(prompt, weights.stream_seed(ctx.seed, "w", i)) is None:
            raise RuntimeError("the pod refused a warm-up request")
    if len(pod.generations) != len(t["prompt_lengths"]):
        raise RuntimeError(
            "DecodeServer no longer reaches generate_on_device through "
            "llama_decode's module attribute: the harness's span and "
            "counters would read nothing")


def serve_window(ctx, pod):
    """The window's requests, each ``{client, index, length, seed, sent,
    done, prompt, tokens or None}``, and the window's seconds: a closed
    loop of ``clients`` threads, each sending its next request when the
    last has come back, until ``--seconds`` have passed."""
    records, errors, lock = [], [], threading.Lock()
    start = time.perf_counter()
    deadline = start + ctx.seconds

    def client(cid: int) -> None:
        try:
            index = 0
            while (sent := time.perf_counter()) < deadline:
                prompt, seed = plan(ctx, cid, index)
                with ctx.spans.span("handle"):
                    out = pod.handle(prompt, seed)
                done = time.perf_counter()
                with lock:
                    records.append({
                        "client": cid, "index": index,
                        "length": prompt.shape[1], "seed": seed,
                        "sent": sent, "done": done, "prompt": prompt,
                        "tokens": out})
                index += 1
        except BaseException as exc:  # re-raised in the caller's thread
            errors.append(exc)
            raise

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(ctx.traffic["clients"])]
    for th in threads:
        th.start()
    if pod.gate is not None:
        pod.gate.serve(lambda: any(th.is_alive() for th in threads))
    for th in threads:
        th.join()
    window_s = time.perf_counter() - start
    if errors:
        raise errors[0]
    return records, window_s


def check_sample(ctx, records) -> list:
    """The requests the check reads: the longest prompt's, and
    ``check_requests - 1`` more drawn from the seed."""
    done = [r for r in records if r["tokens"] is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["length"], -r["client"],
                                       -r["index"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(weights.stream_seed(ctx.seed, "check"))
    more = ctx.traffic["check_requests"] - 1
    picked = rng.choice(len(rest), size=min(more, len(rest)),
                        replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(picked)]


def logit_gaps(ctx, sample, control_bits=None) -> dict:
    """The widest gap of the sample's served tokens under the reference,
    in the pick's scores (``llama_f32.pick_scores``: the logits over the
    temperature plus the request's Gumbel noise); with ``control_bits``,
    also the widest gap (under the same reference) of the tokens that
    the reference at that precision picks with the same noise."""
    import torch

    llama_f32.no_tf32()
    t = ctx.traffic
    bits = 8 if ctx.config["precision"]["weights"] == "int8" else None
    c, dev, dt = ctx.model, ctx.device, ctx.dtype()
    ends = weights.make_ends(c, ctx.seed, dev, dt)

    def layer(i):
        return weights.make_layer(c, ctx.seed, i, dev, dt)

    served, control = [], []
    with torch.no_grad():
        for r in sample:
            # the served tokens after the prompt the client sent: an
            # answer is judged against what was asked
            out = np.asarray(r["tokens"])
            rows = r["prompt"].shape[0]
            if out.shape != (rows, r["length"] + t["new_tokens"]):
                served.append(float("inf"))
                continue
            tokens = torch.as_tensor(np.concatenate(
                [r["prompt"], out[:, r["length"]:]], axis=1), device=dev)
            first = r["length"] - 1
            noise = llama_f32.pick_noise(r["seed"], rows, c.vocab,
                                         t["new_tokens"], dev,
                                         t["temperature"])
            ref = llama_f32.pick_scores(
                llama_f32.served_logits(c, ctx.eps, tokens, first, layer,
                                        ends, bits=bits),
                noise, t["temperature"])
            served.append(llama_f32.token_gaps(
                ref, tokens[:, first + 1:]).max().item())
            if control_bits is not None:
                low = llama_f32.pick_scores(
                    llama_f32.served_logits(c, ctx.eps, tokens, first,
                                            layer, ends, bits=control_bits),
                    noise, t["temperature"])
                control.append(llama_f32.token_gaps(
                    ref, low.argmax(-1)).max().item())
                del low
            del ref, noise
    out = {"logit_gap": max(served) if served else float("inf"),
           "served_tokens": len(sample) * t["rows"] * t["new_tokens"]}
    if control_bits is not None:
        out["control_gap"] = max(control)
    return out


def run(ctx, control_bits=None) -> dict:
    t = ctx.traffic
    pod = Pod(ctx)
    try:
        warm_up(ctx, pod)
        harness.synchronize(ctx.device)
        setup_s = time.perf_counter() - ctx.started
        warm = len(pod.generations)
        warm_requests = len(pod.server.request_seconds)
        if ctx.trace:
            pod.gate = TraceGate(ctx.device, warm + t["trace_after"],
                                 t["trace_requests"])
        records, window_s = serve_window(ctx, pod)
        device = harness.device_line(ctx.device, ctx.cell["chips"])
        served_s = pod.server.request_seconds[warm_requests:]
        capture_ms = pod.capture_ms[warm:]
        generations = pod.generations[warm:]
        traced = pod.gate.traced if pod.gate is not None else None
    finally:
        pod.close()
    del pod
    harness.free_memory(ctx.device)

    completed = [r for r in records if r["tokens"] is not None]
    latencies = [(r["done"] - r["sent"]) * 1e3 for r in completed]
    out = {"attempted": len(records),
           "failed": len(records) - len(completed), "device": device,
           "setup_s": setup_s,
           "metrics": {
               "decode_tokens_per_s": len(completed) * t["rows"]
               * t["new_tokens"] / window_s,
               "request_p90_ms": (harness.percentile(latencies, 90)
                                  if latencies else float("inf")),
               "setup_s": setup_s}}
    sample = check_sample(ctx, records)
    out["gaps"] = logit_gaps(ctx, sample, control_bits)
    out["sample"] = [(r["client"], r["index"], r["length"]) for r in sample]
    if traced is not None:
        t0, t1, ops = traced
        inside = [g for g in generations if g[0] >= t0 and g[1] <= t1]
        out["reading"] = trace.Reading(
            t0=t0, t1=t1, ops=trace.within(ops, t0, t1),
            spans=ctx.spans.spans,
            counters={"request_seconds": served_s, "capture_ms": capture_ms},
            work={"requests": [(rows, length) for _, _, rows, length
                               in inside],
                  "new_tokens": t["new_tokens"]},
            config=ctx.model, traffic=t)
    return out

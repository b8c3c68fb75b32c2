"""Closed-loop clients of one tensor-parallel ``DecodeServer`` pod over
the cell's cards: tp over all of them, dp 1.

Set-up starts the pod (``port_bench/tp_ranks.py``): rank 0 is this
process, ranks 1 .. n-1 are spawned, every rank makes the model one
layer at a time from the seed and keeps its shards, and each builds a
``DecodeServer`` over the mesh ``{"dp": 1, "tp": n}`` at the traffic's
temperature with the configuration's cache. The followers sit in
``DecodeServer.serve()``; rank 0 serves the traffic through its
``handle`` with ``serve_closed``'s request plan, warm-up, window, check
sample and traced stretch, loaded from that driver and not copied. A
request is one round of the pod: its header and prompt broadcast, the
ranks' stop agreement and the sharded ``generate_on_device``, whose
decode step each rank replays from a CUDA graph with its NCCL
collectives inside.

After the window rank 0 stops the followers (``shutdown``), which report
their peak memory, and frees its shards. The float32 reference
(``reference/served_grids.py``: the weights as drawn, the cache on the
int8 grid) then runs the sample on rank 0's device, one layer at a time
from the same seeded draws, and judges each served token by the pick's
Gumbel scores, as ``serve_closed`` does: the widest gap (``logit_gap``)
and the mean over the sample's served tokens (``logit_gap_mean``).

``run(ctx, controls=True)`` also reads the controls on the same sample:
the reference on other grids (int8 or int4 weights per output channel,
an int4 cache), each picking with the same noise and judged by the
served grids, and the pod itself with its pick broken after the window
(every token altered on rank 0; each request sampled from the next
seed's noise), each judged like the served tokens.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import harness, tp_ranks, trace, weights
from port_bench.reference import llama_f32, served_grids

closed = harness.load_module("drivers", "serve_closed")

#: the served grids, (weights, cache) bits: the weights as drawn, the
#: cache on int8
SERVED = (None, 8)
#: the controls' grids, each judged by the served grids
CONTROLS = {"int8_weights": (8, 8), "int4_cache": (None, 4),
            "int4_weights": (4, 8)}


class TpPod(closed.Pod):
    """Rank 0's part of the pod, with ``serve_closed.Pod``'s wrapper
    around every ``generate_on_device`` call (which also keeps each
    generation's tp collectives, ``last_call["collectives"]``: None
    where the program does not count them)."""

    def __init__(self, ctx):
        from tpu_operator_libs_torch.examples import llama_decode
        from tpu_operator_libs_torch.health.serving_gate import (
            ServingEndpoint,
        )

        self.ctx = ctx
        self.ranks = tp_ranks.Ranks(ctx)
        try:
            self.server = tp_ranks.build_server(
                self.ranks.spec, self.ranks.mesh,
                ServingEndpoint("port-bench"))
        except BaseException:
            self.ranks.finish(stopped=False)
            raise
        harness.synchronize(ctx.device)
        self.generations = []  # (start ns, end ns, rows, prompt length)
        self.capture_ms, self.collectives = [], []
        self.gate = None
        self._module = llama_decode
        self._original = llama_decode.generate_on_device
        llama_decode.generate_on_device = self._wrapped()

    def _wrapped(self):
        inner = super()._wrapped()

        def generate_on_device(*args, **kwargs):
            out = inner(*args, **kwargs)
            record = self._module.generate_on_device.last_call
            self.collectives.append(record.get("collectives"))
            return out

        return generate_on_device

    def close(self, healthy: bool) -> "list[dict]":
        """Stop the followers with rank 0's last round (``healthy``: the
        rounds are in step; otherwise they are killed) and put the
        module's function back; returns the followers' reports."""
        stopped = False
        try:
            if healthy:
                self.server.shutdown()
                stopped = True
        finally:
            super().close()
            reports = self.ranks.finish(stopped)
        return reports


def served_faults(pod, sample) -> dict:
    """The sample's requests served again by the pod with its pick
    broken, one fault at a time: {fault: tokens of each request}. Where
    the pod keeps its decode graphs, a request replays the steps captured
    before the fault, so an altered token is the first pick's alone."""
    from port_bench import calibrate

    out = {}
    for plant in (calibrate.altered_token, calibrate.other_noise):
        undo = plant()
        try:
            out[plant.__name__] = [pod.handle(r["prompt"], r["seed"])
                                   for r in sample]
        finally:
            undo()
    return out


def logit_gaps(ctx, sample, faults=None, controls: bool = False) -> dict:
    """The gaps of the sample's served tokens under the reference on the
    served grids, in the pick's scores (the logits over the temperature
    plus the request's Gumbel noise: ``serve_closed``'s judgement): the
    widest (``logit_gap``) and the mean over every served token
    (``logit_gap_mean``). A token's gap is 0 unless an error of the
    logits flipped its pick, and both the share of flips and the size
    of each grow with the error, so the mean grows about as its square:
    it parts int8 weights from the weights as drawn, where the widest
    gap, one token of the sample, does not. With ``controls``, the same
    two (``<control>_gap``, ``<control>_gap_mean``) for each of
    :data:`CONTROLS` (the tokens the reference on those grids picks
    with the same noise at each served position) and for each of
    ``faults`` (those tokens judged over themselves)."""
    import torch

    llama_f32.no_tf32()
    t = ctx.traffic
    c, dev, dt = ctx.model, ctx.device, ctx.dtype()
    ends = weights.make_ends(c, ctx.seed, dev, dt)
    faults = faults or {}

    def layer(i):
        return weights.make_layer(c, ctx.seed, i, dev, dt)

    def scores(tokens, first, noise, grids):
        bits_w, bits_kv = grids
        return llama_f32.pick_scores(
            served_grids.served_logits(c, ctx.eps, tokens, first, layer,
                                       ends, weight_bits=bits_w,
                                       kv_bits=bits_kv),
            noise, t["temperature"])

    gaps = {name: [] for name in ["logit_gap"] + [
        f"{n}_gap" for n in (list(CONTROLS) if controls else [])
        + list(faults)]}
    with torch.no_grad():
        for k, r in enumerate(sample):
            rows, first = r["prompt"].shape[0], r["length"] - 1
            noise = llama_f32.pick_noise(r["seed"], rows, c.vocab,
                                         t["new_tokens"], dev,
                                         t["temperature"])

            def judged(out):
                """(tokens, reference scores, each token's gap) of the
                served ``out`` after the prompt the client sent."""
                out = None if out is None else np.asarray(out)
                if out is None or out.shape != (
                        rows, r["length"] + t["new_tokens"]):
                    return None, None, None
                tokens = torch.as_tensor(np.concatenate(
                    [r["prompt"], out[:, r["length"]:]], axis=1),
                    device=dev)
                ref = scores(tokens, first, noise, SERVED)
                return tokens, ref, llama_f32.token_gaps(
                    ref, tokens[:, first + 1:]).flatten().cpu()

            tokens, ref, gap = judged(r["tokens"])
            gaps["logit_gap"].append(gap)
            for name, grids in (CONTROLS.items() if controls else ()):
                if ref is None:
                    gaps[f"{name}_gap"].append(None)
                    continue
                low = scores(tokens, first, noise, grids)
                gaps[f"{name}_gap"].append(llama_f32.token_gaps(
                    ref, low.argmax(-1)).flatten().cpu())
                del low
            del ref
            for name, outs in faults.items():
                gaps[f"{name}_gap"].append(judged(outs[k])[2])
            del noise
    out = {}
    for name, parts in gaps.items():
        whole = (torch.cat(parts) if parts and all(
            p is not None for p in parts) else None)
        out[name], out[f"{name}_mean"] = (
            (whole.max().item(), whole.mean().item()) if whole is not None
            else (float("inf"), float("inf")))
    out["served_tokens"] = len(sample) * t["rows"] * t["new_tokens"]
    return out


def run(ctx, controls: bool = False) -> dict:
    import torch

    t = ctx.traffic
    pod = TpPod(ctx)
    healthy = False
    try:
        closed.warm_up(ctx, pod)
        harness.synchronize(ctx.device)
        setup_s = time.perf_counter() - ctx.started
        warm = len(pod.generations)
        warm_requests = len(pod.server.request_seconds)
        if ctx.trace:
            pod.gate = closed.TraceGate(ctx.device, warm + t["trace_after"],
                                        t["trace_requests"])
        records, window_s = closed.serve_window(ctx, pod)
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if harness.on_card(ctx.device) else 0)
        served_s = pod.server.request_seconds[warm_requests:]
        capture_ms = pod.capture_ms[warm:]
        generations = list(zip(pod.generations[warm:],
                               pod.collectives[warm:]))
        traced = pod.gate.traced if pod.gate is not None else None
        pod.gate = None
        sample = closed.check_sample(ctx, records)
        faults = served_faults(pod, sample) if controls else None
        healthy = True
    finally:
        reports = pod.close(healthy)
    del pod
    harness.free_memory(ctx.device)

    device = harness.device_line(ctx.device, 1)
    if harness.on_card(ctx.device):
        device.update(count=ctx.cell["chips"], memory_peak_bytes=max(
            [peak] + [r["peak_bytes"] for r in reports]))
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
               "setup_s": setup_s},
           "followers": [r["served"] for r in reports]}
    out["gaps"] = logit_gaps(ctx, sample, faults, controls)
    out["sample"] = [(r["client"], r["index"], r["length"]) for r in sample]
    if traced is not None:
        t0, t1, ops = traced
        inside = [(g, n) for g, n in generations
                  if g[0] >= t0 and g[1] <= t1]
        out["reading"] = trace.Reading(
            t0=t0, t1=t1, ops=trace.within(ops, t0, t1),
            spans=ctx.spans.spans,
            counters={"request_seconds": served_s, "capture_ms": capture_ms,
                      "traced_collectives": [n for _, n in inside]},
            work={"requests": [(rows, length) for (_, _, rows, length), _
                               in inside],
                  "new_tokens": t["new_tokens"], "tp": ctx.cell["chips"]},
            config=ctx.model, traffic=t)
    return out

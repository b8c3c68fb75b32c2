"""The traced stretch of a run: the device operations that
``torch.profiler`` recorded, the harness's spans, and what the per-layer
readers take from them.

The profiler records the card's activity alone (CUPTI: kernels, copies,
sets, replayed graphs' kernels included), between two synchronizations,
and only the summed tables leave the process: no chrome trace is
written. Event times are wall-clock nanoseconds, the clock the
harness's spans use, so an idle gap can be named by the span the host
held open.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time


@dataclasses.dataclass
class Reading:
    """What a per-layer reader gets: the stretch ``[t0, t1]`` (wall ns),
    the device operations in it (name, start, end), the harness's spans,
    the program's counters, the work the drivers did in the stretch, the
    model configuration (the port's ``LlamaConfig``) and the cell's
    traffic."""

    t0: int
    t1: int
    ops: list
    spans: list
    counters: dict
    work: dict
    config: object
    traffic: dict

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9


class Profile:
    """``torch.profiler`` over the card's activity, started and stopped
    on a synchronized device."""

    def __init__(self, device="cuda"):
        from torch.profiler import ProfilerActivity, profile

        from port_bench import harness

        self._sync = lambda: harness.synchronize(device)
        # on the CPU (a test's run) there is no card to record
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if harness.on_card(device)
            else ProfilerActivity.CPU])
        self.t0 = self.t1 = None

    def start(self) -> None:
        self._sync()
        self._prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self) -> list:
        self._sync()
        self.t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        return device_ops(self._prof)


def device_ops(prof) -> list:
    """(name, start ns, end ns) of every device operation recorded."""
    from torch.autograd import DeviceType

    ops = []
    for event in prof.profiler.kineto_results.events():
        if event.device_type() != DeviceType.CUDA:
            continue
        start = event.start_ns()
        ops.append((event.name(), start, start + event.duration_ns()))
    return ops


def within(ops, t0: int, t1: int) -> list:
    """The operations that start inside [t0, t1]."""
    return [op for op in ops if t0 <= op[1] <= t1]


def merged(ops, t0: int, t1: int) -> "list[tuple[int, int]]":
    """The union of the operations' intervals, clipped to [t0, t1]."""
    out: "list[list[int]]" = []
    for _, start, end in sorted(ops, key=lambda op: op[1]):
        start, end = max(start, t0), min(end, t1)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def busy_s(reading: Reading) -> float:
    return sum(e - s for s, e in merged(reading.ops, reading.t0,
                                        reading.t1)) / 1e9


def matching(reading: Reading, pattern: str) -> list:
    found = re.compile(pattern)
    return [op for op in reading.ops if found.search(op[0])]


def device_seconds(ops) -> float:
    return sum(end - start for _, start, end in ops) / 1e9


def open_span(spans, at: int) -> str:
    """The innermost harness span open at ``at``, or "no span": the
    shortest that holds it, so that a span nested in another, or another
    thread's call, wins over a client's span that holds its wait."""
    best = None
    for name, start, end in spans:
        if start <= at <= end and (best is None or end - start < best[1]):
            best = (name, end - start)
    return best[0] if best else "no span"


def breakdown(reading: Reading, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and
    the idle time between them, summed by the harness span open at each
    gap's middle."""
    by_op = collections.Counter()
    for name, start, end in reading.ops:
        by_op[name[:160]] += (end - start) / 1e9
    idle = collections.Counter()
    cursor = reading.t0
    for start, end in merged(reading.ops, reading.t0, reading.t1) + [
            (reading.t1, reading.t1)]:
        if start > cursor:
            idle[open_span(reading.spans, (cursor + start) // 2)] += (
                start - cursor) / 1e9
        cursor = max(cursor, end)
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}

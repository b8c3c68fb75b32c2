"""The program's own spans in a traced stretch: the port's span recorder
(``tpu_operator_libs_torch.tracing``) read over ``[t0, t1]``, and the
stretch's idle time given to the spans.

Its spans carry ``time.time_ns()``, the clock of the profiler's device
events, so a device-idle gap is named by the innermost program span
open at its middle, as ``trace.open_span`` names it by the harness's.
A checkout of the port without the recorder has no spans to read: every
reading is then empty, and a reader gives None.
"""

from __future__ import annotations

import collections
import statistics

from port_bench import trace


def records(reading) -> list:
    """The port's span records that overlap the stretch ([] where the
    port has no recorder)."""
    try:
        from tpu_operator_libs_torch import tracing
    except ImportError:
        return []
    return tracing.records(reading.t0, reading.t1)


def idle_by_span(reading, found) -> "collections.Counter":
    """Device-idle seconds of the stretch by the innermost of the
    records ``found``, clipped to the stretch, open at each gap's middle
    ("no span" where none is)."""
    named = [(s.name, max(s.start, reading.t0), min(s.end, reading.t1))
             for s in found]
    idle = collections.Counter()
    cursor = reading.t0
    for start, end in trace.merged(reading.ops, reading.t0, reading.t1) + [
            (reading.t1, reading.t1)]:
        if start > cursor:
            idle[trace.open_span(named, (cursor + start) // 2)] += (
                start - cursor) / 1e9
        cursor = max(cursor, end)
    return idle


def idle_ms_a_request(reading, names) -> "float | None":
    """Device-idle milliseconds a traced request under the spans
    ``names``; None without a device operation recorded (no idle to
    name), without requests or without a span of those names."""
    requests = reading.work.get("requests")
    found = records(reading)
    if not reading.ops or not requests \
            or not any(s.name in names for s in found):
        return None
    idle = idle_by_span(reading, found)
    return 1e3 * sum(idle[name] for name in names) / len(requests)


def mean_device_ms(reading, name: str) -> "float | None":
    """The mean device milliseconds of the spans ``name`` whose host
    start lies in the stretch; None where there is none to read."""
    values = [s.device_ms for s in records(reading)
              if s.name == name and reading.t0 <= s.start <= reading.t1]
    values = [v for v in values if v is not None]
    return statistics.mean(values) if values else None

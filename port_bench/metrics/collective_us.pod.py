"""Microseconds of NCCL device time a collective: the NCCL kernels that
start inside the traced generations' ``decode.generate`` spans over the
tp collectives those generations launched, as the program counts them
(``generate_on_device.last_call["collectives"]``: prefill and every
step, replays included). None where the program does not count them."""

from port_bench import pod_trace, trace


def read(reading):
    counts = reading.counters.get("traced_collectives")
    if not counts or any(n is None for n in counts) or sum(counts) == 0:
        return None
    ops = pod_trace.inside_generations(reading)
    found = pod_trace.nccl(ops or [])
    if not found:
        return None
    return 1e6 * trace.device_seconds(found) / sum(counts)

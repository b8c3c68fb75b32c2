"""The NCCL kernels' share of the device time inside the traced
generations: their device seconds over all device operations' that
start inside a ``decode.generate`` span, in %."""

from port_bench import pod_trace, trace


def read(reading):
    ops = pod_trace.inside_generations(reading)
    if not ops:
        return None
    total = trace.device_seconds(ops)
    return 100.0 * trace.device_seconds(pod_trace.nccl(ops)) / total \
        if total > 0 else None

"""Device milliseconds a step of the optimizer's kernels: the AdamW
update and the clip's global norm, by kernel name, from the profiler."""

from port_bench import trace

PATTERN = r"adamw_kernel|global_norm_kernel"


def read(reading):
    ops = trace.matching(reading, PATTERN)
    steps = reading.work.get("steps")
    if not ops or not steps:
        return None
    return 1e3 * trace.device_seconds(ops) / steps

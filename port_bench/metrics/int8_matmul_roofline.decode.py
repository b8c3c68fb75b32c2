"""The int8-weight matmul's share of its roofline: the summed
``int8_bound`` of the calls the traced requests need (each layer's
seven projections over every new token, the head at the picked
position, prefill and every step) over the ``int8_matmul`` kernels'
device time."""

from port_bench import rooflines, trace

PATTERN = r"int8_matmul"


def read(reading):
    ops = trace.matching(reading, PATTERN)
    requests = reading.work.get("requests")
    if not ops or not requests:
        return None
    bound = sum(rooflines.request_int8_bound_s(reading.config, rows, length,
                                               reading.work["new_tokens"])
                for rows, length in requests)
    return 100.0 * bound / trace.device_seconds(ops)

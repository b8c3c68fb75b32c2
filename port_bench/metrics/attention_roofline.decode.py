"""The cached attention's share of its roofline: the summed bound of
every call the traced requests made (the prefill and each step, the
visible keys of the int8 cache read once) over the ``decode_attention``
kernels' device time."""

from port_bench import rooflines, trace

PATTERN = r"decode_attention"


def read(reading):
    ops = trace.matching(reading, PATTERN)
    requests = reading.work.get("requests")
    if not ops or not requests:
        return None
    bound = sum(rooflines.request_attention_bound_s(
        reading.config, rows, length, reading.work["new_tokens"])
        for rows, length in requests)
    return 100.0 * bound / trace.device_seconds(ops)

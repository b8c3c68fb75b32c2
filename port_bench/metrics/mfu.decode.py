"""The traced requests' least time over the wall time they took: for
each generation the least time of every forward call
(``rooflines.request_least_s``: the larger of its FLOPs over 989 TFLOP/s
and its bytes, the int8 weights and scales, the cache read and the cache
written, over 3.35 TB/s), summed, over the stretch from the first traced
generation's start to the last one's end."""

from port_bench import rooflines


def read(reading):
    requests = reading.work.get("requests")
    if not requests:
        return None
    least = sum(rooflines.request_least_s(reading.config, rows, length,
                                          reading.work["new_tokens"])
                for rows, length in requests)
    return 100.0 * least / reading.window_s

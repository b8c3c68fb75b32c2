"""The median over the window's requests of the milliseconds
``generate_on_device`` spent capturing its decode step's CUDA graph
(``generate_on_device.last_call["capture_ms"]``)."""

import statistics


def read(reading):
    captures = reading.counters.get("capture_ms")
    if not captures:
        return None
    return statistics.median(captures)

"""Share of the traced requests' wall time in which no operation ran on the
card: 1 - (union of the device operations' intervals / the stretch)."""

from port_bench import trace


def read(reading):
    if not reading.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s(reading) / reading.window_s)

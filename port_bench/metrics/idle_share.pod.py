"""Rank 0's idle share over the traced stretch, by ``idle_share.decode``'s
reader: 1 - (union of the device operations' intervals / the stretch),
in %."""

from port_bench import harness

_decode = harness.load_module("metrics", "idle_share.decode")


def read(reading):
    return _decode.read(reading)

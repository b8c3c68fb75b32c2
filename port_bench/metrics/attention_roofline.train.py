"""Flash attention's share of its roofline in the training step: the
summed least time of the forward and the backward at the step's shapes
(``rooflines.flash_train_bound_s``: two products forward, five backward,
each pass's bytes once) over the device time of every flash kernel
(forward, dK/dV, dQ) the traced steps ran."""

from port_bench import rooflines, trace

PATTERN = r"flash_(fwd|bwd)"


def read(reading):
    ops = trace.matching(reading, PATTERN)
    steps = reading.work.get("steps")
    if not ops or not steps:
        return None
    bound = steps * rooflines.flash_train_bound_s(
        reading.config, reading.work["batch"], reading.work["seq"])
    return 100.0 * bound / trace.device_seconds(ops)

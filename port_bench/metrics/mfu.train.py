"""The training step's share of the card's bf16 peak: the step's model
FLOPs (``rooflines.train_step_flops``) over the traced steps' wall time
per step times 989 TFLOP/s. The traced steps run between two
synchronizes, so their wall time is all of their work."""

from port_bench import rooflines


def read(reading):
    steps = reading.work.get("steps")
    if not steps:
        return None
    per_step = reading.window_s / steps
    flops = rooflines.train_step_flops(reading.config, reading.work["batch"],
                                       reading.work["seq"])
    return 100.0 * flops / (per_step * rooflines.PEAK_BF16_FLOPS)

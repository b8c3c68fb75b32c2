"""Device milliseconds of the training step's forward, the loss: the
mean over the traced steps (host start in the stretch) of the program's
``train.forward`` span, timed on the card by its two CUDA events."""

from port_bench import program_spans


def read(reading):
    return program_spans.mean_device_ms(reading, "train.forward")

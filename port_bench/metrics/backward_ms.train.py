"""Device milliseconds of the training step's backward
(``torch.autograd.grad``): the mean over the traced steps (host start in
the stretch) of the program's ``train.backward`` span, timed on the card
by its two CUDA events."""

from port_bench import program_spans


def read(reading):
    return program_spans.mean_device_ms(reading, "train.backward")

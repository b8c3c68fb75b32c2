"""Device-idle milliseconds a traced request while the program's
``decode.capture`` span (the decode step's CUDA graph captured and
instantiated) is the innermost program span open: the stretch's idle
gaps named by the port's spans (``program_spans``), over the traced
requests."""

from port_bench import program_spans

SPANS = ("decode.capture",)


def read(reading):
    return program_spans.idle_ms_a_request(reading, SPANS)

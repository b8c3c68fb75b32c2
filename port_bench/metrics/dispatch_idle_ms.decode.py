"""Device-idle milliseconds a traced request while the host dispatches a
generation's eager work: the program's ``decode.cache_alloc``,
``decode.prefill``, ``decode.first_pick`` or ``decode.eager_step`` span
is the innermost program span open (``program_spans``), over the traced
requests."""

from port_bench import program_spans

SPANS = ("decode.cache_alloc", "decode.prefill", "decode.first_pick",
         "decode.eager_step")


def read(reading):
    return program_spans.idle_ms_a_request(reading, SPANS)

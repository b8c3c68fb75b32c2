"""The rank's bf16 products' share of their roofline: the summed bound
of every forward call of the traced generations
(``rooflines_tp.request_bf16_bound_s``: the rank's weight blocks,
inputs and outputs at 3.35 TB/s, or the FLOPs at 989 TFLOP/s,
whichever is larger) over the device time of cuBLAS's kernels in the
stretch (``pod_trace.cublas``), in %."""

from port_bench import pod_trace, rooflines_tp, trace


def read(reading):
    ops = pod_trace.cublas(reading.ops)
    requests = reading.work.get("requests")
    tp = reading.work.get("tp")
    if not ops or not requests or not tp:
        return None
    bound = sum(rooflines_tp.request_bf16_bound_s(
        reading.config, tp, rows, length, reading.work["new_tokens"])
        for rows, length in requests)
    return 100.0 * bound / trace.device_seconds(ops)

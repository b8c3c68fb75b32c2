"""The median of ``DecodeServer.request_seconds`` over the window's
requests, in milliseconds: admission to readback as the server counts
it, the wait for its dispatch lock included."""

import statistics


def read(reading):
    served = reading.counters.get("request_seconds")
    if not served:
        return None
    return 1e3 * statistics.median(served)

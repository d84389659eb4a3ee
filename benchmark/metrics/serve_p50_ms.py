"""The median latency of the window's requests, the same requests as
``serve_p95_ms`` (the untraced window's), from the call to the numpy
result in hand."""

import statistics


def read(run):
    lat = run.counters.get("latencies")
    if not lat:
        return None
    return 1e3 * statistics.median(lat)

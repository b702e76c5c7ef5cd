"""The 95th percentile of all requests' latencies in the window (call to
return), in ms: the value below which 95% of them lie, interpolated
linearly between the two nearest (``statistics.quantiles``, inclusive)."""

import statistics


def read(run):
    lat = [r.latency_s for r in run.requests]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]

"""p95 of the query cells' request latency, submit to result, over every
query the window's clients sent and got answered (client loop)."""

import statistics


def read(ctx):
    lat = ctx["latencies_s"]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20)[-1] * 1e3

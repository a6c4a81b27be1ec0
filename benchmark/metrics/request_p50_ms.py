"""Median of a request's completion less its due time, over every request
due in the window."""

from benchmark.arrivals import percentile


def read(ctx):
    lat = ctx["record"].get("latencies_s")
    return None if not lat else percentile(lat, 50) * 1e3

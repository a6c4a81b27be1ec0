"""95th percentile of a request's completion less its due time, over every
request due in the window (one that failed or never came counts as
waiting until the loop's end)."""

from benchmark.arrivals import percentile


def read(ctx):
    lat = ctx["record"].get("latencies_s")
    return None if not lat else percentile(lat, 95) * 1e3

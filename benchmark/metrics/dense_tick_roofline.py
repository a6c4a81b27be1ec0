"""The least time of the dense tick work the traced window simulated
(benchmark/roofline.py ``dense_run_least_s``: every lane's ticks at the
active width) over the summed device time of every kernel in the window,
whatever its name."""

from benchmark.reference.dense import active_width
from benchmark.roofline import dense_run_least_s


def read(ctx):
    tr, fleets = ctx["trace"], ctx["record"].get("fleets")
    if tr is None or not fleets or tr["kernel_s"] <= 0:
        return None
    conf = ctx["conf"]
    a = active_width(conf)
    least = sum(dense_run_least_s(conf, a, f["lanes"]) for f in fleets)
    return least / tr["kernel_s"] * 100.0

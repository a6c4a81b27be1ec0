"""The least time of the overlay tick work the traced window simulated
(benchmark/roofline.py ``overlay_run_least_s``: each lane's 16-tick
launches, with the merges the lane received) over the summed device time
of every kernel in the window, whatever its name."""

from benchmark.roofline import overlay_run_least_s


def read(ctx):
    tr, fleets = ctx["trace"], ctx["record"].get("fleets")
    if tr is None or not fleets or tr["kernel_s"] <= 0 \
            or fleets[0]["recv"] is None:
        return None
    least = sum(overlay_run_least_s(ctx["conf"], f["recv"]) for f in fleets)
    return least / tr["kernel_s"] * 100.0

"""Simulated node-ticks a second: the configuration's N times the ticks
of every real lane of every fleet launched in the window, over the time
from the window's start to the last of them resolving."""


def read(ctx):
    rec = ctx["record"]
    if "node_ticks" not in rec or rec["span_s"] <= 0:
        return None
    return rec["node_ticks"] / rec["span_s"]

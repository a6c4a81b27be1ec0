"""Kernel launches the host made in the traced window (the profiler's
``cudaLaunch*`` / ``cuLaunch*`` calls) over the fleet ticks simulated
there."""


def read(ctx):
    tr, fleets = ctx["trace"], ctx["record"].get("fleets")
    if tr is None or not fleets or tr["launches"] == 0:
        return None
    return tr["launches"] / sum(f["ticks"] for f in fleets)

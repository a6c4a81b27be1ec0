"""Kernel launches the host made in the traced window (the profiler's
``cudaLaunch*`` / ``cuLaunch*`` calls) over the solo runs that completed
there."""


def read(ctx):
    tr, runs = ctx["trace"], ctx["record"].get("fleets")
    if tr is None or not runs or tr["launches"] == 0:
        return None
    return tr["launches"] / len(runs)

"""``FleetSimulation``'s host time (pack: staging and enqueueing; fetch:
the copy back and unstack) over the fleet ticks the window simulated
(a fleet tick advances every lane of a fleet by one tick)."""


def read(ctx):
    fleets = ctx["record"].get("fleets")
    if not fleets:
        return None
    host = sum(f["pack_s"] + f["fetch_s"] for f in fleets)
    return host / sum(f["ticks"] for f in fleets) * 1e3

"""The fleets' enqueue, from the program's ``fleet.enqueue`` spans (the
run's launches, a block on a full launch queue included), over the fleet
ticks the traced window simulated."""

from benchmark.program_spans import fleet_ms_per_tick


def read(ctx):
    return fleet_ms_per_tick(ctx, "fleet.enqueue")

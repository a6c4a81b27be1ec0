"""The fleets' fetch, from the program's ``fleet.fetch`` spans (after
the wait for the run: the copy back, the results unstacked), over the
fleet ticks the traced window simulated."""

from benchmark.program_spans import fleet_ms_per_tick


def read(ctx):
    return fleet_ms_per_tick(ctx, "fleet.fetch")

"""The fleets' staging, from the program's ``fleet.stage`` spans
(schedules built, stacked and copied, the initial state allocated), over
the fleet ticks the traced window simulated.  With
``fleet.enqueue_ms_per_tick`` and ``fleet.fetch_ms_per_tick`` it makes
``fleet.host_ms_per_tick``."""

from benchmark.program_spans import fleet_ms_per_tick


def read(ctx):
    return fleet_ms_per_tick(ctx, "fleet.stage")

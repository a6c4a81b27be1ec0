"""A solo run's staging, from the program's ``solo.stage`` spans (the
schedule, the initial state, the run closure with its segment plan, and
the packed plane), the mean over the traced window's runs."""

from benchmark.solo_spans import run_ms


def read(ctx):
    return run_ms(ctx, "solo.stage")

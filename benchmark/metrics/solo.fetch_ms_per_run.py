"""A solo run's fetch, from the program's ``solo.fetch`` spans (after the
wait for the device: the per-tick metrics copied to the host), the mean
over the traced window's runs."""

from benchmark.solo_spans import run_ms


def read(ctx):
    return run_ms(ctx, "solo.fetch")

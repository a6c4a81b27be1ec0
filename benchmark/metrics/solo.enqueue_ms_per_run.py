"""A solo run's enqueue, from the program's ``solo.enqueue`` spans (K5's
launches, the unpack and the metric rows behind them, a block on a full
launch queue included), the mean over the traced window's runs."""

from benchmark.solo_spans import run_ms


def read(ctx):
    return run_ms(ctx, "solo.enqueue")

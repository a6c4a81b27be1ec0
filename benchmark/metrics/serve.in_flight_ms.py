"""A request's time in flight, from the program's ``serve.in_flight``
spans (its dispatch's program enqueued to the service beginning to
resolve it: the stream wait behind earlier dispatches, the run, and the
wait until a displacement, harvest or flush collects it), the mean over
the requests the traced window's dispatches carried."""

from benchmark.program_spans import request_mean_ms


def read(ctx):
    return request_mean_ms(ctx, "serve.in_flight")

"""A request's wait in the service's queue, from the program's
``serve.queue`` spans (submission to its dispatch's first attempt), the
mean over the requests the traced window's dispatches carried."""

from benchmark.program_spans import request_mean_ms


def read(ctx):
    return request_mean_ms(ctx, "serve.queue")

"""The device time of the dispatch that carried a request, from the
program's ``fleet.device`` spans (CUDA events around the fleet's run),
the mean over the requests the traced window's dispatches carried.
``serve.in_flight_ms`` less this is the stream and collection wait."""

from benchmark.program_spans import request_mean_ms


def read(ctx):
    return request_mean_ms(ctx, "fleet.device")

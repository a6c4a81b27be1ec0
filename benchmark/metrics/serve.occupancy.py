"""Real lanes over dispatched (padded) lanes, over every dispatch that
served a request of the window, from each request's dispatch record
(``RequestMetrics.batch`` / ``padded_batch``)."""


def read(ctx):
    occ = ctx["record"].get("occupancy")
    return None if occ is None else occ * 100.0

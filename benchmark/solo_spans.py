"""The program's solo spans (``solo.stage``, ``solo.enqueue``,
``solo.fetch``, which ``OverlaySimulation.run`` records under one id a
run) as the solo cell's ``program_span`` metrics read them after a traced
window.

The program records while the profiler runs: the lead-in's run, then the
window's, so the window's records are the last ``len(record["fleets"])``
of each name (a run that raised records none).  A program without these
spans, or a window whose records are not all there, reads None.
"""

from __future__ import annotations

from benchmark.program_spans import _last, _ms, _spans


def run_ms(ctx: dict, name: str):
    """The mean milliseconds of ``name`` over the window's runs."""
    runs = ctx["record"].get("fleets")
    recs = _spans()
    if not runs or not recs:
        return None
    mine = _last(recs, name, len(runs))
    if mine is None:
        return None
    return sum(_ms(r) for r in mine) / len(mine)

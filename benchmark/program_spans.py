"""The program's own spans (``gossip_protocol_tpu_torch/utils/spans.py``)
as the ``program_span`` metrics read them after a traced window.

The program records while the profiler runs: the lead-in, then the
window, so the window's records are the last ones.  A sweep's window
holds the last ``len(record["fleets"])`` fleets; a served window the
last ``record["dispatches"]`` dispatches the service collected
(``serve.collect``), and the requests they carried (their
``serve.in_flight`` and ``serve.queue`` name the dispatch as parent).
A program without the recorder, or a window whose records are not all
there, reads None.
"""

from __future__ import annotations


def _spans():
    try:
        from gossip_protocol_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()["spans"]


def _last(recs: list, name: str, n: int):
    mine = [r for r in recs if r.name == name][-n:]
    return mine if len(mine) == n else None


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def fleet_ms_per_tick(ctx: dict, name: str):
    """Milliseconds of the window's ``name`` spans, one a fleet, over the
    fleet ticks the window simulated."""
    fleets = ctx["record"].get("fleets")
    recs = _spans()
    if not fleets or not recs:
        return None
    mine = _last(recs, name, len(fleets))
    if mine is None:
        return None
    return sum(_ms(r) for r in mine) / sum(f["ticks"] for f in fleets)


def request_mean_ms(ctx: dict, name: str):
    """The mean milliseconds, over the requests the window's dispatches
    carried, of each request's ``name`` span (``serve.queue``,
    ``serve.in_flight``) or, for a fleet span (``fleet.device``), of the
    one its dispatch launched."""
    n = ctx["record"].get("dispatches")
    recs = _spans()
    if not n or not recs:
        return None
    coll = _last(recs, "serve.collect", n)
    if coll is None:
        return None
    ids = {r.id for r in coll}
    riders = [r for r in recs if r.name == "serve.in_flight"
              and r.parent in ids]
    if name.startswith("fleet."):
        per = {r.parent: _ms(r) for r in recs if r.name == name
               and r.parent in ids}
        vals = [per[r.parent] for r in riders if r.parent in per]
        if len(vals) < len(riders):
            return None
    else:
        vals = [_ms(r) for r in recs if r.name == name and r.parent in ids]
    return sum(vals) / len(vals) if vals else None

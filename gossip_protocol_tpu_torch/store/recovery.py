"""Crash-restart recovery: rebuild a fleet service from its journal (port
of ``gossip_protocol_tpu/store/recovery.py``: it reads a run directory
of either package, and the meta record this package writes carries the
JAX key set, so the JAX package reads the port's).

``recover_service(run_dir)`` (surfaced as
``FleetService.recover(run_dir)``) replays the write-ahead journal of
a dead process on a fresh one:

1. **Service parameters** come from the journal's first ``meta``
   record (batching, pad policy, checkpoint cadence) — overridable by
   keyword, and wall-clock policies (deadlines, ``max_wait_s``) are
   never persisted, so the recovered service starts with none.
2. **Every non-terminal request is re-admitted** under its ORIGINAL
   rid (a submit record with no outcome record), queued but not
   pumped — the caller decides when dispatching resumes (``drain``,
   ``flush``, or per-handle ``result()``).
3. **Each re-admitted request resumes from its newest loadable
   spilled cut**: cut records are scanned newest-first and the first
   digest that fetches AND validates becomes the request's
   ``resume`` proxy (its bucket is the matching resume sub-bucket).
   A request whose every recorded cut is missing or corrupt falls
   back to tick 0 and — because checkpointed work was genuinely
   lost — counts ``restarted_lanes``; a request that never reached a
   cut re-admits from tick 0 without counting (no checkpoint ever
   existed).  The kill-and-restart gate therefore asserts
   ``restarted_lanes == 0`` end to end.
   ``mesh=`` recovers onto a port mesh (parallel/fleet_mesh.py): the
   spilled snapshots are host numpy, independent of any mesh, so the
   recovered lanes migrate onto it.
4. **The program cache is re-warmed** per distinct (bucket, mode)
   before the caller's first flush, so recovery pays compilation
   up front exactly like a fresh service's ``warm()``.

Requests that completed BEFORE the death are NOT re-run: their
outcome records carry result content digests
(service/replay.result_digest), which is how the acceptance harness
(store/harness.py) proves whole-run bit-parity across the kill.
"""

from __future__ import annotations

from ..config import SimConfig
from .journal import read_journal
from .spill import CheckpointValidationError

#: meta-record service parameters recovery forwards to the fresh
#: FleetService (everything else is either wall-clock policy or
#: caller-supplied)
_META_PARAMS = ("max_batch", "pad_policy", "pipeline",
                "pipeline_depth",
                "checkpoint_every", "checkpoint_every_s")


def recover_service(run_dir: str, mesh=None, store=None, warm=True,
                    device=None, **service_kw):
    """Rebuild a service (and its pending work) from ``run_dir``, on
    ``device`` (``cuda`` unless ``cpu``; the meta record's ``device`` is
    what the dead process ran on, not a choice for this one).

    Returns ``(service, handles)`` where ``handles`` maps each
    re-admitted rid to a live :class:`~..service.types.RequestHandle`.
    Nothing is dispatched yet — drive the service (``drain()`` /
    ``result()``) to resume the run.
    """
    from ..service.scheduler import FleetService
    from . import RunStore

    records = read_journal(run_dir)
    meta = next((r for r in records if r.get("rec") == "meta"), None)
    if meta is None:
        raise ValueError(
            f"journal under {run_dir} has no meta record — not a "
            f"fleet-service run directory")
    params = {k: v for k, v in meta.get("service", {}).items()
              if k in _META_PARAMS}
    params.update(service_kw)
    if store is None:
        store = RunStore(run_dir)
    svc = FleetService(mesh=mesh, store=store, device=device, **params)

    submits = {}
    terminal = set()
    cuts = {}
    for r in records:
        kind = r.get("rec")
        if kind == "submit":
            submits[r["rid"]] = r
        elif kind == "outcome":
            terminal.add(r["rid"])
        elif kind == "cut":
            cuts.setdefault(r["rid"], []).append(r)

    handles = {}
    resumed = 0
    for rid in sorted(submits):
        if rid in terminal:
            continue
        sub = submits[rid]
        cfg = SimConfig.from_dict(sub["cfg"])
        resume = None
        for cut in reversed(cuts.get(rid, ())):
            try:
                ck = store.checkpoints.fetch(cut["digest"])
            except (CheckpointValidationError, FileNotFoundError):
                continue  # fall back to the next-older cut
            if ck.cfg != cfg or int(ck.tick) != int(cut["tick"]):
                # the address resolves to a DIFFERENT lane's snapshot
                # (journal/spill drift) — as unusable as a corrupt one
                continue
            resume = store.checkpoints.ref(ck)
            break
        if resume is None and cuts.get(rid):
            # checkpointed work existed and none of it was loadable:
            # this lane genuinely restarts from tick 0
            svc._elastic["restarted_lanes"] += 1
        handles[rid] = svc._readmit(
            rid, cfg, sub["mode"], priority=sub.get("priority",
                                                    "default"),
            tenant=sub.get("tenant"), resume=resume)
        resumed += resume is not None
    store.recoveries += 1
    store.recovered_requests += len(handles)

    if warm and handles:
        warmed = set()
        for rid in sorted(handles):
            req = handles[rid].request
            base = FleetService._base_key(req.bucket)
            if (base, req.mode) in warmed:
                continue
            warmed.add((base, req.mode))
            svc.warm(req.cfg, req.mode)
    store.journal.recover_mark(resumed, len(handles),
                               warmed_buckets=len(svc.cache.keys()))
    return svc, handles

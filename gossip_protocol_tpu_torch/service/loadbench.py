"""Latency-under-load harness: the open-loop serving bench (port of
``gossip_protocol_tpu/service/loadbench.py``).

Every service here runs on ``device`` (``cuda`` unless ``cpu`` is
asked for), or on the entries of a port mesh (``mesh=``); the lane-mesh
load point serves from a 2-entry mesh on that device.

The closed-loop replay (service/replay.py) answers "how fast can the
service drain a fixed batch of work"; this module answers the question
the north star actually asks: **what latency does a request see at a
given offered load, and where does the service saturate?**  It drives
the pipelined scheduler with seeded open-loop arrival schedules
(service/traffic.py) at a swept ladder of offered loads and reports,
per load point, p50/p99 latency per priority class, per-class
deadline-miss rates, occupancy, shed counts, and how far submissions
fell behind schedule — plus the measured saturation point (the first
offered load the service cannot absorb).

Three probes, composed by :func:`load_openloop_bench` into the
``secondary.service_load_openloop`` entry of the JAX bench:

* :func:`sweep` — wall-paced load ladder (fractions of a measured
  closed-loop capacity probe), >= 4 points, each a fresh service over
  process-cached programs so points don't share stats windows;
* :func:`slo_ab` — the same schedule served twice at one load,
  deadline-aware early flush ON vs OFF (identical classes and
  deadlines both legs): the miss-rate delta is the SLO scheduler's
  measured value, not a modeling claim;
* :func:`replay_check` — the determinism gate: one seed driven twice
  through VIRTUAL pacing (service clock = the schedule's virtual
  clock, harvest pinned off, wall estimate pinned), arrival and
  outcome digests must match run-for-run — load runs are replayable
  regression tests, exactly like chaos runs.

Fault-free load runs hold the chaos plane's completion discipline:
every handle must be terminal after the drain, and the only tolerated
failures are the typed load outcomes (DeadlineExceeded expiry,
ShedRejection at admission).  Anything else raises — an engine error
must never be laundered into a "miss rate".  The bits are the JAX
package's: the virtual-paced arrival and outcome digests of
:func:`replay_check` equal the JAX harness's on the same seeds.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np

from .replay import Template, grader_templates, overlay_templates
from .resilience import DeadlineExceeded
from .scheduler import FleetService
from .slo import SLOPolicy, default_slo
from .traffic import (TrafficPattern, VirtualClock, make_schedule,
                      outcome_digest, run_schedule)


def load_catalog(n: int = 512, ticks: int = 96) -> list[Template]:
    """The mixed scenario catalog the load plane serves: the grader
    tier (exact dense N=10 course scenarios) + the overlay scale tier
    (fail / churn / drop10) — the same six templates as the replay
    acceptance stream, arriving open-loop instead of all at once."""
    return grader_templates() + overlay_templates(n=n, ticks=ticks)


def warm_service(svc: FleetService, templates: Sequence[Template]) -> None:
    """Compile + execute every distinct template's bucket program once
    (also seeds the per-bucket wall EWMAs the early flush reads)."""
    done = set()
    for tpl in templates:
        if tpl.name in done:
            continue
        done.add(tpl.name)
        svc.warm(tpl.cfg, tpl.mode)


def probe_capacity_rps(templates: Sequence[Template],
                       n_requests: int = 48, max_batch: int = 8,
                       seed: int = 0, warm_lap: bool = True,
                       mesh=None,
                       pipeline_depth: Optional[int] = None,
                       device=None) -> float:
    """Closed-loop burst probe: all ``n_requests`` at t=0, drain; the
    achieved completion rate is the service's max sustainable
    throughput for this catalog — the ladder's 1.0x anchor.  With
    ``warm_lap`` an untimed identical lap runs first (compilation and
    the first-lap trace/placement-cache costs are not steady-state
    serving)."""
    pattern = TrafficPattern(kind="closed", rate_rps=float(n_requests))
    laps = (0, 1) if warm_lap else (1,)
    rate = 0.0
    for lap in laps:
        svc = FleetService(max_batch=max_batch, mesh=mesh,
                           pipeline_depth=pipeline_depth, device=device)
        warm_service(svc, templates)
        sched = make_schedule(templates, n_requests, pattern,
                              seed=seed + lap)
        handles, rec = run_schedule(svc, sched, pace="wall")
        done = sum(1 for h in handles if h is not None and h.done
                   and not h.failed)
        rate = done / rec["wall_s"]
    return rate


def measure_point(templates: Sequence[Template], n_requests: int,
                  rate_rps: float, seed: int, slo: SLOPolicy,
                  kind: str = "poisson", max_batch: int = 8,
                  max_wait_s: Optional[float] = 8.0,
                  early_flush: Optional[bool] = None,
                  tenant_quota: Optional[int] = None,
                  max_queue_depth: Optional[int] = None,
                  mesh=None,
                  pipeline_depth: Optional[int] = None,
                  device=None) -> dict:
    """One wall-paced open-loop run at one offered load; returns the
    load point's row.  Raises on any non-terminal handle or any
    failure that is not a typed load outcome (deadline expiry /
    admission shed).  ``mesh`` serves the point from a lane mesh
    (``max_batch`` becomes per lane entry — pass ``total // D`` for
    equal-capacity comparisons against a D=1 point)."""
    eff_slo = slo if early_flush is None \
        else slo.with_early_flush(early_flush)
    pattern = TrafficPattern(kind=kind, rate_rps=rate_rps)
    sched = make_schedule(templates, n_requests, pattern, seed=seed,
                          class_mix=eff_slo.class_mix())
    svc = FleetService(max_batch=max_batch, max_wait_s=max_wait_s,
                       slo=eff_slo, tenant_quota=tenant_quota,
                       max_queue_depth=max_queue_depth, mesh=mesh,
                       pipeline_depth=pipeline_depth, device=device)
    # warm before the clock starts: programs are process-cached after
    # the capacity probe, but warm() also seeds the per-bucket wall
    # EWMAs the deadline-aware early flush reads — a cold estimate
    # would disable the SLO scheduler for the first dispatches
    warm_service(svc, templates)
    handles, rec = run_schedule(svc, sched, pace="wall")
    stats = svc.stats()

    submitted = [h for h in handles if h is not None]
    stranded = [h for h in submitted if not h.done]
    if stranded:
        raise RuntimeError(
            f"open-loop run left {len(stranded)} non-terminal handles "
            f"of {len(submitted)} (rate {rate_rps:.2f} rps, seed "
            f"{seed}); the drain guarantee is broken")
    bad = [h for h in submitted if h.failed
           and not isinstance(h.exception(), DeadlineExceeded)]
    if bad:
        raise RuntimeError(
            f"open-loop run had {len(bad)} non-deadline failures "
            f"(first: {bad[0].exception()!r}); engine errors must not "
            "be reported as load outcomes")

    completed = [h for h in submitted if h.done and not h.failed]
    expired = [h for h in submitted if h.failed]
    # per-class rows from the handles themselves (each point is a
    # fresh service, but handle-level accounting keeps the row
    # independent of stats windowing entirely)
    classes: dict[str, dict] = {}
    for a, h in zip(sched.arrivals, handles):
        c = classes.setdefault(a.priority, {
            "requests": 0, "completed": 0, "expired": 0, "shed": 0,
            "deadline_misses": 0, "_lat": []})
        c["requests"] += 1
        if h is None:
            c["shed"] += 1
            continue
        if h.failed:
            c["expired"] += 1
            c["deadline_misses"] += 1
            continue
        c["completed"] += 1
        c["_lat"].append(h.metrics.latency_s)
        if h.metrics.deadline_missed:
            c["deadline_misses"] += 1
    for c in classes.values():
        lat = np.asarray(c.pop("_lat"), dtype=np.float64)
        c["latency_p50_s"] = round(float(np.percentile(lat, 50)), 4) \
            if lat.size else 0.0
        c["latency_p99_s"] = round(float(np.percentile(lat, 99)), 4) \
            if lat.size else 0.0
        terminal = c["completed"] + c["expired"]
        c["deadline_miss_rate"] = \
            round(c["deadline_misses"] / terminal, 4) if terminal else 0.0

    lat_all = np.asarray([h.metrics.latency_s for h in completed],
                         dtype=np.float64)
    missed = sum(1 for h in completed if h.metrics.deadline_missed) \
        + len(expired)
    terminal = len(completed) + len(expired)
    return {
        "offered_rps": round(rate_rps, 3),
        "achieved_rps": round(len(completed) / rec["wall_s"], 3)
        if rec["wall_s"] > 0 else 0.0,
        "arrival_kind": kind,
        "requests": len(sched),
        "completed": len(completed),
        "expired": len(expired),
        "shed": len(rec["sheds"]),
        "latency_p50_s": round(float(np.percentile(lat_all, 50)), 4)
        if lat_all.size else 0.0,
        "latency_p99_s": round(float(np.percentile(lat_all, 99)), 4)
        if lat_all.size else 0.0,
        "deadline_miss_rate": round(missed / terminal, 4)
        if terminal else 0.0,
        "mean_occupancy": stats["mean_occupancy"],
        "pipeline_depth": stats["pipeline_depth"],
        "ring_stalls": stats["ring_stalls"],
        "slo_early_flushes": stats["slo_early_flushes"],
        "max_lag_s": round(rec["max_lag_s"], 3),
        "span_s": round(sched.span_s, 3),
        "wall_s": round(rec["wall_s"], 3),
        "classes": dict(sorted(classes.items())),
        "wfq_served": stats["wfq_served"],
    }


#: a load point saturates when it completes less than this fraction of
#: its offered rate...
SATURATION_FRAC = 0.9
#: ...AND its makespan overran the schedule span by this factor (a
#: backlog that outlived the arrivals).  The second condition matters:
#: every finite run pays a drain tail after the last arrival, and at
#: small request counts that tail alone pushes achieved below offered
#: even when the service is nowhere near saturated.
SATURATION_SPAN_RATIO = 1.2


def _saturated(row: dict) -> bool:
    return (row["achieved_rps"] < SATURATION_FRAC * row["offered_rps"]
            and row["wall_s"] > SATURATION_SPAN_RATIO * row["span_s"])


def sweep(templates: Sequence[Template], n_requests: int,
          capacity_rps: float, seed: int, slo: SLOPolicy,
          fracs: Sequence[float] = (0.25, 0.5, 0.75, 1.0, 1.5),
          **point_kw) -> dict:
    """The offered-load ladder: one :func:`measure_point` per fraction
    of the probed capacity (distinct seeds per point — distinct
    schedules, like the bench's distinct rep seeds), plus the measured
    saturation point: the first offered load the service could not
    absorb (:func:`_saturated` — completion rate below
    ``SATURATION_FRAC`` of offered AND the backlog outlived the
    arrival schedule)."""
    rows = []
    for i, f in enumerate(fracs):
        r = measure_point(templates, n_requests,
                          rate_rps=capacity_rps * f,
                          seed=seed + i, slo=slo, **point_kw)
        r["saturated"] = _saturated(r)
        rows.append(r)
    saturation = next((r["offered_rps"] for r in rows
                       if r["saturated"]), None)
    return {
        "capacity_probe_rps": round(capacity_rps, 3),
        "load_fracs": list(fracs),
        "points": rows,
        "saturation_offered_rps": saturation,
        "max_achieved_rps": max(r["achieved_rps"] for r in rows),
    }


def effective_saturation(row: dict) -> float:
    """A ladder's saturation point as a comparable number: the offered
    rps of the first saturated point, or +inf when the ladder never
    saturated (absorbing every offered load is strictly better than
    saturating at any finite one)."""
    sat = row.get("saturation_offered_rps")
    return float("inf") if sat is None else float(sat)


def depth_ladder(templates: Sequence[Template], n_probe: int,
                 n_point: int, seed: int, slo: SLOPolicy,
                 fracs: Sequence[float],
                 depths: Sequence[int] = (1, 2, 4),
                 max_batch: int = 8, device=None) -> dict:
    """The pipeline-depth measurement: the SAME open-loop ladder at
    pipeline depth 1 / 2 / 4.  One capacity probe (at depth 1) anchors
    the offered rates, and each point reuses the same seed across
    depths — identical arrival schedules, so the saturation shift is
    the depth's doing, not the schedule's.  Each row also records the
    depth's own closed-loop burst probe and the ring back-pressure
    (``ring_stalls``) the sweep's points accumulated."""
    cap = probe_capacity_rps(templates, n_requests=n_probe,
                             max_batch=max_batch, pipeline_depth=1,
                             device=device)
    rows = []
    for d in depths:
        closed = probe_capacity_rps(templates, n_requests=n_probe,
                                    max_batch=max_batch,
                                    pipeline_depth=d, device=device)
        sw = sweep(templates, n_point, cap, seed=seed, slo=slo,
                   fracs=fracs, max_batch=max_batch, pipeline_depth=d,
                   device=device)
        rows.append({
            "depth": d,
            "closed_loop_rps": round(closed, 3),
            "saturation_offered_rps": sw["saturation_offered_rps"],
            "max_achieved_rps": sw["max_achieved_rps"],
            "points": sw["points"],
        })
    return {"anchor_capacity_rps": round(cap, 3),
            "load_fracs": list(fracs), "rows": rows}


def slo_ab(templates: Sequence[Template], n_requests: int,
           rate_rps: float, seed: int, slo: SLOPolicy,
           ordering_ab: bool = True, wfq_ab: bool = True,
           wfq_weights=None, **point_kw) -> dict:
    """Deadline-aware batch formation ON vs OFF on the SAME schedule
    (same seed, same classes and deadlines — only the early-flush rule
    differs).  The report's ``improved`` is the acceptance gate:
    strictly fewer deadline misses with the SLO scheduler on.

    ``ordering_ab`` additionally runs the SAME schedule with
    deadline-aware DISPATCH ORDERING off (``SLOPolicy.class_ordering`` — ``pump()`` pops
    tightest-deadline-first instead of FIFO over buckets); the
    ``ordering`` block compares miss rates with ordering on (the
    early-flush ON leg, which carries it) vs off.  Recorded, not
    gated: at light load both legs can tie at zero misses.

    ``wfq_ab`` runs the SAME schedule once more with
    per-class WEIGHTED FAIR QUEUING (``SLOPolicy.weights``, default
    ``{"interactive": 8.0}``): the ``wfq`` block reports the
    interactive class's latency/miss under weighted vs
    tightest-deadline ordering plus each leg's per-class dispatched-
    lane shares (``wfq_served``) — the measured dispatch-share shift
    the knob buys.  Recorded, not gated, for the same light-load-tie
    reason.
    """
    on = measure_point(templates, n_requests, rate_rps, seed, slo,
                       early_flush=True, **point_kw)
    off = measure_point(templates, n_requests, rate_rps, seed, slo,
                        early_flush=False, **point_kw)
    out = {
        "offered_rps": round(rate_rps, 3),
        "on": on, "off": off,
        "miss_rate_on": on["deadline_miss_rate"],
        "miss_rate_off": off["deadline_miss_rate"],
        "improved": on["deadline_miss_rate"] < off["deadline_miss_rate"],
    }
    if wfq_ab:
        ic = "interactive" if "interactive" in slo.classes \
            else slo.default_class
        # explicit weights pass through unfiltered so SLOPolicy
        # validation rejects typo'd class names; the default targets
        # whichever class ``ic`` resolved to, so the weighted leg
        # always exercises a real weight
        weights = dict(wfq_weights) if wfq_weights is not None \
            else {ic: 8.0}
        wrow = measure_point(templates, n_requests, rate_rps, seed,
                             replace(slo, weights=weights),
                             early_flush=True, **point_kw)
        out["wfq"] = {
            "weights": weights,
            "miss_rate_weighted": wrow["deadline_miss_rate"],
            "miss_rate_unweighted": on["deadline_miss_rate"],
            "class_miss_weighted":
                wrow["classes"].get(ic, {}).get("deadline_miss_rate"),
            "class_miss_unweighted":
                on["classes"].get(ic, {}).get("deadline_miss_rate"),
            "class_p50_weighted":
                wrow["classes"].get(ic, {}).get("latency_p50_s"),
            "class_p50_unweighted":
                on["classes"].get(ic, {}).get("latency_p50_s"),
            "served_weighted": wrow["wfq_served"],
            "served_unweighted": on["wfq_served"],
        }
    if ordering_ab:
        no_order = measure_point(
            templates, n_requests, rate_rps, seed,
            replace(slo, class_ordering=False), early_flush=True,
            **point_kw)
        out["ordering"] = {
            "miss_rate_ordered": on["deadline_miss_rate"],
            "miss_rate_fifo": no_order["deadline_miss_rate"],
            "improved": on["deadline_miss_rate"]
            < no_order["deadline_miss_rate"],
            "no_worse": on["deadline_miss_rate"]
            <= no_order["deadline_miss_rate"],
        }
    return out


def replay_check(templates: Sequence[Template], n_requests: int,
                 rate_rps: float, seed: int, slo: SLOPolicy,
                 max_batch: int = 8,
                 max_wait_s: Optional[float] = 8.0,
                 assumed_wall_s: float = 0.5, runs: int = 2,
                 device=None) -> dict:
    """The load plane's replay gate: the same seed driven ``runs``
    times through VIRTUAL pacing must produce identical arrival AND
    outcome digests.  Determinism needs three pins (all documented in
    service/traffic.py): the service clock is the schedule's virtual
    clock, the idle harvest is off (``pump_harvest=False``), and the
    early-flush wall estimate is the policy's pinned value rather than
    a measured EWMA."""
    det_slo = replace(slo, assumed_dispatch_wall_s=assumed_wall_s)
    digests = []
    for _ in range(runs):
        vc = VirtualClock()
        svc = FleetService(max_batch=max_batch, max_wait_s=max_wait_s,
                           slo=det_slo, clock=vc, sleep=vc.sleep,
                           pump_harvest=False, device=device)
        warm_service(svc, templates)
        sched = make_schedule(templates, n_requests,
                              TrafficPattern(rate_rps=rate_rps),
                              seed=seed, class_mix=det_slo.class_mix())
        handles, rec = run_schedule(svc, sched, pace="virtual",
                                    clock=vc)
        digests.append((sched.digest(),
                        outcome_digest(sched, handles, rec["sheds"])))
    return {
        "seed": seed,
        "runs": runs,
        "arrival_digest": digests[0][0],
        "outcome_digest": digests[0][1],
        "deterministic": len(set(digests)) == 1,
    }


def load_openloop_bench(smoke: bool = False, seed: int = 20260804,
                        now=time.perf_counter, device=None) -> dict:
    """The whole open-loop story as one entry: capacity probe -> load
    ladder with saturation -> SLO A/B at a partial-batch load -> the
    virtual-clock determinism gate -> the pipeline-depth ladder -> the
    lane-mesh load point (2 entries on ``device``).  The caller adds
    the environment."""
    if smoke:
        templates = load_catalog(n=256, ticks=48)
        n_probe, n_point = 16, 24
        fracs = (0.3, 0.75, 1.1, 1.6)
    else:
        templates = load_catalog(n=512, ticks=96)
        n_probe, n_point = 48, 90
        fracs = (0.25, 0.5, 0.75, 1.0, 1.5)
    slo = default_slo()
    t0 = now()
    cap = probe_capacity_rps(templates, n_requests=n_probe, device=device)
    sw = sweep(templates, n_point, cap, seed=seed, slo=slo, fracs=fracs,
               device=device)
    # the A/B load: low enough that buckets stay partial (early flush
    # is the only way a latency-class request makes its deadline),
    # high enough that the stream is not trivial
    ab = slo_ab(templates, n_point, rate_rps=0.4 * cap, seed=seed + 100,
                slo=slo, device=device)
    rc = replay_check(templates, max(12, n_point // 3),
                      rate_rps=0.5 * cap, seed=seed + 200, slo=slo,
                      device=device)
    # the gates are ENFORCED, not just recorded: a bench json must not
    # quietly carry a regressed acceptance property
    if not rc["deterministic"]:
        raise RuntimeError(
            "open-loop replay check failed: the same seed produced "
            "different arrival/outcome digests across two virtual-"
            "paced runs — the load plane lost its determinism pins")
    if not smoke and not ab["improved"]:
        # smoke streams (24 requests over a fast catalog) are too
        # small to miss deadlines at all, so both legs tie at 0 there;
        # at full scale a tie or inversion is a real SLO regression
        raise RuntimeError(
            f"SLO A/B regression: deadline-miss rate with early flush "
            f"ON ({ab['miss_rate_on']}) is not strictly below OFF "
            f"({ab['miss_rate_off']}) at {ab['offered_rps']} rps")
    # the depth sweep: the same ladder at pipeline depth
    # 1/2/4 — the headline gate is that depth 2 holds off saturation
    # at least as long as depth 1 (enforced on full runs; smoke
    # ladders are too small to saturate meaningfully)
    ds = depth_ladder(templates, n_probe, max(12, n_point // 3),
                      seed=seed + 400, slo=slo, fracs=fracs, device=device)
    by_depth = {r["depth"]: r for r in ds["rows"]}
    if not smoke and 1 in by_depth and 2 in by_depth \
            and effective_saturation(by_depth[2]) \
            < effective_saturation(by_depth[1]):
        raise RuntimeError(
            f"depth-sweep regression: depth-2 saturates at "
            f"{by_depth[2]['saturation_offered_rps']} rps, below "
            f"depth-1's {by_depth[1]['saturation_offered_rps']} — "
            f"per-bucket rings must not LOWER the saturation point")
    entry = {
        "pattern": "poisson",
        "slo_classes": {name: {"deadline_s": c.deadline_s,
                               "weight": c.weight}
                        for name, c in slo.classes.items()},
        **sw,
        "slo_ab": ab,
        "replay_check": rc,
        "depth_sweep": ds,
        "bench_wall_s": round(now() - t0, 1),
    }
    # lane-mesh load point: the knee-load point once more, served from
    # a D=2 lane mesh at EQUAL total capacity (max_batch halves per
    # entry); on one card both entries are that card, so this measures
    # the mesh's host cost, not a second device
    from ..parallel.fleet_mesh import make_lane_mesh
    mesh = make_lane_mesh(2, device=device)
    mesh_row = measure_point(
        templates, max(12, n_point // 3), rate_rps=0.75 * cap,
        seed=seed + 300, slo=slo, max_batch=4, mesh=mesh)
    entry["mesh_point"] = {
        "devices": 2, "max_batch_per_device": 4,
        "entries": [str(d) for d in mesh.devices.flat], **mesh_row}
    return entry


# ---- compile-surface bench --------------------------------------------
#
# The scenario grammar (models/scenarios.py, 25 families over eight
# worlds) jittered per request drives the EXACT bucket key toward one
# fresh program build per request; canonical bucketing
# (service/canonical.py) must collapse that — measured, not assumed.
# The bench drives the SAME mixed schedule through a baseline
# (canonicalize=False) service lap, a cold canonical lap, and a warm
# canonical lap, and gates on: per-request BIT-IDENTITY between the
# laps (the exact lap is the solo-equivalent reference; a sample is
# additionally checked against direct solo execution), ZERO builds on
# the warm lap, and (full runs) a >= 3x fresh-build collapse.

#: dense phase-window jitter stays within one CHECKPOINT_GRID_TICKS
#: cell on most draws (so quantization gets to collapse it) but
#: occasionally crosses a grid line (so class splits are exercised too)
_JITTER_TICKS = 5


def jitter_request(cfg, rng):
    """One grammar request, jittered the way a real mixed stream is:
    peer count off the power-of-two rungs, phase windows off the grid,
    world parameters (drop probability, byz boost, latency, wave
    shape) perturbed per request.  Overlay configs pass through —
    their bucket is exact by design and seed jitter alone keeps it
    warm.  Every jitter axis is one the canonical key either absorbs
    (operands, ladder, quantization) or legitimately splits on
    (grid-line crossings, drop-on real n)."""
    if cfg.model == "overlay":
        return cfg
    from ..service.canonical import ladder_rung
    rung = ladder_rung(cfg.n)
    kw = {"max_nnb": int(rng.integers(rung // 2 + 2, cfg.n + 1))}
    j = lambda: int(rng.integers(0, _JITTER_TICKS))

    def win(lo, hi):
        lo2 = lo + j()
        return lo2, max(lo2 + 2, hi - j())
    if cfg.drop_msg:
        kw["msg_drop_prob"] = round(
            float(cfg.msg_drop_prob * rng.uniform(0.6, 1.4)), 4)
        kw["drop_open_tick"], kw["drop_close_tick"] = \
            win(cfg.drop_open_tick, cfg.drop_close_tick)
    if cfg.partition_groups >= 2:
        kw["partition_open_tick"], kw["partition_close_tick"] = \
            win(cfg.partition_open_tick, cfg.partition_close_tick)
    if cfg.flap_rate > 0 and cfg.flap_open_tick >= 0:
        # -1/-1 means the default (total-derived) flap window; leave it
        kw["flap_open_tick"], kw["flap_close_tick"] = \
            win(cfg.flap_open_tick, cfg.flap_close_tick)
    if not cfg.single_failure:
        kw["wave_tick"] = cfg.wave_tick + j()
        kw["wave_size"] = max(2, cfg.wave_size - int(rng.integers(0, 2)))
    elif cfg.fail_tick < cfg.total_ticks:
        kw["fail_tick"] = cfg.fail_tick + j()
    if cfg.byz_rate > 0:
        kw["byz_boost"] = max(2, cfg.byz_boost + int(rng.integers(-2, 3)))
    if cfg.link_latency > 0:
        kw["link_latency"] = max(1, cfg.link_latency
                                 + int(rng.integers(-1, 2)))
    return cfg.replace(**kw)


def compile_surface_schedule(n_requests: int, seed: int,
                             families=None) -> list:
    """The mixed composed-world schedule: ``n_requests`` configs drawn
    family-round-robin from the scenario grammar, each jittered by
    :func:`jitter_request` under one seeded rng — deterministic, so
    baseline and canonical laps serve the byte-identical stream."""
    from ..models.scenarios import CATALOG
    fams = [CATALOG[f] for f in (families or sorted(CATALOG))]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        fam = fams[i % len(fams)]
        out.append(jitter_request(fam.build(seed + i), rng))
    return out


def _surface_lap(svc: "FleetService", cfgs) -> tuple:
    """Submit the whole schedule, drain, return (digests, builds)."""
    from ..core.tick import run_build_count
    from ..models.scenarios import _lane_digest
    b0 = run_build_count()
    handles = [svc.submit(c, mode="trace") for c in cfgs]
    svc.drain()
    digests = [_lane_digest(c, h.result())
               for c, h in zip(cfgs, handles)]
    return digests, run_build_count() - b0


def compile_surface_bench(smoke: bool = False, seed: int = 20260807,
                          n_requests: Optional[int] = None,
                          max_batch: int = 4,
                          solo_every: int = 10,
                          now=time.perf_counter, device=None) -> dict:
    """Measure the compile-surface collapse on a jittered mixed
    schedule (the JAX bench's ``secondary.compile_surface`` entry).

    Three laps over the byte-identical schedule: baseline exact
    buckets (the pre-canonicalization compile surface), cold canonical
    buckets, warm canonical buckets (same service, same schedule
    again).  Gates enforced in-line, not just recorded:

    * every request's canonical result digest equals its baseline
      (exact-bucket) digest, and a deterministic sample is ALSO
      checked against direct solo execution — bit-identity is the
      honesty condition of the whole scheme;
    * the warm lap observes ZERO fresh builds (the steady-state
      serving claim);
    * full runs only: fresh builds collapse by >= 3x cold (smoke
      schedules are too small to gate a ratio on).
    """
    from ..core.tick import run_build_count
    from ..models.scenarios import CATALOG, _lane_digest
    if smoke:
        # the eight cheapest dense families still span drop / window /
        # operand jitter; 48 requests keep the baseline lap's build
        # bill (~one per request, the point) under a smoke budget
        families = ["dense_partition_blip", "dense_asym_drop",
                    "dense_wave", "dense_zombie", "dense_flapping",
                    "dense_latency", "dense_composed_part_flap",
                    "dense_composed_latency_flap"]
        n = 48 if n_requests is None else n_requests
    else:
        families = sorted(CATALOG)
        n = 200 if n_requests is None else n_requests
    cfgs = compile_surface_schedule(n, seed, families)
    t0 = now()

    from .bucket import bucket_key
    from .canonical import canonical_bucket_key
    exact_keys = {bucket_key(c, "trace") for c in cfgs}
    canon_keys = {canonical_bucket_key(c, "trace") for c in cfgs}

    base_svc = FleetService(max_batch=max_batch, device=device)
    base_digests, base_builds = _surface_lap(base_svc, cfgs)
    t_base = now()

    canon_svc = FleetService(max_batch=max_batch, canonicalize=True,
                             device=device)
    canon_digests, canon_builds = _surface_lap(canon_svc, cfgs)
    t_cold = now()
    stats_cold = canon_svc.stats()["cache"]
    hits0 = stats_cold["hits"] + stats_cold["misses"]

    warm_digests, warm_builds = _surface_lap(canon_svc, cfgs)
    stats_warm = canon_svc.stats()["cache"]
    lap2 = (stats_warm["hits"] + stats_warm["misses"]) - hits0
    warm_hit_rate = round(
        (stats_warm["hits"] - stats_cold["hits"]) / lap2, 4) \
        if lap2 else 0.0

    # ---- gates ----
    bad = [i for i, (a, b) in enumerate(zip(base_digests, canon_digests))
           if a != b]
    bad += [i for i, (a, b) in enumerate(zip(base_digests, warm_digests))
            if a != b]
    if bad:
        raise RuntimeError(
            f"canonical serving diverged from exact on request(s) "
            f"{sorted(set(bad))[:8]} of {n} — bit-identity is the "
            "precondition of bucket canonicalization")
    from .resilience import solo_execute
    solo_checked = 0
    for i in range(0, n, max(1, solo_every)):
        d = _lane_digest(cfgs[i], solo_execute(cfgs[i], "trace",
                                               device=canon_svc.device))
        if d != canon_digests[i]:
            raise RuntimeError(
                f"canonical result for request {i} diverged from its "
                f"direct solo run ({d} != {canon_digests[i]})")
        solo_checked += 1
    if warm_builds != 0:
        raise RuntimeError(
            f"warm canonical lap observed {warm_builds} fresh builds; "
            "steady-state serving must not recompile")
    collapse = round(base_builds / canon_builds, 2) \
        if canon_builds else float(base_builds)
    if not smoke and collapse < 3.0:
        raise RuntimeError(
            f"compile-surface collapse {collapse}x is below the 3x "
            f"gate (baseline {base_builds} builds, canonical "
            f"{canon_builds}) — canonicalization regressed")

    classes = canon_svc.cache.class_map()
    return {
        "requests": n,
        "families": len(families),
        "smoke": smoke,
        "buckets_exact": len(exact_keys),
        "buckets_canonical": len(canon_keys),
        "bucket_collapse_x": round(len(exact_keys)
                                   / max(len(canon_keys), 1), 2),
        "builds_baseline": int(base_builds),
        "builds_canonical": int(canon_builds),
        "build_collapse_x": collapse,
        "warm_builds": int(warm_builds),
        "warm_hit_rate": warm_hit_rate,
        "classes": len(classes),
        "max_class_members": max(
            (len(v["members"]) for v in classes.values()), default=0),
        "parity_ok": True,
        "solo_checked": solo_checked,
        "baseline_wall_s": round(t_base - t0, 1),
        "canonical_wall_s": round(t_cold - t_base, 1),
        "bench_wall_s": round(now() - t0, 1),
    }

"""Resilience machinery for the fleet service (port of
``gossip_protocol_tpu/service/resilience.py``): the policies and typed
errors that let the scheduler survive the fault plane (service/
faults.py) — and real failures — without ever stranding a request.

The contract this module exists to enforce: every
request popped for a dispatch reaches a TERMINAL state before the
dispatch returns — completed, completed-degraded (served by the
solo-run fallback), or failed with a typed error on its handle.
``FleetService._serve_batch`` drives this module's pieces:

* :class:`RetryPolicy` — bounded retries with exponential backoff and
  deterministic seeded jitter (replayable chaos runs need replayable
  backoff), capped so a retry storm cannot stall the service;
* deadlines — a request may carry an absolute deadline; expired
  requests fail fast with :class:`DeadlineExceeded` (queue expiry in
  ``pump``/``flush``, in-dispatch expiry between retries) and
  late-but-completed requests are *accounted* (``RequestMetrics.
  deadline_missed``), never silently dropped;
* :class:`CircuitBreaker` — per-bucket consecutive-failure breaker:
  an open bucket is quarantined (its dispatches go straight to the
  solo-run fallback, so one hot broken bucket cannot burn retries
  forever) and half-opens after a cooldown for one probe dispatch;
* admission control — a bounded queue sheds with the typed
  :class:`ShedRejection` at ``submit`` time, never by dropping a
  queued request;
* :func:`validate_lane` — cheap per-lane sanity (tick completeness,
  non-negative counters) that turns a poisoned result into a typed,
  retryable failure instead of a silently wrong answer;
* :func:`solo_run` — the degradation ladder's bottom rung: one
  request, one direct single-simulation run, no fleet program, no
  mesh.  It is the same execution the parity harness uses as its
  reference, so a degraded request is still served a correct result.

The degradation ladder, top to bottom: a fleet on the full mesh ->
the same on a shrunken mesh (service/scheduler.py ``_degrade_mesh``,
``parallel/fleet_mesh.py shrink_mesh``) -> a single-device fleet
(retried) -> solo run.
Each rung preserves correctness and sheds only throughput.  A solo
run that degrades a batch is counted (``stats()["failures"]``) and
never silent: the card's smoke run requires zero of them on its
fault-free paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


# ---- typed errors ----------------------------------------------------
class ServiceError(RuntimeError):
    """Base of every error the serving layer itself raises."""


class ShedRejection(ServiceError):
    """Admission refused: the service queue is at ``max_queue_depth``.

    Raised from ``submit()`` BEFORE a handle exists — the typed "try
    again later" of load shedding.  Nothing already queued is ever
    dropped to make room."""

    def __init__(self, pending: int, max_queue_depth: int):
        self.pending = pending
        self.max_queue_depth = max_queue_depth
        super().__init__(
            f"request shed: {pending} requests already queued >= "
            f"max_queue_depth={max_queue_depth}; drain or retry later")


class TenantQuotaExceeded(ShedRejection):
    """Admission refused for ONE tenant: it already holds
    ``tenant_quota`` queued requests (the per-tenant layer on top of
    ``max_queue_depth`` — one hot tenant cannot starve the queue).
    A ShedRejection, so callers that back off on global shedding
    handle it unchanged; nothing queued is ever dropped."""

    def __init__(self, tenant: str, queued: int, quota: int):
        self.tenant = tenant
        self.queued = queued
        self.quota = quota
        # ShedRejection's fields, for callers that read them generically
        self.pending = queued
        self.max_queue_depth = quota
        ServiceError.__init__(
            self, f"request shed for tenant {tenant!r}: {queued} "
            f"requests already queued >= tenant_quota={quota}; other "
            "tenants are unaffected")


class DeadlineExceeded(ServiceError):
    """The request's deadline passed before it could be served."""

    def __init__(self, rid: int, waited_s: float, budget_s: float):
        self.rid = rid
        self.waited_s = waited_s
        self.budget_s = budget_s
        super().__init__(
            f"request {rid} exceeded its deadline: waited "
            f"{waited_s:.3f}s of a {budget_s:.3f}s budget")


class PoisonedLaneError(ServiceError):
    """Per-lane validation failed on a dispatched result — the lane is
    corrupt (injected or real) and the dispatch must not complete."""

    def __init__(self, rid: int, why: str):
        self.rid = rid
        super().__init__(f"lane for request {rid} failed validation: "
                         f"{why}")


class BucketQuarantined(ServiceError):
    """The bucket's circuit breaker is open; batched dispatches are
    suspended and its requests ride the solo fallback."""

    def __init__(self, key: tuple):
        self.bucket = key
        super().__init__(
            f"bucket {key!r} is quarantined by its circuit breaker; "
            "requests are degraded to solo runs until the cooldown "
            "probe succeeds")


class DispatchFailed(ServiceError):
    """Terminal request failure: retries exhausted (and the solo
    fallback failed or was disabled).  ``__cause__`` carries the last
    underlying error."""

    def __init__(self, rid: int, attempts: int, last_error):
        self.rid = rid
        self.attempts = attempts
        super().__init__(
            f"request {rid} failed after {attempts} dispatch "
            f"attempt(s): {type(last_error).__name__}: {last_error}")


# ---- retry policy ----------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter.

    ``backoff_s(attempt)`` for attempt 1, 2, ... is
    ``base * factor**(attempt-1)`` capped at ``max_backoff_s``, times
    a deterministic jitter in ``[1 - jitter_frac, 1 + jitter_frac]``
    drawn from ``(seed, attempt, salt)`` — deterministic so chaos
    replays reproduce their own timing decisions, jittered so real
    deployments don't synchronize retry storms."""

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0

    def backoff_s(self, attempt: int, salt: int = 0) -> float:
        base = min(self.max_backoff_s,
                   self.backoff_base_s
                   * self.backoff_factor ** max(0, attempt - 1))
        if self.jitter_frac <= 0.0:
            return base
        rng = np.random.default_rng((self.seed, attempt, salt))
        return base * (1.0 + self.jitter_frac
                       * (2.0 * float(rng.random()) - 1.0))


# ---- circuit breaker -------------------------------------------------
@dataclass(frozen=True)
class BreakerPolicy:
    """Open a bucket after ``failure_threshold`` CONSECUTIVE failed
    dispatch attempts; half-open one probe after ``reset_after_s`` on
    the service clock."""

    failure_threshold: int = 3
    reset_after_s: float = 30.0


class CircuitBreaker:
    """Per-bucket consecutive-failure circuit breaker.

    closed -> (threshold consecutive failures) -> open: ``allow``
    returns False and the scheduler quarantines the bucket (solo
    fallback).  After ``reset_after_s``, ``allow`` grants ONE probe
    dispatch (half-open): success closes the breaker, failure
    re-opens it and restarts the cooldown."""

    def __init__(self, policy: BreakerPolicy):
        self.policy = policy
        self._state: dict = {}   # key -> {"fails": int, "opened_at": t}

    def _s(self, key):
        return self._state.setdefault(key, {"fails": 0, "opened_at": None})

    def allow(self, key, now: float) -> bool:
        s = self._s(key)
        if s["opened_at"] is None:
            return True
        return now - s["opened_at"] >= self.policy.reset_after_s

    def is_open(self, key, now: float) -> bool:
        return not self.allow(key, now)

    def record_failure(self, key, now: float) -> bool:
        """Count one failed attempt; returns True when this transition
        OPENS the breaker (re-arming an already-open breaker after a
        failed probe refreshes the cooldown but returns False)."""
        s = self._s(key)
        s["fails"] += 1
        if s["fails"] >= self.policy.failure_threshold:
            newly = s["opened_at"] is None
            s["opened_at"] = now
            return newly
        return False

    def record_success(self, key) -> None:
        self._state[key] = {"fails": 0, "opened_at": None}

    def open_buckets(self, now: float) -> int:
        return sum(1 for k in self._state if self.is_open(k, now))


# ---- lane validation -------------------------------------------------
def validate_lane(req, lane) -> Optional[str]:
    """Cheap sanity on one dispatched lane; returns the violation (or
    None).  Checks exactly the invariants every correct run satisfies
    — the full tick count executed, message counters non-negative —
    which is what a poisoned lane (service/faults.py) breaks.  Runs
    host-side on already-transferred arrays, so its cost is a scan of
    the per-lane counter stacks, not a device round-trip."""
    exp = req.cfg.total_ticks
    run = getattr(lane, "ticks_run", exp)
    if run != exp:
        return f"ran {run} of {exp} ticks"
    sent = np.asarray(lane.metrics.sent if hasattr(lane, "metrics")
                      else lane.sent)
    if sent.size and int(sent.min()) < 0:
        return "negative message counters"
    return None


def validate_checkpoint(req, ck) -> Optional[str]:
    """Per-lane sanity on a non-final resolved LEG: the snapshot's clock advanced and the leg's own output
    chunk carries sane counters — which is what a poisoned leg
    (service/faults.py) breaks.  A failing leg is retried from the
    PREVIOUS checkpoint, exactly like any other dispatch failure."""
    if ck.tick <= 0 or ck.tick > req.cfg.total_ticks:
        return f"checkpoint clock {ck.tick} outside (0, " \
               f"{req.cfg.total_ticks}]"
    if not ck.chunks:
        return "checkpoint carries no output chunks"
    chunk = ck.chunks[-1]
    sent = np.asarray(chunk.sent if hasattr(chunk, "sent")
                      else chunk[2])
    if sent.size and int(sent.min()) < 0:
        return "negative message counters in the checkpointed segment"
    return None


# ---- the degradation ladder's bottom rung ----------------------------
def solo_execute(cfg, mode: str, device=None):
    """ONE direct single-simulation execution — no fleet, no injector —
    on ``cuda`` unless ``device`` says ``cpu``.  This single
    implementation is shared by the degradation fallback
    (:func:`solo_run`), the replay harness's sequential parity leg
    (service/replay.py ``_solo_run``) and the scenario catalog's
    ``run_solo``, which is what makes "the solo fallback IS the parity
    reference" a structural fact rather than a convention two copies
    could drift out of.  Dense configs run ``Simulation.run_bench`` in
    bench mode and ``Simulation.run`` in trace mode; overlay configs
    run the per-tick route (K3 on a card), as the JAX package's
    ``OverlaySimulation(use_pallas=False)`` does."""
    if cfg.model == "overlay":
        from ..models.overlay import OverlaySimulation
        return OverlaySimulation(cfg, device=device, per_tick=True).run()
    from ..core.sim import Simulation
    sim = Simulation(cfg, device=device)
    return sim.run_bench() if mode == "bench" else sim.run()


def solo_run(req, device=None):
    """Serve one request by :func:`solo_execute` — the degradation
    ladder's bottom rung.  A degraded request still gets a correct
    (reference-grade) result; what it gives up is batched throughput,
    not fidelity.  (One visible difference for overlay requests: a
    solo run computes real ``live_uncovered`` coverage where fleet
    lanes report the kernels' -1 sentinel — which is why the chaos
    gate promises bit-parity for non-degraded requests and
    correctness for degraded ones.)"""
    return solo_execute(req.cfg, req.mode, device)


def solo_resume(req, device=None):
    """The bottom rung for a CHECKPOINTED request: resume the lane's
    solo continuation from its latest segment-boundary snapshot instead
    of re-running from tick 0, then stitch the accumulated chunks into
    the full-horizon result through the same assembly the fleet path
    uses (core/fleet.finish_lane) — so even a request that falls all
    the way down the ladder never loses checkpointed work, and its
    result stays bit-identical to an uninterrupted solo run (the
    schedule is closed-form in the carried clock).  The final state
    crosses to the host field by field."""
    import dataclasses as _dc

    from ..core.fleet import finish_lane
    from .faults import _host
    ck = req.resume
    if hasattr(ck, "load"):
        # durable serving: req.resume is a lightweight
        # store/spill.SpilledCheckpoint proxy — fetch the real
        # snapshot (RAM hit or validated disk reload)
        ck = ck.load()
    cfg = ck.cfg
    if cfg.model == "overlay":
        from ..models.overlay import (OverlaySimulation,
                                      overlay_state_from_host)
        state = overlay_state_from_host(
            {**ck.state, "tick": np.int32(ck.tick)}, device)
        res = OverlaySimulation(cfg, device=device, per_tick=True).run(
            resume_from=state)
        final = res.final_state
        chunk = res.metrics
    else:
        from ..core.sim import Simulation
        from ..state import state_from_host
        state = state_from_host({**ck.state, "tick": np.int32(ck.tick)},
                                device)
        res = Simulation(cfg, device=device).run(resume_from=state)
        final = res.final_state
        # solo SimResult counters are (N, T_segment); chunks ride (T, N)
        chunk = (res.added, res.removed, res.sent.T, res.recv.T)
    done = _dc.replace(
        ck, tick=cfg.total_ticks,
        state={f.name: _host(getattr(final, f.name))
               for f in _dc.fields(type(final)) if f.name != "tick"},
        chunks=list(ck.chunks) + [chunk],
        wall_seconds=ck.wall_seconds + res.wall_seconds,
        legs=ck.legs + 1, mesh_desc=None)
    return finish_lane(done)

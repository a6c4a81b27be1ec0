"""Seeded open-loop traffic generation for the serving layer (a host-only
copy of ``gossip_protocol_tpu/service/traffic.py``: the same per-index
draws, so a schedule's digest, and an outcome digest under
:class:`VirtualClock`, equal the JAX package's).

A CLOSED-loop replay submits every request, then flushes.  Closed loops systematically
understate latency under real arrival processes (Schroeder et al.,
"Open Versus Closed", NSDI'06): a closed loop's next request waits for
the previous one, so the system is never asked to absorb a burst it
didn't just finish serving.  This module is the open-loop side — a
request stream that arrives on ITS schedule, not the service's — with
the same discipline as the chaos plane: **every arrival is a pure
function of ``(seed, index)``** on a virtual clock, so a load run
replays digest-for-digest.

Arrival processes (:data:`ARRIVAL_KINDS`):

========  ============================================================
kind      arrival-time law (gaps are rate-modulated exponentials)
========  ============================================================
poisson   homogeneous Poisson at ``rate_rps``
burst     on/off modulation: ``burst_factor`` x the base rate for
          ``duty_cycle`` of each ``period_s``, proportionally quieter
          off-phase (the mean offered load stays ``rate_rps``)
diurnal   one sinusoidal "day" per ``diurnal_period_s`` (required —
          deriving it from the schedule length would make arrival
          times depend on ``n_requests``, breaking the prefix
          invariant below): rate swings ``1 +/- amplitude`` x the
          base, starting at the trough — the ramp-up / peak /
          ramp-down a real service sees
closed    every arrival at t=0 — the degenerate schedule that IS the
          closed-loop replay (service/replay.py), so the old harness
          is a special case of this plane, not a separate code path
========  ============================================================

Each arrival additionally draws — from the same per-index rng — its
scenario template (uniform over the catalog), its lane seed, its
priority class (weighted by the SLO policy's class mix), and its
tenant.  The draw for arrival *i* comes from a fresh
``numpy.random.default_rng((seed, i))``, never mutable RNG state, so
the i-th arrival is identical whatever was asked before it (the same
construction service/faults.py uses for fault schedules); arrival
TIMES are the prefix sums of those per-index gaps, so a schedule's
first k arrivals equal any longer schedule's first k.

Driving a service (:func:`run_schedule`):

* ``pace="wall"`` — the load-bench mode: arrivals are released when
  the real clock passes their scheduled time (never waiting for
  completions — open loop), with cooperative ``pump()`` polling
  between arrivals so time-based and deadline-aware flushes fire.
  Latency numbers are real; under saturation the single-threaded
  service submits late (dispatches block the loop) and the lag is
  reported, not hidden.
* ``pace="virtual"`` — the deterministic mode: the service runs on a
  :class:`VirtualClock` that run_schedule advances to each arrival's
  scheduled time.  Every scheduling decision (max-wait flushes,
  deadline expiry, SLO early flushes with a pinned wall estimate,
  fault draws) is then a pure function of the schedule, so two runs of
  one seed produce identical outcome digests — the replay gate for
  load runs, chaos included.  The service must be built with
  ``pump_harvest=False`` (or an active injector, which disables the
  harvest anyway): the idle in-flight harvest polls real device
  readiness, which would resolve batches — and stamp their virtual
  completion times — at wall-dependent points.
"""

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .replay import Template, build_trace
from .resilience import ShedRejection

#: the arrival-process kinds, in a stable order
ARRIVAL_KINDS = ("poisson", "burst", "diurnal", "closed")


@dataclass(frozen=True)
class TrafficPattern:
    """One arrival process configuration (see the module table)."""

    kind: str = "poisson"
    rate_rps: float = 8.0
    # burst (on/off) modulation
    burst_factor: float = 3.0
    duty_cycle: float = 0.25
    period_s: float = 8.0
    # diurnal sinusoid
    diurnal_amplitude: float = 0.75
    diurnal_period_s: Optional[float] = None

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}; "
                             f"expected one of {ARRIVAL_KINDS}")
        if self.rate_rps <= 0.0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if not 0.0 < self.duty_cycle < 1.0:
            raise ValueError(f"duty_cycle must be in (0, 1), got "
                             f"{self.duty_cycle}")
        if self.kind == "burst" \
                and not 1.0 <= self.burst_factor < 1.0 / self.duty_cycle:
            # off-phase rate = rate * (1 - duty*factor) / (1 - duty)
            # must stay STRICTLY positive (at factor == 1/duty it is
            # exactly 0 and the gap draw divides by it) for the mean
            # to remain rate_rps.  Only checked for burst patterns:
            # the coupled constraint is meaningless for kinds that
            # never read these fields
            raise ValueError(
                f"burst_factor must be in [1, 1/duty_cycle="
                f"{1.0 / self.duty_cycle:.3g}), got {self.burst_factor}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(f"diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        if self.period_s <= 0.0 or (self.diurnal_period_s is not None
                                    and self.diurnal_period_s <= 0.0):
            raise ValueError("period_s / diurnal_period_s must be > 0")
        if self.kind == "diurnal" and self.diurnal_period_s is None:
            # a default derived from the schedule length (span =
            # n/rate) would make arrival i's gap depend on how many
            # arrivals were ASKED for — breaking the pure-function-of-
            # (seed, index) prefix invariant every other kind keeps
            raise ValueError(
                "diurnal patterns need an explicit diurnal_period_s; "
                "a length-derived default would break the (seed, "
                "index) prefix invariant")

    def local_rate(self, t: float) -> float:
        """Instantaneous offered rate at virtual time ``t``."""
        if self.kind in ("poisson", "closed"):
            return self.rate_rps
        if self.kind == "burst":
            phase = (t % self.period_s) / self.period_s
            if phase < self.duty_cycle:
                return self.rate_rps * self.burst_factor
            return self.rate_rps * (1.0 - self.duty_cycle
                                    * self.burst_factor) \
                / (1.0 - self.duty_cycle)
        # start at the trough (-cos), peak mid-period: the day ramp
        return self.rate_rps * (1.0 - self.diurnal_amplitude
                                * math.cos(2.0 * math.pi * t
                                           / self.diurnal_period_s))


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: everything ``submit()`` needs, stamped
    with its virtual arrival time."""

    idx: int              # 1-based arrival index (the rng index)
    t_s: float            # virtual arrival time
    template: Template
    lane_seed: int
    priority: str
    tenant: str


@dataclass
class TrafficSchedule:
    """A fully-materialized arrival schedule (pure function of its
    seed + pattern + catalog; :meth:`digest` proves it)."""

    arrivals: list
    pattern: TrafficPattern
    seed: int

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def span_s(self) -> float:
        return self.arrivals[-1].t_s if self.arrivals else 0.0

    @property
    def offered_rps(self) -> float:
        """Realized offered load (arrivals over the realized span)."""
        return len(self.arrivals) / self.span_s if self.span_s > 0 \
            else float("inf")

    def digest(self) -> str:
        """Stable short hash of the whole arrival schedule — equal
        across two runs iff the same requests arrive at the same
        virtual times with the same template/seed/class/tenant."""
        items = [(a.idx, round(a.t_s, 9), a.template.name,
                  a.template.mode, a.lane_seed, a.priority, a.tenant)
                 for a in self.arrivals]
        return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def make_schedule(templates: Sequence[Template], n_requests: int,
                  pattern: TrafficPattern = TrafficPattern(),
                  seed: int = 0, class_mix: Optional[dict] = None,
                  tenants: Sequence[str] = ("acme", "globex",
                                            "initech", "umbrella")
                  ) -> TrafficSchedule:
    """Generate ``n_requests`` seeded arrivals over the catalog.

    All of arrival *i*'s draws (inter-arrival gap, template, priority
    class, tenant, lane seed) come from one fresh
    ``default_rng((seed, i))``; its arrival time is the prefix sum of
    the gaps.  ``class_mix`` is ``{class_name: weight}`` (e.g.
    ``SLOPolicy.class_mix()``); None means a single ``"standard"``
    class.
    """
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if not templates:
        raise ValueError("make_schedule needs a non-empty catalog")
    mix = class_mix if class_mix else {"standard": 1.0}
    names = tuple(mix)
    weights = np.asarray([mix[k] for k in names], dtype=np.float64)
    if weights.sum() <= 0.0:
        raise ValueError(f"class_mix weights must sum > 0, got {mix}")
    cum = np.cumsum(weights / weights.sum())
    t = 0.0
    arrivals = []
    for i in range(1, n_requests + 1):
        rng = np.random.default_rng((seed, i))
        u_gap, u_tpl, u_cls, u_ten = rng.random(4)
        if pattern.kind != "closed":
            t += -math.log1p(-u_gap) / pattern.local_rate(t)
        tpl = templates[min(int(u_tpl * len(templates)),
                            len(templates) - 1)]
        cls = names[min(int(np.searchsorted(cum, u_cls, side="right")),
                        len(names) - 1)]
        tenant = tenants[min(int(u_ten * len(tenants)),
                             len(tenants) - 1)]
        lane_seed = int(rng.integers(1, 1 << 31))
        arrivals.append(Arrival(idx=i, t_s=t if pattern.kind != "closed"
                                else 0.0, template=tpl,
                                lane_seed=lane_seed, priority=cls,
                                tenant=tenant))
    return TrafficSchedule(arrivals=arrivals, pattern=pattern, seed=seed)


def closed_schedule(templates: Sequence[Template],
                    seeds_per_template: int,
                    priority: str = "standard",
                    tenant: str = "replay") -> TrafficSchedule:
    """The closed-loop replay as a degenerate arrival schedule: the
    EXACT seed-major interleaving ``service.replay.build_trace``
    produces, every arrival at t=0 — so ``run_schedule`` over it is
    the closed-loop replay's serving leg expressed in the traffic plane."""
    arrivals = [Arrival(idx=i + 1, t_s=0.0, template=tpl,
                        lane_seed=s, priority=priority, tenant=tenant)
                for i, (tpl, s) in enumerate(
                    build_trace(templates, seeds_per_template))]
    return TrafficSchedule(
        arrivals=arrivals,
        pattern=TrafficPattern(kind="closed",
                               rate_rps=max(1.0, float(len(arrivals)))),
        seed=-1)


class VirtualClock:
    """A hand-advanced service clock for deterministic traffic runs.

    Pass it as ``FleetService(clock=vc, sleep=vc.sleep)``: every
    deadline, max-wait, and backoff decision then reads schedule time
    instead of wall time.  ``advance_to`` is monotone (a schedule's
    arrival times never rewind the clock)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, float(dt))


def run_schedule(svc, schedule: TrafficSchedule, pace: str = "wall",
                 clock: Optional[VirtualClock] = None,
                 sleep=time.sleep, poll_s: float = 0.002,
                 now=time.perf_counter):
    """Drive one open-loop schedule through a FleetService.

    Returns ``(handles, record)``: ``handles[i]`` is arrival *i*'s
    :class:`~.types.RequestHandle`, or None when admission shed it
    (global depth or tenant quota — recorded in
    ``record["sheds"]``).  The stream is OPEN loop: an arrival is
    released at its scheduled time whether or not earlier requests
    finished; the service is drained at the end, so every returned
    handle is terminal.

    ``record`` carries ``wall_s`` (schedule start to drain end, real
    time under ``"wall"`` pacing / the schedule span under
    ``"virtual"``), ``sheds`` (``(idx, error_type, priority,
    tenant)``), and ``max_lag_s`` — how far submissions fell behind
    schedule (wall pacing only; the cooperative single-threaded
    service submits late when dispatch walls exceed arrival gaps,
    which is exactly what saturation looks like here).
    """
    if pace not in ("wall", "virtual"):
        raise ValueError(f"unknown pace {pace!r}; expected 'wall' or "
                         "'virtual'")
    handles, sheds = [], []

    def _submit(a: Arrival):
        try:
            h = svc.submit(a.template.cfg, seed=a.lane_seed,
                           mode=a.template.mode, priority=a.priority,
                           tenant=a.tenant)
        except ShedRejection as e:
            sheds.append((a.idx, type(e).__name__, a.priority, a.tenant))
            return None
        return h

    if pace == "virtual":
        vclock = clock if clock is not None else svc.clock
        if not isinstance(vclock, VirtualClock) or svc.clock is not vclock:
            raise ValueError(
                "virtual pacing requires the service to run on the "
                "loop's VirtualClock (FleetService(clock=vc, "
                "sleep=vc.sleep))")
        if svc._harvest_enabled():
            raise ValueError(
                "virtual pacing requires pump_harvest=False (or an "
                "active injector): the idle in-flight harvest polls "
                "real device readiness, which would stamp virtual "
                "completion times at wall-dependent points")
        if svc.slo is not None and svc.slo.early_flush \
                and svc.slo.assumed_dispatch_wall_s is None:
            raise ValueError(
                "virtual pacing with deadline-aware early flush "
                "requires SLOPolicy(assumed_dispatch_wall_s=...): the "
                "measured per-bucket wall EWMA differs run to run, so "
                "an unpinned estimate would early-flush at "
                "wall-dependent points and break digest replayability")
        for a in schedule.arrivals:
            vclock.advance_to(a.t_s)
            handles.append(_submit(a))
        svc.drain()
        record = {"pace": pace, "wall_s": schedule.span_s,
                  "sheds": sheds, "max_lag_s": 0.0}
        return handles, record

    t0 = now()
    max_lag = 0.0
    for a in schedule.arrivals:
        while True:
            dt = a.t_s - (now() - t0)
            if dt <= 0.0:
                break
            svc.pump()          # time-based / SLO flushes + harvest
            dt = a.t_s - (now() - t0)
            if dt > 0.0:
                sleep(min(poll_s, dt))
        max_lag = max(max_lag, (now() - t0) - a.t_s)
        handles.append(_submit(a))
    svc.drain()
    record = {"pace": pace, "wall_s": now() - t0, "sheds": sheds,
              "max_lag_s": max_lag}
    return handles, record


def outcome_digest(schedule: TrafficSchedule, handles: list,
                   sheds: list) -> str:
    """Stable short hash of every arrival's terminal outcome —
    status (typed error name for failures), class, tenant, and the
    deadline-missed flag — the load plane's counterpart of the chaos
    plane's ``outcome_digest``.  Every handle must be terminal (run
    after run_schedule's drain)."""
    shed_idx = {s[0]: s for s in sheds}
    items = []
    for a, h in zip(schedule.arrivals, handles):
        if h is None:
            items.append((a.idx, "shed:"
                          + shed_idx.get(a.idx, (0, "?"))[1],
                          a.priority, a.tenant, None))
            continue
        if not h.done:
            raise RuntimeError(
                f"outcome_digest on a non-terminal handle (rid "
                f"{h.request.rid}, status {h.status}); drain first")
        if h.failed:
            items.append((a.idx, "failed:" + type(h.exception()).__name__,
                          a.priority, a.tenant, None))
        else:
            items.append((a.idx, h.status, a.priority, a.tenant,
                          bool(h.metrics.deadline_missed)))
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]

"""Continuous-batching request scheduler for simulation serving (port of
``gossip_protocol_tpu/service/scheduler.py``).

The engine is core/fleet.py: B same-shape simulations through ONE fleet
run (the dense K1 route with a lane axis, K5's lane axis for the
overlay).  This module is the layer every inference stack puts above
such an engine (Orca's iteration-level scheduler, vLLM's waiting /
running queues): it accepts a *stream* of heterogeneous requests and
keeps the batched engine fed, sized to this framework's unit of work —
a whole simulation run, so batches form per request stream:

* **admission** — ``submit()`` validates the mode, stamps the request,
  and enqueues it under its shape bucket (service/bucket.py: shape
  key + segment-plan signature + mode); heterogeneous streams coexist
  as parallel queues rather than poisoning one batch.
* **flush policies** — a bucket dispatches when it has ``max_batch``
  requests, when its oldest request has waited ``max_wait_s``, when
  an SLO deadline says it must go now, or when
  ``flush()``/``drain()``/``result()`` forces it.
* **padding** — a partial batch is padded to the bucket's width with
  inert filler lanes (replicas of the bucket's first config) so one
  program per bucket serves every dispatch; filler is never unstacked
  (core/fleet.py ``n_real``), so results stay bit-identical to solo
  runs.
* **program cache** — bucket key -> FleetSimulation (service/cache.py)
  with hit/miss/build counters over ``core.tick.run_build_count``.
* **pipelining** — a dispatch stages its batch, waits for the oldest
  in-flight batch of its ring only when the ring is full, enqueues its
  own run and then resolves the displaced batch, so host staging
  overlaps the card's work.  Readiness is a CUDA event query
  (``PendingFleet.is_ready``), never a synchronization.
* **metrics** — per-request queue wait / run wall / latency, per-
  dispatch occupancy and pack / device-wait / fetch seconds, and
  service aggregates via :meth:`FleetService.stats`.

The service is synchronous and single-threaded by design: requests
are admitted from one host loop and time-based flushes happen
cooperatively inside ``submit``/``pump``.

Failure model (docs/SERVING.md "Failure model"): dispatching is
ATOMIC — every request popped for a dispatch reaches a terminal state
(completed, degraded to a solo run, or failed with a typed error on
its handle) before the dispatch returns.  The machinery is
service/resilience.py (bounded retry with seeded backoff, deadlines,
a per-bucket circuit breaker, queue-depth admission control), driven
deterministically by the seeded fault plane in service/faults.py.
Every retry and degraded request is counted in ``stats()["failures"]``
and the last errors are kept in ``stats()["last_errors"]``, so a
fallback is never silent.

Checkpointed serving: ``checkpoint_every=`` serves long dispatches as
RESUMABLE LEGS — each leg ends at a segment cut
(models/segments.cut_for_budget), the fleet carry is snapshotted to
host numpy (core/fleet.py ``launch_leg``/``LaneCheckpoint``), and the
batch re-queues under a resume sub-bucket, so any failure retries from
the last checkpoint, never tick 0 (even the solo fallback resumes,
``solo_resume``).  With ``run_dir=`` every decision is journaled and
every cut spilled (store/), and ``FleetService.recover`` rebuilds the
run in a fresh process.

Serving from a mesh (``mesh=``, a port mesh from parallel/fleet_mesh.py:
1-D lanes, or 2-D lanes x peers): a dispatch spreads its lanes over the
lane axis (capacity ``max_batch`` x lanes, widths padded to a multiple
of it), and a device loss shrinks the mesh one rung (the peer axis
halves first; ``shrink_mesh``), a device return grows it back
(``grow_mesh``), the program cache re-keying along the ladder.  Queued
and checkpointed lanes migrate across every rebuild: their snapshots are
host numpy, independent of the mesh.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import SimConfig
from ..core.fleet import FleetLeg
from ..core.tick import run_build_count
from ..models.segments import cut_for_budget
from ..state import resolve_device
from ..utils import spans
from .bucket import bucket_key, pad_configs
from .cache import ProgramCache
from .faults import FaultInjector, InjectedCompileFailure, \
    InjectedDeviceLoss, InjectedDispatchFailure
from .resilience import (BreakerPolicy, BucketQuarantined, CircuitBreaker,
                         DeadlineExceeded, DispatchFailed,
                         PoisonedLaneError, RetryPolicy, ShedRejection,
                         TenantQuotaExceeded, solo_resume, solo_run,
                         validate_checkpoint, validate_lane)
from .slo import SLOPolicy
from .types import MODES, RequestHandle, RequestMetrics, SimRequest

#: padding policies: "full" pads every dispatch to ``max_batch`` (one
#: compiled width — and so at most one build — per bucket); "pow2"
#: pads to the next power of two (less filler work, up to
#: log2(max_batch)+1 widths per bucket); "none" never pads (a width
#: per distinct batch size).
PAD_POLICIES = ("full", "pow2", "none")


def _ns(t: float) -> int:
    """Seconds of the service's clock as the nanoseconds of a span."""
    return round(t * 1e9)


@dataclass
class _Inflight:
    """One launched-but-unresolved dispatch (one slot of a bucket's
    in-flight ring): the device program is running; the host is free
    to pack the next bucket.  Resolution (block + fetch + validate +
    complete the handles) happens when a later dispatch displaces this
    slot from a full ring, or at the end of a ``flush``/``drain`` — a
    deterministic schedule, so chaos replays stay a pure function of
    submit order."""

    key: tuple
    reqs: list = field(repr=False)
    pending: object = field(repr=False)   # core.fleet.PendingFleet
    width: int
    idx: int                              # fault-plane attempt index
    fault: Optional[str]
    builds: int                           # whole-run builds at launch
    t_q0: float
    #: the program enqueued and its resolution begun, on the service's
    #: clock (read only while spans record, utils/spans.py)
    t_enq: Optional[float] = None
    t_r: Optional[float] = None


class FleetService:
    """Continuous-batching scheduler over :class:`FleetSimulation`, on
    ``cuda`` unless ``device="cpu"``.

    >>> svc = FleetService(max_batch=8)
    >>> handles = [svc.submit(cfg, seed=s) for s in range(20)]
    >>> svc.drain()
    >>> results = [h.result() for h in handles]   # SimResult per request

    ``max_wait_s`` bounds queueing latency under trickle traffic; it
    is enforced cooperatively (checked on every ``submit``/``pump``
    against ``clock()``), not by a background thread.  ``mesh`` (a 1-D
    lane mesh, ``parallel.fleet_mesh.make_lane_mesh``, or a 2-D lanes x
    peers mesh, ``make_lane_peer_mesh``) serves every dispatch from the
    whole mesh: capacity is ``max_batch`` x the lane axis, each
    simulation's peer tables additionally shard over a 2-D mesh's peer
    axis where its width divides it, and the mesh's first entry is the
    service's device.
    """

    def __init__(self, max_batch: int = 8,
                 max_wait_s: Optional[float] = None,
                 pad_policy: str = "full",
                 chunk_ticks: Optional[int] = None, clock=time.perf_counter,
                 stats_window: int = 1 << 14, mesh=None,
                 cache_max_entries: Optional[int] = 64,
                 injector: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 degrade_to_solo: bool = True, sleep=time.sleep,
                 pipeline: Optional[bool] = None,
                 pipeline_depth: Optional[int] = None,
                 slo: Optional[SLOPolicy] = None,
                 tenant_quota: Optional[int] = None,
                 pump_harvest: Optional[bool] = None,
                 checkpoint_every: Optional[int] = None,
                 checkpoint_every_s: Optional[float] = None,
                 canonicalize: bool = False,
                 store=None, run_dir: Optional[str] = None,
                 device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if pad_policy not in PAD_POLICIES:
            raise ValueError(f"unknown pad_policy {pad_policy!r}; "
                             f"expected one of {PAD_POLICIES}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1 or None, "
                             f"got {max_queue_depth}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(f"tenant_quota must be >= 1 or None, "
                             f"got {tenant_quota}")
        if checkpoint_every is not None and checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1 or None, "
                             f"got {checkpoint_every}")
        if checkpoint_every_s is not None and checkpoint_every_s <= 0:
            raise ValueError(f"checkpoint_every_s must be > 0 or None, "
                             f"got {checkpoint_every_s}")
        if checkpoint_every is not None and checkpoint_every_s is not None:
            raise ValueError("checkpoint_every (ticks) and "
                             "checkpoint_every_s (seconds) are two "
                             "spellings of one budget; set at most one")
        if canonicalize and (checkpoint_every is not None
                             or checkpoint_every_s is not None):
            from .canonical import CanonicalLegUnsupported
            raise CanonicalLegUnsupported(
                "canonicalize is incompatible with checkpointed "
                "serving: legs validate resume cuts against the EXACT "
                "segment plan, which canonical buckets quantize away "
                "(docs/SERVING.md 'Bucket canonicalization')")
        # validate the mesh shape early (a typed constructor error) and
        # learn the axis decomposition the service speaks below
        if mesh is not None:
            from ..parallel.fleet_mesh import mesh_axis_sizes
            n_lanes, n_peers, _ = mesh_axis_sizes(mesh)
            device = mesh.devices.flat[0]
        else:
            n_lanes, n_peers = 1, 1
        if canonicalize and n_peers & (n_peers - 1):
            raise ValueError(
                f"canonicalize over a mesh needs a power-of-two peer "
                f"axis: the pad ladder doubles, so only pow2 "
                f"peer-shard counts have peer-divisible rungs; got "
                f"{n_peers} peers")
        #: the card (or the CPU) every dispatch and solo fallback runs on
        #: (a mesh's first entry)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pad_policy = pad_policy
        self.mesh = mesh
        #: the CURRENT rung's axis decomposition (``_degrade_mesh`` /
        #: ``_grow_mesh`` move it): ``n_lanes`` batch shards x
        #: ``n_peers`` peer-table shards
        self.n_lanes = n_lanes
        self.n_peers = n_peers
        self.n_devices = mesh.size if mesh is not None else 1
        #: the full-strength entries, shape and axes, captured at
        #: construction: the top rung ``grow_mesh`` re-extends toward
        self._full_devices = tuple(mesh.entries()) \
            if mesh is not None else None
        self._full_shape = tuple(mesh.devices.shape) \
            if mesh is not None else None
        self._full_axes = tuple(mesh.axis_names) \
            if mesh is not None else None
        #: canonical pad-ladder multiple: the FULL-STRENGTH peer count,
        #: pinned so an elastic peer-shard shrink never moves a
        #: request's canonical bucket key mid-stream
        self._canon_peers = n_peers
        #: segment budget (ticks) above which a dispatch runs as
        #: RESUMABLE LEGS: each leg ends at a
        #: segment cut (models/segments.cut_for_budget), the fleet
        #: carry is snapshotted host-side, and the batch re-queues as
        #: resume-requests — so a failure mid-sequence loses at most
        #: one leg, never the run.  None (default): monolithic
        #: dispatches.  Dense bench-mode requests are always
        #: monolithic (their run fixes the active-corner width).
        self.checkpoint_every = checkpoint_every
        #: wall-clock-triggered checkpoints:
        #: a SECONDS budget converted to a tick budget per bucket via
        #: the measured wall-seconds-per-tick EWMA (``_tick_wall``,
        #: seeded by ``warm()``, updated on every dispatch from CLOCK
        #: deltas — the injected ``clock``, so a virtual/fake clock
        #: keeps the budget a deterministic pure function of the clock
        #: program) and then snapped to a legal segment cut by
        #: ``cut_for_budget`` exactly like the tick spelling.  A
        #: bucket with no wall measurement yet dispatches monolithic
        #: (warm() seeds the estimate, so warmed buckets never do).
        self.checkpoint_every_s = checkpoint_every_s
        #: canonical bucketing (service/canonical.py): requests queue and batch under
        #: EQUIVALENCE-CLASS keys — peer counts quantized to pad-ladder
        #: rungs, phase windows to the checkpoint grid, world
        #: parameters demoted to runtime operands — so a jittered
        #: mixed stream builds one program per CLASS instead of one
        #: per distinct config.  Modes canonicalization does not serve
        #: (overlay, bench) fall back to exact buckets per request.
        self.canonicalize = canonicalize
        self.clock = clock
        self.cache = ProgramCache(chunk_ticks=chunk_ticks, mesh=mesh,
                                  max_entries=cache_max_entries,
                                  device=self.device,
                                  canon_rung_multiple=self._canon_peers)
        # failure plane: the (optional) deterministic fault injector
        # and the machinery that survives it (service/resilience.py)
        self.injector = injector
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = CircuitBreaker(breaker if breaker is not None
                                      else BreakerPolicy())
        self.max_queue_depth = max_queue_depth
        self.default_deadline_s = default_deadline_s
        self.degrade_to_solo = degrade_to_solo
        self._sleep = sleep
        #: the SLO plane (service/slo.py): priority classes with
        #: per-class default deadlines, and — when
        #: ``slo.early_flush`` — deadline-aware batch formation: pump
        #: flushes a partial bucket early when its tightest deadline
        #: minus the bucket's estimated dispatch wall says it must go
        #: now to make it
        self.slo = slo
        #: per-tenant admission quota, layered on ``max_queue_depth``:
        #: a tenant already holding this many QUEUED requests sheds
        #: with the typed TenantQuotaExceeded (a ShedRejection) —
        #: queued work is never dropped, and one hot tenant cannot
        #: starve the rest of the queue
        self.tenant_quota = tenant_quota
        #: the idle in-flight harvest in ``pump()`` polls real device
        #: readiness — wall-time-dependent by nature.  None (default):
        #: enabled exactly when no injector is active; False pins it off for deterministic virtual-clock
        #: traffic runs (service/traffic.py) even without an injector
        self.pump_harvest = pump_harvest
        #: pipelined dispatch (default ON, per-bucket rings): a dispatch
        #: STAGES its batch, waits for the oldest in-flight batch in
        #: its ring ONLY when the ring is full, dispatches its own
        #: program, and only then fetches + completes the displaced
        #: batch — so staging overlaps earlier executions, fetching
        #: overlaps the next.  ``False`` is the
        #: synchronous beat (launch + resolve inside each dispatch) —
        #: kept because its un-overlapped timing is the clean
        #: device-wait-fraction measurement (under overlap the host
        #: columns are measured at their contended values even though
        #: they are hidden).
        self.pipeline = True if pipeline is None else bool(pipeline)
        if pipeline_depth is not None and int(pipeline_depth) < 1:
            raise ValueError(f"pipeline_depth must be >= 1 or None, "
                             f"got {pipeline_depth}")
        #: in-flight ring depth: how many launched-but-
        #: unresolved batches each BUCKET may hold.  At depth 1 every
        #: bucket shares ONE service-wide slot — bit-compatible with
        #: the single-slot beat (stage, wait previous, start, resolve
        #: previous), so depth-1 replays are digest-identical to the
        #: single-slot scheduler.  At depth >= 2 each bucket owns its
        #: own ring: independent buckets overlap on the device instead
        #: of serializing through one beat, and a bucket's own
        #: dispatches stack ``pipeline_depth`` deep before the oldest
        #: is waited on — hiding the residual per-dispatch host work
        #: behind that many executions.
        self.pipeline_depth = 2 if pipeline_depth is None \
            else int(pipeline_depth)
        #: the in-flight rings: ring key -> FIFO deque of _Inflight
        #: (oldest launched first).  Ring key is ``()`` (one shared
        #: ring) at depth 1, the queue/bucket key at depth >= 2.
        #: Iteration order (ring creation order, FIFO within a ring)
        #: is the deterministic harvest order — a pure function of the
        #: submit/flush sequence, never of wall time.
        self._rings: dict[tuple, deque] = {}
        #: dispatches that found their ring FULL and had to displace
        #: (wait on) the oldest in-flight batch before starting — the
        #: pipeline back-pressure counter surfaced by stats()
        self._ring_stalls = 0
        self._has_deadlines = False   # gates the per-pump queue scan
        self._attempts = 0      # dispatch-attempt counter = the fault
        #                         schedule's index (service/faults.py)
        self._queues: dict[tuple, deque] = {}
        self._handles: dict[int, RequestHandle] = {}
        self._filler: dict[tuple, SimConfig] = {}
        self._next_rid = 0
        self._completed = 0
        self._failed = 0
        # service aggregates over a bounded sliding window: a
        # long-lived stream must not grow host memory per request, so
        # stats() percentiles/means describe the last ``stats_window``
        # latencies and dispatches (counters stay lifetime-exact)
        self._latencies: deque = deque(maxlen=stats_window)
        self._dispatches: deque = deque(maxlen=max(1, stats_window // 8))
        self._dispatch_count = 0
        self._bucket_stats: dict[tuple, dict] = {}
        # per-priority-class observability (the open-loop plane): one
        # bounded latency window PER class — a single global window
        # mixes classes and epochs under sustained mixed traffic, so
        # per-class p50/p99 would be meaningless — plus lifetime
        # per-class terminal counters; the aggregate fields above are
        # unchanged
        self._stats_window = stats_window
        self._class_lat: dict[str, deque] = {}
        self._class_stats: dict[str, dict] = {}
        self._tenant_shed: dict[str, int] = {}
        # queued-request count per tenant, maintained at every queue
        # mutation (enqueue / pop / requeue / expiry) so quota
        # admission is O(1) instead of a full queue scan per submit
        self._tenant_queued: dict[str, int] = {}
        self._early_flushes = 0
        # WFQ service counters (slo.weights): lanes dispatched per
        # class, the deficit the pump order normalizes by weight
        self._wfq_served: dict[str, float] = {}
        # per-bucket dispatch-wall EWMA (seconds), seeded by warm():
        # the early-flush estimate
        self._bucket_wall: dict[tuple, float] = {}
        # per-BASE-bucket wall-seconds-per-TICK EWMA, from clock()
        # deltas around each dispatch (so a virtual clock keeps it
        # deterministic); the checkpoint_every_s -> tick-budget
        # conversion reads it
        self._tick_wall: dict[tuple, float] = {}
        # failure-domain counters (lifetime-exact, like the request/
        # dispatch counters; the windowed view rides the _dispatches
        # entries' "retries" field)
        self._failures = {
            "retries": 0, "backoff_s": 0.0, "deadline_misses": 0,
            "shed": 0, "breaker_opens": 0, "degraded_dispatches": 0,
            "degraded_requests": 0, "failed_requests": 0,
            "device_losses": 0, "device_returns": 0,
            "mesh_rebuilds": 0,
            "faults_injected": 0, "poisoned_lanes": 0,
            "injected_latency_s": 0.0,
        }
        # the elasticity counters: lifetime-exact, reported in
        # stats()["elastic"] so a grow seed's replay can be compared
        # event-for-event.  restarted_lanes counts checkpointed work
        # ever re-run from tick 0 — structurally 0 (retries resume
        # from the last checkpoint; even the solo fallback resumes)
        # and gated on 0 by the elastic replay harness.
        #: the newest errors the failure path absorbed
        self._errors: deque = deque(maxlen=8)
        self._elastic = {
            "mesh_grows": 0, "checkpoints_taken": 0,
            "lanes_migrated": 0, "resume_dispatches": 0,
            "restarted_lanes": 0,
        }
        #: the durability plane:
        #: a RunStore (or ``run_dir`` sugar for one) makes this
        #: service journal every decision and write every checkpoint
        #: cut through the content-addressed spill tier — queued
        #: requests then hold lightweight SpilledCheckpoint proxies
        #: instead of full snapshots, and ``FleetService.recover``
        #: can rebuild the run in a fresh process.  None (default):
        #: the in-RAM-only behavior, bit for bit.
        if run_dir is not None and store is None:
            from ..store import RunStore
            store = RunStore(run_dir)
        self.store = store
        if store is not None:
            store.journal.meta({
                "max_batch": max_batch, "pad_policy": pad_policy,
                "pipeline": self.pipeline,
                "pipeline_depth": self.pipeline_depth,
                "checkpoint_every": checkpoint_every,
                "checkpoint_every_s": checkpoint_every_s,
                "mesh_devices": self.n_devices,
                "mesh_shape": [self.n_lanes, self.n_peers],
                # not one of recovery's _META_PARAMS: the JAX package
                # ignores it, and a port recovery takes its device from
                # the caller
                "device": self.device.type,
            })

    # ---- admission ---------------------------------------------------
    def submit(self, cfg: SimConfig, seed: Optional[int] = None,
               mode: str = "trace",
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Admit one simulation request; returns immediately.

        ``seed`` is sugar for ``cfg.replace(seed=seed)``.  Admission
        also runs the cooperative flush pass, so a submit can complete
        earlier requests (its own too, when it fills a batch).

        ``priority`` names an SLO class (service/slo.py) when the
        service carries an ``slo`` policy: it is validated against the
        policy and supplies the request's default deadline; without a
        policy it is a free-form label (default ``"default"``) used
        only for per-class stats.  ``tenant`` attributes the request
        for per-tenant admission quotas (``tenant_quota``) and shed
        accounting.

        ``deadline_s`` (or, absent it, the class default when an
        ``slo`` policy rides — the policy OWNS deadlines, so a
        deadline-less class stays deadline-less — or the service's
        ``default_deadline_s`` on policy-less services) is a relative
        latency budget on the service clock: a request still queued
        past it fails fast with :class:`DeadlineExceeded`; one that
        completes late is delivered with ``metrics.deadline_missed``
        set.  When the queue already holds ``max_queue_depth``
        requests — or the tenant already holds ``tenant_quota`` queued
        requests — admission sheds with a typed
        :class:`ShedRejection` — load is never shed by silently
        dropping something already queued.
        """
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one "
                             f"of {MODES}")
        if self.slo is not None:
            priority = self.slo.resolve(priority)
        elif priority is None:
            priority = "default"
        if self.max_queue_depth is not None \
                and self.pending >= self.max_queue_depth:
            self._failures["shed"] += 1
            raise ShedRejection(self.pending, self.max_queue_depth)
        if self.tenant_quota is not None and tenant is not None:
            held = self._tenant_queued.get(tenant, 0)
            if held >= self.tenant_quota:
                self._failures["shed"] += 1
                self._tenant_shed[tenant] = \
                    self._tenant_shed.get(tenant, 0) + 1
                raise TenantQuotaExceeded(tenant, held, self.tenant_quota)
        if seed is not None:
            cfg = cfg.replace(seed=int(seed))
        key = self._bucket(cfg, mode)
        now = self.clock()
        budget = deadline_s
        if budget is None:
            # an SLO policy OWNS the deadline decision: a class
            # declared deadline-less STAYS deadline-less — the
            # service-wide default applies only on policy-less
            # services (otherwise ClassPolicy(deadline_s=None) could
            # not express "throughput-only" at all)
            budget = self.slo.deadline_for(priority) \
                if self.slo is not None else self.default_deadline_s
        req = SimRequest(rid=self._next_rid, cfg=cfg, mode=mode,
                         bucket=key, submit_s=now,
                         deadline_s=(now + budget
                                     if budget is not None else None),
                         priority=priority, tenant=tenant)
        if req.deadline_s is not None:
            self._has_deadlines = True
        self._next_rid += 1
        handle = RequestHandle(request=req, _service=self)
        self._handles[req.rid] = handle
        self._queues.setdefault(key, deque()).append(req)
        self._tenant_note(req.tenant, +1)
        self._filler.setdefault(key, cfg)
        self._bucket_stats.setdefault(key, {"requests": 0, "dispatches": 0,
                                            "builds": 0})
        self._bucket_stats[key]["requests"] += 1
        if self.store is not None:
            self.store.journal.submit(req)
        self.pump()
        return handle

    def _readmit(self, rid: int, cfg: SimConfig, mode: str,
                 priority: str = "default",
                 tenant: Optional[str] = None,
                 resume=None) -> RequestHandle:
        """Re-admit one journaled request during crash recovery
        (store/recovery.py) under its ORIGINAL rid.

        Mirrors :meth:`submit`'s bookkeeping with three deliberate
        differences: no new journal record (the original submit
        record stands — a second recovery must not see duplicates),
        no admission control (the request was already admitted once;
        shedding it now would drop accepted work), and no ``pump()``
        (recovery queues everything first so resumed batches re-form
        at full width).  ``resume`` is the lane's latest loadable
        spilled cut (a SpilledCheckpoint proxy) — the request queues
        directly under the matching resume sub-bucket, exactly where
        the dead process left it.
        """
        key = self._bucket(cfg, mode)
        req = SimRequest(rid=rid, cfg=cfg, mode=mode, bucket=key,
                         submit_s=self.clock(), priority=priority,
                         tenant=tenant)
        if resume is not None:
            req.resume = resume
            req.bucket = key + (("resume", int(resume.tick)),)
        handle = RequestHandle(request=req, _service=self)
        self._handles[rid] = handle
        self._queues.setdefault(req.bucket, deque()).append(req)
        self._tenant_note(tenant, +1)
        self._filler.setdefault(key, cfg)
        self._bucket_stats.setdefault(key, {"requests": 0,
                                            "dispatches": 0,
                                            "builds": 0})
        self._bucket_stats[key]["requests"] += 1
        self._next_rid = max(self._next_rid, rid + 1)
        return handle

    @classmethod
    def recover(cls, run_dir: str, mesh=None, device=None, **kw):
        """Rebuild a service (and its pending work) from a dead
        process's run directory: replay the write-ahead journal,
        re-warm the program cache, re-admit every non-terminal
        request, and resume each from its last spilled cut.  Returns
        ``(service, handles)``; drive the service (``drain()`` /
        per-handle ``result()``) to finish the run on ``device``
        (``cuda`` unless ``cpu``).  Reads run directories of either
        package.  Full semantics: store/recovery.py."""
        from ..store.recovery import recover_service
        return recover_service(run_dir, mesh=mesh, device=device, **kw)

    @property
    def capacity(self) -> int:
        """Lanes one dispatch can carry: ``max_batch`` per LANE
        device, times the lane axis (1 without a mesh).  On a 2-D
        mesh the peer axis does not multiply capacity — those devices
        shard each simulation's peer tables instead (n-scaling, not
        batch-scaling)."""
        return self.max_batch * self.n_lanes

    # ---- flush policies ----------------------------------------------
    def pump(self) -> int:
        """One cooperative scheduling pass; returns dispatches made.

        Flushes every bucket that is full (:attr:`capacity`), every
        bucket whose oldest request has waited past ``max_wait_s``,
        and — under an ``slo`` policy with ``early_flush`` — every
        bucket whose tightest deadline minus its estimated dispatch
        wall says a partial batch must dispatch NOW to make its SLO
        (:meth:`_should_flush_early`).  A pump that made no dispatch
        also HARVESTS finished in-flight batches (non-blocking
        ``is_ready`` check on each ring's oldest slot,
        :meth:`_harvest_ready`), so a poll-driven caller sees
        completions during idle periods without forcing a flush —
        except when
        :meth:`_harvest_enabled` says no: under an active fault
        injector (a readiness check is wall-time-dependent, and a
        fault surfacing at resolve would consume retry attempt
        indices at a timing-dependent point, breaking the chaos
        plane's digest-for-digest replayability), or when
        ``pump_harvest=False`` pins it off for deterministic
        virtual-clock traffic runs (service/traffic.py) that have no
        injector but still must not stamp completion times at
        wall-dependent points.
        """
        n = 0
        self._expire_deadlines(self.clock())
        for key in self._pump_order():
            q = self._queues[key]
            while len(q) >= self.capacity:
                self._dispatch(key)
                n += 1
            # re-read the clock per bucket: a multi-second dispatch
            # above (or for an earlier bucket) can erode another
            # bucket's deadline margin within this same pass — a
            # stale timestamp would miss exactly the flush-now window
            # the SLO check exists to catch.  (On a virtual clock the
            # re-read returns the same value: determinism unaffected.)
            now = self.clock()
            if (q and self.max_wait_s is not None
                    and now - q[0].submit_s >= self.max_wait_s):
                self._dispatch(key)
                n += 1
            if q and self._should_flush_early(key, q, now):
                self._early_flushes += 1
                self._dispatch(key)
                n += 1
        if n == 0 and self._harvest_enabled():
            self._harvest_ready()
        return n

    def _pump_order(self) -> list:
        """The bucket order one ``pump()`` pass serves.

        FIFO over bucket creation order, UNLESS an SLO policy with
        ``class_ordering`` rides: then buckets are
        popped tightest-queued-deadline first — otherwise classes
        would shape deadlines but not dispatch order, and an interactive
        batch could sit a full dispatch wall behind a deadline-less
        bulk bucket that merely enqueued earlier.  Deadline-less
        buckets keep FIFO order after every deadline-carrying one.
        With ``slo.weights`` set, WEIGHTED FAIR
        QUEUING replaces tightest-first: buckets order by their
        dominant class's normalized service deficit (lanes dispatched
        so far / weight, least-served first), so a heavy class earns
        a proportional share of dispatch slots without starving light
        ones.  Deterministic either way: deadlines/weights are pure
        schedule values on a virtual clock and ties break on creation
        order, so digest replays are unaffected
        (tests/test_traffic.py).
        """
        keys = list(self._queues)
        if self.slo is None \
                or not getattr(self.slo, "class_ordering", True):
            return keys
        pos = {k: i for i, k in enumerate(keys)}
        if getattr(self.slo, "weights", None) is not None:
            def deficit(k):
                cls = self._dominant_class(self._queues[k])
                served = self._wfq_served.get(cls, 0.0)
                return (served / self.slo.weight_of(cls), pos[k])
            keys.sort(key=deficit)
            return keys

        def tightness(k):
            dls = [r.deadline_s for r in self._queues[k]
                   if r.deadline_s is not None]
            return (min(dls) if dls else float("inf"), pos[k])

        keys.sort(key=tightness)
        return keys

    def _dominant_class(self, q) -> str:
        """The WFQ class a bucket is charged to: the priority class
        holding the most queued requests (ties break on class name —
        deterministic)."""
        counts: dict[str, int] = {}
        for r in q:
            counts[r.priority] = counts.get(r.priority, 0) + 1
        if not counts:
            return self.slo.default_class if self.slo is not None \
                else "default"
        return max(sorted(counts), key=lambda c: counts[c])

    def _harvest_enabled(self) -> bool:
        """Whether an idle ``pump()`` may resolve a ready in-flight
        batch.  Explicit ``pump_harvest`` wins; the default enables it
        exactly when no fault injector is active."""
        if self.pump_harvest is not None:
            return bool(self.pump_harvest)
        return self.injector is None

    def _should_flush_early(self, key: tuple, q, now: float) -> bool:
        """Deadline-aware batch formation (service/slo.py): True when
        the bucket's tightest queued deadline leaves no more margin
        than the estimated dispatch wall (times the policy's safety
        factor, plus its fixed margin).  Requests whose deadline
        already passed were expired by ``_expire_deadlines`` before
        this runs, so the margin here is positive."""
        if self.slo is None or not self.slo.early_flush:
            return False
        rem = self._min_remaining(q, now)
        if rem is None:
            return False
        est = self._est_wall(key)
        return rem <= est * self.slo.safety_factor + self.slo.margin_s

    def _est_wall(self, key: tuple) -> float:
        """Estimated dispatch wall for one bucket: the pinned value
        when the SLO policy carries one (deterministic replays), else
        the bucket's measured EWMA (seeded by ``warm()``), else the
        mean over buckets that HAVE dispatched, else 0 (flush only on
        the fixed margin until the first wall is measured)."""
        if self.slo is not None \
                and self.slo.assumed_dispatch_wall_s is not None:
            return self.slo.assumed_dispatch_wall_s
        if key in self._bucket_wall:
            return self._bucket_wall[key]
        if self._bucket_wall:
            return sum(self._bucket_wall.values()) / len(self._bucket_wall)
        return 0.0

    def flush(self, bucket: Optional[tuple] = None) -> int:
        """Dispatch everything pending (in one bucket, or all), then
        resolve any in-flight batch: after ``flush()`` returns, every
        request that was queued or in flight has reached a terminal
        handle state (the flush guarantee; under pipelining
        a ``pump()`` alone may leave the newest batch in flight) — OR,
        under checkpointed serving, has been advanced one leg
        and re-queued under its next resume sub-bucket.  A whole-
        service flush loops until every queue is empty AND nothing is
        in flight, so its terminal guarantee covers legs too (each
        pass advances every leg at least one cut — the loop is
        finite); a single-bucket flush drains that bucket once
        (``RequestHandle.result`` re-flushes the request's CURRENT
        bucket as it moves)."""
        n = 0
        self._expire_deadlines(self.clock())
        if bucket is not None:
            while self._queues.get(bucket):
                self._dispatch(bucket)
                n += 1
            self.resolve_inflight()
            return n
        while True:
            keys = [k for k in self._queues if self._queues[k]]
            if not keys and not any(self._rings.values()):
                break
            for key in keys:
                while self._queues.get(key):
                    self._dispatch(key)
                    n += 1
            # resolving may CHECKPOINT the in-flight batch and
            # re-queue it one leg further — loop back around
            self.resolve_inflight()
        return n

    def drain(self) -> int:
        """Flush all buckets; the stream is over (for now)."""
        return self.flush()

    @property
    def pending(self) -> int:
        """Requests still queued (in-flight requests are counted by
        :attr:`in_flight`, not here)."""
        return sum(len(q) for q in self._queues.values())

    @property
    def in_flight(self) -> int:
        """Requests launched on device but not yet resolved (summed
        over every bucket's in-flight ring)."""
        return sum(len(i.reqs) for i in self._inflight_batches())

    def _ring_key(self, key: tuple) -> tuple:
        """The ring a dispatch's in-flight slot lives in: one shared
        ring (``()``) at depth 1 — one service-wide slot,
        so any bucket's dispatch displaces any other's — the dispatch's
        own queue key at depth >= 2, so only same-bucket dispatches
        queue behind each other and independent buckets overlap."""
        return () if self.pipeline_depth == 1 else key

    def _inflight_batches(self) -> list:
        """Every in-flight batch, in the deterministic harvest order:
        ring creation order, oldest-launched first within a ring — a
        pure function of the submit/flush sequence (no wall clock, no
        readiness probe), which is what keeps chaos/elastic digest
        replays depth-stable."""
        return [i for ring in self._rings.values() for i in ring]

    def _pop_oldest_inflight(self) -> Optional[_Inflight]:
        """Detach the next in-flight batch in harvest order (pruning
        emptied rings); None when nothing is in flight."""
        for rkey in list(self._rings):
            ring = self._rings[rkey]
            if ring:
                infl = ring.popleft()
                if not ring:
                    del self._rings[rkey]
                return infl
            del self._rings[rkey]
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    # ---- dispatch ----------------------------------------------------
    def _bucket(self, cfg: SimConfig, mode: str) -> tuple:
        """The queue/bucket key for one request: the equivalence-class
        key when ``canonicalize`` is on (service/canonical.py;
        requests it cannot serve fall back to exact keys inside
        ``canonical_bucket_key``), the exact ``bucket_key``
        otherwise."""
        if self.canonicalize:
            from .canonical import canonical_bucket_key
            # the FULL-STRENGTH peer count snaps the pad ladder to
            # peer-shard-divisible rungs (pinned at construction)
            return canonical_bucket_key(cfg, mode,
                                        peers=self._canon_peers)
        return bucket_key(cfg, mode)

    @staticmethod
    def _base_key(key: tuple) -> tuple:
        """A queue key without its resume marker: checkpointed
        batches queue under ``base + (("resume", tick),)`` — lanes at
        different clocks must never share a dispatch (a fleet shares
        ONE scan clock) — but the program cache, circuit breaker, and
        per-bucket stats all speak the BASE bucket."""
        if key and isinstance(key[-1], tuple) and key[-1] \
                and key[-1][0] == "resume":
            return key[:-1]
        return key

    def _leg_ticks(self, reqs: list) -> Optional[int]:
        """Leg length for this batch (None: monolithic dispatch).

        A batch runs as resumable legs when ``checkpoint_every`` is
        set, the engine supports the mode (every overlay request;
        dense ``trace``), and the config's segment plan offers an
        interior cut — each leg ends at the cut
        ``models/segments.cut_for_budget`` picks.  Resumed batches
        ALWAYS take the leg path (their carry lives in checkpoints).
        All lanes of a batch share the plan (the bucket pins the plan
        signature, and cuts are seed-independent), so one leg length
        serves the whole batch."""
        r0 = reqs[0]
        cfg = r0.cfg
        budget = self.checkpoint_every
        if budget is None and self.checkpoint_every_s is not None:
            budget = self._ticks_for_seconds(self._base_key(r0.bucket))
        if budget is None:
            if r0.resume is not None:
                # a resumed batch must take the leg path (its carry
                # lives in checkpoints) even if the seconds budget has
                # no estimate yet: run it to the end in one leg
                return cfg.total_ticks - r0.resume.tick
            return None
        if cfg.model != "overlay" and r0.mode != "trace":
            return None     # dense bench: monolithic by construction
        start = r0.resume.tick if r0.resume is not None else 0
        end = cut_for_budget(cfg, start, budget)
        if r0.resume is None and end >= cfg.total_ticks:
            return None     # no interior cut (or the run fits the
            #                 budget): nothing to checkpoint
        return end - start

    def _ticks_for_seconds(self, base: tuple) -> Optional[int]:
        """The seconds budget as ticks, via the bucket's measured
        wall-per-tick EWMA (falling back to the cross-bucket mean);
        None until any estimate exists — an unwarmed bucket's first
        dispatch runs monolithic rather than guessing."""
        spt = self._tick_wall.get(base)
        if spt is None and self._tick_wall:
            spt = sum(self._tick_wall.values()) / len(self._tick_wall)
        if spt is None or spt <= 0.0:
            return None
        return max(1, int(self.checkpoint_every_s / spt))

    def _note_tick_wall(self, base: tuple, wall_s: float,
                        ticks: int) -> None:
        if ticks <= 0 or wall_s < 0.0:
            return
        alpha = self.slo.wall_ewma_alpha if self.slo is not None else 0.3
        prev = self._tick_wall.get(base)
        spt = wall_s / ticks
        self._tick_wall[base] = spt if prev is None \
            else (1.0 - alpha) * prev + alpha * spt

    def _width(self, k: int) -> int:
        """Compiled lane width for a ``k``-request batch.

        Every policy's width is rounded UP to a multiple of the LANE
        axis (a lane-sharded fleet needs ``B % n_lanes == 0``; without
        a mesh this is a no-op — and the peer axis never constrains
        the batch width, it shards within each lane), and under a mesh
        the "full" width is the whole-mesh :attr:`capacity` — one
        compiled width, and so at most one build, per bucket either
        way.
        """
        if self.pad_policy == "none":
            w = k
        elif self.pad_policy == "pow2":
            w = min(self.capacity, 1 << (k - 1).bit_length())
        else:
            w = self.capacity
        # a mesh shrink mid-flight can leave an already-popped batch
        # wider than the NEW capacity; the width must still cover it
        w = max(w, k)
        d = self.n_lanes
        return -(-w // d) * d

    def _dispatch(self, key: tuple) -> None:
        """Pop one batch and serve it.  Synchronous mode resolves it
        ATOMICALLY before returning (the atomic-dispatch contract); pipelined
        mode may leave the batch IN FLIGHT (a slot in its bucket's
        ring, ``self._rings``), to be resolved when a later dispatch
        displaces it from a full ring, an idle pump harvests it, or
        the flush ends — either way every popped request reaches a
        terminal state by the time ``flush()``/``drain()`` returns.
        Only non-Exception escapes (KeyboardInterrupt, SystemExit)
        re-queue still-unresolved requests at the queue front and
        propagate."""
        q = self._queues[key]
        reqs = [q.popleft() for _ in range(min(len(q), self.capacity))]
        for r in reqs:
            self._tenant_note(r.tenant, -1)
            self._wfq_served[r.priority] = \
                self._wfq_served.get(r.priority, 0.0) + 1.0
        try:
            if self.pipeline:
                self._serve_batch_pipelined(key, reqs)
            else:
                self._serve_batch(key, reqs)
        except BaseException:
            # backstop requeue, DEDUPED: the pipelined path's inner
            # handlers may already have requeued these requests (and
            # aborted the in-flight rings) before re-raising — a
            # request is put back only if it is still unresolved AND
            # not already waiting in the queue or riding in flight,
            # so an interrupted flush can be flushed again without
            # duplicate queue entries
            keep = {r.rid for i in self._inflight_batches()
                    for r in i.reqs}
            queued = {r.rid for r in q}
            unresolved = [r for r in reqs if r.rid in self._handles
                          and r.rid not in keep and r.rid not in queued]
            q.extendleft(reversed(unresolved))
            for r in unresolved:
                self._tenant_note(r.tenant, +1)
            self._abort_inflight()
            # requeues may have landed from several points (a failing
            # resolve, the abort above, this backstop); restore submit
            # order so the next flush serves oldest-first — normal
            # queue order IS rid order, so the sort is idempotent
            for qq in self._queues.values():
                if len(qq) > 1:
                    ordered = sorted(qq, key=lambda r: r.rid)
                    qq.clear()
                    qq.extend(ordered)
            raise

    def _requeue_unresolved(self, key: tuple, reqs: list) -> None:
        """Interrupted-dispatch recovery: put still-unresolved
        requests back at the front of their queue (submit order kept)."""
        q = self._queues.setdefault(key, deque())
        back = [r for r in reqs if r.rid in self._handles]
        for r in back:
            self._handles[r.rid]._launched = False
            self._tenant_note(r.tenant, +1)
        q.extendleft(reversed(back))

    def _abort_inflight(self) -> None:
        """Re-queue every in-flight batch, all rings (non-Exception
        escape path)."""
        while True:
            infl = self._pop_oldest_inflight()
            if infl is None:
                return
            self._requeue_unresolved(infl.key, infl.reqs)

    def resolve_inflight(self) -> None:
        """Resolve every in-flight batch, all rings, in the
        deterministic harvest order: block until each program
        completes, fetch + validate, and terminally resolve its
        handles (retrying / degrading on failure exactly like a
        synchronous dispatch).  Each batch is detached from its ring
        BEFORE resolving, so a non-Exception escape mid-resolve leaves
        the not-yet-resolved batches still registered in flight."""
        while True:
            infl = self._pop_oldest_inflight()
            if infl is None:
                return
            self._resolve(infl)

    def _harvest_ready(self) -> int:
        """The idle-pump harvest, generalized to the rings: resolve
        every ring HEAD whose program reports ready (non-blocking
        ``PendingFleet.is_ready``), repeating until no head is ready —
        only a ring's oldest slot may be harvested, so within-bucket
        resolution order stays FIFO even though readiness is polled.
        Returns batches resolved.  Wall-dependent by nature (the
        readiness probe), which is why ``_harvest_enabled`` gates it
        off under a fault injector or ``pump_harvest=False``."""
        done = 0
        progressed = True
        while progressed:
            progressed = False
            for rkey in list(self._rings):
                ring = self._rings.get(rkey)
                if ring and ring[0].pending.is_ready():
                    infl = ring.popleft()
                    if not ring:
                        self._rings.pop(rkey, None)
                    self._resolve(infl)
                    done += 1
                    progressed = True
        return done

    # ---- resilient dispatch (service/resilience.py) ------------------
    def _serve_batch(self, key: tuple, reqs: list) -> None:
        """Synchronous dispatch: one attempt (launch + resolve), then
        the shared recovery path on failure."""
        now = self.clock()
        reqs = self._drop_expired(reqs, now)
        if not reqs:
            return
        t_q0 = now              # queue wait ends at the first attempt
        if not self.breaker.allow(self._base_key(key), now):
            # quarantined bucket: straight to the ladder's bottom rung
            self._degrade_batch(key, reqs, t_q0, retries=0)
            return
        err, idx = self._try_once(key, reqs, t_q0, retries=0)
        if err is not None:
            self._recover_batch(key, reqs, t_q0, attempt=1,
                                last_err=err, last_idx=idx)

    def _serve_batch_pipelined(self, key: tuple, reqs: list) -> None:
        """Pipelined dispatch through the bucket's in-flight ring:
        STAGE this batch's lanes (host packing + the tiny device
        staging programs) while earlier programs execute, then — only
        if the ring is FULL — wait for and displace the ring's oldest
        batch, then dispatch this batch's program, then resolve the
        displaced batch while this one executes.  Staging is the host
        work that would otherwise serialize with execution.

        At depth 1 the ring is one service-wide slot, so every
        dispatch displaces: the beat is stage -> wait previous ->
        start -> resolve previous.  At depth >= 2 a dispatch into a
        ring with a free slot starts IMMEDIATELY: its run is enqueued
        on the card's stream behind the runs in flight, so the host
        enqueues one batch while the card computes another, and a
        bucket's own dispatches stack ``pipeline_depth`` deep before
        the oldest is waited on."""
        now = self.clock()
        reqs = self._drop_expired(reqs, now)
        if not reqs:
            return
        t_q0 = now
        if not self.breaker.allow(self._base_key(key), now):
            # resolve the in-flight batch first: the quarantined
            # bucket's solo runs (and their sleeps) must not strand
            # it, nor contend with its still-executing program
            self.resolve_inflight()
            self._degrade_batch(key, reqs, t_q0, retries=0)
            return
        idx, fault = self._draw_attempt()
        with spans.span("serve.dispatch", idx):
            builds0 = run_build_count()
            try:
                pending, width = self._attempt_launch(key, reqs, fault, idx,
                                                      defer=True)
            except Exception as e:
                # staging failed before any overlap existed; resolve the
                # independent in-flight batch FIRST so the retry/degrade
                # path below (backoff sleeps, solo runs) cannot strand it
                self.resolve_inflight()
                try:
                    self._recover_batch(key, reqs, t_q0, attempt=1,
                                        last_err=e, last_idx=idx)
                except BaseException:
                    self._requeue_unresolved(key, reqs)
                    raise
                return
            builds = run_build_count() - builds0
            infl = _Inflight(key=key, reqs=reqs, pending=pending,
                             width=width, idx=idx, fault=fault,
                             builds=builds, t_q0=t_q0)
            if pending.started:
                # the engine could not defer this launch (multi-chunk
                # dense traces execute eagerly inside launch()) — there
                # is no overlap to orchestrate, so fall back to the
                # synchronous beat: previous batch first, then this one,
                # never two programs pretending to pipeline
                self._note_enqueued(infl, t_q0)
                self.resolve_inflight()
                self._resolve(infl)
                return
            for r in reqs:
                self._handles[r.rid]._launched = True
            rkey = self._ring_key(key)
            ring = self._rings.setdefault(rkey, deque())
            # the ring beat, in order: (1) if this batch's ring is full,
            # wait for its OLDEST batch's program to finish WITHOUT
            # fetching (a ring stall — the only point the pipeline ever
            # blocks on the device), (2) dispatch this batch's program,
            # (3) fetch + complete the displaced batch while this one
            # executes.  A ring with a free slot skips (1) and (3)
            # entirely: the program starts with zero waiting and
            # resolution is deferred to a later displacement, harvest,
            # or flush.
            prev: Optional[_Inflight] = None
            if len(ring) >= self.pipeline_depth:
                prev = ring.popleft()
                self._ring_stalls += 1
            ring.append(infl)
            if prev is not None:
                try:
                    prev.pending.wait()
                except Exception:
                    pass         # surfaces again inside _resolve below
                except BaseException:
                    self._requeue_unresolved(prev.key, prev.reqs)
                    self._abort_inflight()
                    raise
            start_err: Optional[Exception] = None
            try:
                pending.start()
            except Exception as e:
                ring.pop()           # infl is the newest slot
                if not ring:
                    self._rings.pop(rkey, None)
                start_err = e
            except BaseException:
                if prev is not None:
                    self._requeue_unresolved(prev.key, prev.reqs)
                self._abort_inflight()
                raise
            if start_err is None:
                self._note_enqueued(infl, t_q0)
        if prev is not None:
            self._resolve(prev)
        if start_err is not None:
            try:
                self._recover_batch(key, reqs, t_q0, attempt=1,
                                    last_err=start_err, last_idx=idx)
            except BaseException:
                self._requeue_unresolved(key, reqs)
                raise

    def _resolve(self, infl: _Inflight) -> None:
        """Finish one launched dispatch: block + fetch + validate +
        complete the handles; failures re-enter the shared recovery
        path (synchronous retries — the batch is no longer pipelined)."""
        with spans.span("serve.collect", infl.idx):
            try:
                fleet = self._finish_attempt(infl)
            except Exception as e:
                try:
                    self._recover_batch(infl.key, infl.reqs, infl.t_q0,
                                        attempt=1, last_err=e,
                                        last_idx=infl.idx)
                except BaseException:
                    self._requeue_unresolved(infl.key, infl.reqs)
                    raise
                return
            except BaseException:
                self._requeue_unresolved(infl.key, infl.reqs)
                raise
            self.breaker.record_success(self._base_key(infl.key))
            self._complete_batch(infl, fleet, retries=0)

    def _draw_attempt(self):
        """Allocate the next dispatch-attempt index and consult the
        fault plane for it — the ONE place this happens: the chaos
        schedule's determinism depends on pipelined first attempts and
        synchronous retries drawing from the identical sequence."""
        self._attempts += 1
        idx = self._attempts
        fault = (self.injector.plan(idx)
                 if self.injector is not None else None)
        if fault is not None:
            self._failures["faults_injected"] += 1
            if self.store is not None:
                self.store.journal.fault(idx, fault)
        return idx, fault

    def _try_once(self, key: tuple, reqs: list, t_q0: float,
                  retries: int):
        """One full synchronous attempt (launch + immediate resolve);
        returns ``(None, idx)`` on success or ``(error, idx)``."""
        idx, fault = self._draw_attempt()
        t_a0 = self.clock() if retries and spans.recording() else t_q0
        builds0 = run_build_count()
        try:
            with spans.span("serve.dispatch", idx):
                pending, width = self._attempt_launch(key, reqs, fault, idx)
                infl = _Inflight(key=key, reqs=reqs, pending=pending,
                                 width=width, idx=idx, fault=fault,
                                 builds=run_build_count() - builds0,
                                 t_q0=t_q0)
                self._note_enqueued(infl, t_a0)
        except Exception as e:
            self._note_error(e)
            return e, idx
        with spans.span("serve.collect", idx):
            try:
                fleet = self._finish_attempt(infl)
            except Exception as e:
                self._note_error(e)
                return e, idx
            self.breaker.record_success(self._base_key(key))
            self._complete_batch(infl, fleet, retries=retries)
        return None, idx

    def _recover_batch(self, key: tuple, reqs: list, t_q0: float,
                       attempt: int, last_err: BaseException,
                       last_idx: int) -> None:
        """The shared failure path: record the failure that brought us
        here, then bounded synchronous retries with seeded backoff;
        exhaustion degrades to the solo fallback.  ``attempt`` counts
        failed attempts so far (>= 1)."""
        self._note_error(last_err)
        while True:
            if isinstance(last_err, InjectedDeviceLoss):
                self._failures["device_losses"] += 1
                if self.mesh is not None:
                    self._degrade_mesh()
            if self.breaker.record_failure(self._base_key(key), self.clock()):
                self._failures["breaker_opens"] += 1
            now = self.clock()
            reqs = self._drop_expired(reqs, now)
            if not reqs:
                return
            backoff = self.retry.backoff_s(attempt, salt=last_idx)
            remaining = self._min_remaining(reqs, now)
            if attempt > self.retry.max_retries or \
                    (remaining is not None and backoff >= remaining):
                break
            self._failures["retries"] += 1
            self._failures["backoff_s"] += backoff
            self._sleep(backoff)
            err, last_idx = self._try_once(key, reqs, t_q0,
                                           retries=attempt)
            if err is None:
                return
            last_err = err
            attempt += 1
        # retries exhausted: degrade to the solo fallback (or fail
        # terminally when the fallback is disabled)
        self._degrade_batch(key, reqs, t_q0, retries=attempt,
                            last_err=last_err)

    def _attempt_launch(self, key: tuple, reqs: list,
                        fault: Optional[str], idx: int,
                        defer: bool = False):
        """The launch half of a dispatch attempt, with the fault plane
        consulted at each pre-execution boundary; returns
        ``(PendingFleet, width)`` or raises.  The program is dispatched
        asynchronously — compute continues while this returns; with
        ``defer=True`` it is only STAGED (``PendingFleet.start()``
        dispatches), which is how the pipelined path keeps the next
        program off the cores until the previous batch resolves."""
        if fault == "device_return":
            # the elastic fault event: a lost device came back.  Not a
            # failure — grow the mesh BEFORE this launch so the batch
            # (and every checkpointed lane it carries) lands on the
            # wider mesh (a no-op without a mesh or at full strength)
            self._failures["device_returns"] += 1
            self._grow_mesh()
            fault = None
        if fault == "device_loss":
            raise InjectedDeviceLoss(idx)
        if fault == "compile":
            # the program-build boundary, before the bucket handle is
            # even looked up
            raise InjectedCompileFailure(idx)
        base = self._base_key(key)
        cfgs = [r.cfg for r in reqs]
        width = self._width(len(cfgs))
        sim = self.cache.get(
            base, cfgs[0],
            members=([bucket_key(r.cfg, r.mode) for r in reqs]
                     if base and base[0] == "canon" else None))
        if fault == "dispatch":
            raise InjectedDispatchFailure(idx)
        leg = self._leg_ticks(reqs)
        if leg is not None and reqs[0].resume is not None:
            # resume legs: the batch re-enters the run from its
            # checkpoints; filler is replicated from lane 0's snapshot
            # inside the engine.  A mesh change since the snapshot is a
            # MIGRATION: the host carry re-stacks on the new mesh
            cks = [r.resume for r in reqs]
            self._elastic["lanes_migrated"] += sum(
                1 for ck in cks if ck.mesh_desc != sim._mesh_entry())
            self._elastic["resume_dispatches"] += 1
            if self.store is not None:
                # durable serving: queued requests hold lightweight
                # spill proxies — materialize the real snapshots for
                # dispatch (RAM hit or validated disk reload)
                cks = [self.store.materialize(ck) for ck in cks]
            pending = sim.launch_leg(resume=cks, ticks=leg,
                                     width=width, defer=defer)
            return pending, width
        padded = pad_configs(cfgs, width, self._filler[base])
        if leg is not None:
            pending = sim.launch_leg(configs=padded, ticks=leg,
                                     n_real=len(reqs),
                                     mode=reqs[0].mode, defer=defer)
        elif reqs[0].mode == "bench":
            pending = sim.launch_bench(configs=padded, warmup=False,
                                       n_real=len(reqs), defer=defer)
        else:
            pending = sim.launch(configs=padded, n_real=len(reqs),
                                 warmup=False, defer=defer)
        return pending, width

    def _finish_attempt(self, infl: _Inflight):
        """The resolve half: block + fetch, apply the post-execution
        fault boundaries (latency stall, result poisoning), then
        validate.  Returns the FleetResult or raises."""
        if spans.recording():
            infl.t_r = self.clock()
        fleet = infl.pending.resolve()
        if infl.fault == "latency":
            dt = self.injector.latency_s(infl.idx)
            self._failures["injected_latency_s"] += dt
            self._sleep(dt)
        if infl.fault == "poison":
            self.injector.poison(fleet, infl.idx)
            self._failures["poisoned_lanes"] += 1
        # result validation: the filler-lane invariant first (a fleet
        # must unstack exactly the real lanes — a mismatch would
        # silently mispair requests and results in the zip below),
        # then per-lane sanity (catches poisoned lanes)
        if len(fleet.lanes) != len(infl.reqs):
            raise DispatchFailed(
                infl.reqs[0].rid, 1, RuntimeError(
                    f"dispatch unstacked {len(fleet.lanes)} lanes for "
                    f"{len(infl.reqs)} requests; filler lanes must "
                    "never be unstacked"))
        if isinstance(fleet, FleetLeg) and not fleet.done:
            # a non-final leg: validate the checkpoints (a poisoned
            # leg fails HERE and retries from the previous snapshot,
            # exactly like any dispatch failure) and hand the leg up
            # for _complete_batch's checkpoint-and-requeue branch
            for r, ck in zip(infl.reqs, fleet.lanes):
                why = validate_checkpoint(r, ck)
                if why is not None:
                    raise PoisonedLaneError(r.rid, why)
            return fleet
        if isinstance(fleet, FleetLeg):
            # final leg: assemble the full-horizon results (pure host
            # work) — validation below covers the stitched chunks, so
            # a poisoned final leg is still caught before completion
            fleet = fleet.results()
        for r, lane in zip(infl.reqs, fleet.lanes):
            why = validate_lane(r, lane)
            if why is not None:
                raise PoisonedLaneError(r.rid, why)
        return fleet

    # ---- spans (utils/spans.py) ---------------------------------------
    def _note_enqueued(self, infl: _Inflight, t_a0: float) -> None:
        """While spans record: the attempt's program is enqueued now;
        ``serve.dispatch`` runs from the attempt's start ``t_a0`` (the
        queue's end on a first attempt) to here, under the attempt
        index as id (the parent of the fleet's ``fleet.stage`` and
        ``fleet.enqueue``)."""
        if not spans.recording():
            return
        infl.t_enq = self.clock()
        spans.record("serve.dispatch", _ns(t_a0), _ns(infl.t_enq), infl.idx,
                     own_clock=self.clock is not time.perf_counter)

    def _note_collected(self, infl: _Inflight, now: float,
                        final: bool) -> None:
        """While spans record: the dispatch is collected at ``now``.
        Each request's ``serve.in_flight`` (the program enqueued to its
        resolution begun) and, on its final dispatch, ``serve.queue``
        (submission to the dispatch's first attempt, its
        ``queue_wait_s``), under its rid with the dispatch's id as
        parent; the dispatch's ``serve.collect`` (its resolution begun
        to ``now``, the parent of ``fleet.fetch``).  With the dispatch's
        ``serve.dispatch`` they tile a request's ``latency_s`` when no
        attempt failed."""
        if infl.t_enq is None or infl.t_r is None or not spans.recording():
            return
        own = self.clock is not time.perf_counter
        enq, res = _ns(infl.t_enq), _ns(infl.t_r)
        for r in infl.reqs:
            if final:
                spans.record("serve.queue", _ns(r.submit_s), _ns(infl.t_q0),
                             r.rid, infl.idx, own_clock=own)
            spans.record("serve.in_flight", enq, res, r.rid, infl.idx,
                         own_clock=own)
        spans.record("serve.collect", res, _ns(now), infl.idx,
                     own_clock=own)

    def _checkpoint_batch(self, infl: _Inflight, leg: FleetLeg,
                          retries: int) -> None:
        """A non-final leg resolved: snapshot taken.  Attach each
        lane's checkpoint to its request and re-queue the batch under
        the next leg's resume sub-bucket — the handles stay pending
        (continuing work, not a terminal state), and the next
        ``pump``/``flush`` dispatches the next leg.  Counted as a
        dispatch (it is one: a compiled program ran) with its own
        wall-decomposition row."""
        key, reqs, width, builds, t_q0 = (infl.key, infl.reqs, infl.width,
                                          infl.builds, infl.t_q0)
        now = self.clock()
        self._note_collected(infl, now, final=False)
        base = self._base_key(key)
        occupancy = len(reqs) / width
        wall = float(leg.wall_seconds)
        alpha = self.slo.wall_ewma_alpha if self.slo is not None else 0.3
        prev = self._bucket_wall.get(key)
        # per QUEUE key: a leg's wall describes its own length, not
        # the base bucket's monolithic dispatch wall
        self._bucket_wall[key] = wall if prev is None \
            else (1.0 - alpha) * prev + alpha * wall
        # wall-per-tick from CLOCK deltas (checkpoint_every_s): this
        # leg ran [prev cut, new cut) ticks
        leg_start = reqs[0].resume.tick if reqs[0].resume is not None \
            else 0
        self._note_tick_wall(base, now - t_q0,
                             leg.checkpoints[0].tick - leg_start)
        sub = base + (("resume", leg.checkpoints[0].tick),)
        q = self._queues.setdefault(sub, deque())
        for req, ck in zip(reqs, leg.checkpoints):
            # durable serving: the cut is journaled and the
            # snapshot write-through-spilled; the request queues with
            # the lightweight proxy so the store's RAM LRU is the
            # ONLY place full snapshots accumulate
            req.resume = ck if self.store is None \
                else self.store.put(req.rid, ck)
            req.bucket = sub
            self._handles[req.rid]._launched = False
            q.append(req)
            self._tenant_note(req.tenant, +1)
        self._elastic["checkpoints_taken"] += 1
        self._dispatches.append({"bucket": base, "batch": len(reqs),
                                 "width": width, "occupancy": occupancy,
                                 "wall_s": wall, "builds": builds,
                                 "pack_s": float(leg.pack_seconds),
                                 "device_wait_s":
                                     float(leg.device_seconds),
                                 "fetch_s": float(leg.fetch_seconds),
                                 "host_s": float(leg.pack_seconds)
                                 + float(leg.fetch_seconds),
                                 "retries": retries})
        self._dispatch_count += 1
        bs = self._bucket_stats[base]
        bs["dispatches"] += 1
        bs["builds"] += builds

    def _complete_batch(self, infl: _Inflight, fleet,
                        retries: int) -> None:
        if isinstance(fleet, FleetLeg):
            # _finish_attempt converts final legs to FleetResults, so
            # a FleetLeg here is a non-final snapshot: checkpoint +
            # re-queue instead of completing
            self._checkpoint_batch(infl, fleet, retries)
            return
        key, reqs, width, builds, t_q0 = (infl.key, infl.reqs, infl.width,
                                          infl.builds, infl.t_q0)
        occupancy = len(reqs) / width
        # the dispatch wall decomposes into pack (host staging +
        # dispatch) / execute (device wait — under pipelining this
        # span overlapped the next bucket's pack) / fetch (host
        # transfer + unstack), measured by core/fleet.py at the
        # launch/resolve boundaries — so a mesh speedup lands in the
        # execute column and a staging win in pack/fetch, and none of
        # it needs a block_until_ready on the hot path
        base = self._base_key(key)
        pack = float(fleet.pack_seconds)
        device_wait = float(fleet.device_seconds)
        fetch = float(fleet.fetch_seconds)
        # the REQUEST's run wall: accumulated across every leg of a
        # checkpointed run (FleetLeg.results sums them; equals the
        # decomposition sum on the monolithic path)
        wall = float(fleet.wall_seconds)
        # THIS dispatch's own wall: what the SLO early-flush EWMA and
        # the per-dispatch log row must see — on a final leg the
        # accumulated wall would overstate the next dispatch in this
        # queue by ~the leg count
        leg_wall = pack + device_wait + fetch
        now = self.clock()
        self._note_collected(infl, now, final=True)
        # fold this dispatch's wall into the bucket's EWMA — the
        # early-flush estimate (service/slo.py) for the NEXT partial
        # batch in this bucket
        alpha = self.slo.wall_ewma_alpha if self.slo is not None else 0.3
        prev = self._bucket_wall.get(key)
        self._bucket_wall[key] = leg_wall if prev is None \
            else (1.0 - alpha) * prev + alpha * leg_wall
        leg_start = reqs[0].resume.tick if reqs[0].resume is not None \
            else 0
        self._note_tick_wall(base, now - t_q0,
                             reqs[0].cfg.total_ticks - leg_start)
        for req, lane in zip(reqs, fleet.lanes):
            missed = req.deadline_s is not None and now > req.deadline_s
            if missed:
                self._failures["deadline_misses"] += 1
            legs = req.resume.legs + 1 if req.resume is not None else 1
            req.resume = None       # the run is over; free the snapshot
            if self.store is not None:
                self.store.journal.outcome(req.rid, "completed", lane)
            self._handles.pop(req.rid)._complete(lane, RequestMetrics(
                rid=req.rid, bucket=base, mode=req.mode,
                queue_wait_s=t_q0 - req.submit_s, run_wall_s=wall,
                latency_s=now - req.submit_s, batch=len(reqs),
                padded_batch=width, occupancy=occupancy,
                cache_hit=builds == 0, builds=builds, retries=retries,
                deadline_missed=missed, priority=req.priority,
                tenant=req.tenant, legs=legs))
            self._latencies.append(now - req.submit_s)
            self._note_class_terminal(req, now - req.submit_s, missed)
        self._completed += len(reqs)
        self._dispatches.append({"bucket": base, "batch": len(reqs),
                                 "width": width, "occupancy": occupancy,
                                 "wall_s": leg_wall, "builds": builds,
                                 "pack_s": pack,
                                 "device_wait_s": device_wait,
                                 "fetch_s": fetch,
                                 "host_s": pack + fetch,
                                 "retries": retries})
        self._dispatch_count += 1
        bs = self._bucket_stats[base]
        bs["dispatches"] += 1
        bs["builds"] += builds

    def _degrade_mesh(self) -> None:
        """One rung down the ladder, axis-aware: on a 2-D mesh a device
        loss drops a PEER shard first (the peer axis halves, every lane
        keeps serving), down to a 1-D lane mesh, then lane entries drop
        one at a time (to no mesh below two).  Rebinds the program cache
        so the bucket's next attempt builds for the smaller mesh."""
        from ..parallel.fleet_mesh import mesh_axis_sizes, shrink_mesh
        self.mesh = shrink_mesh(self.mesh)
        self.n_lanes, self.n_peers, _ = mesh_axis_sizes(self.mesh)
        self.n_devices = self.mesh.size if self.mesh is not None else 1
        self.cache.rebind_mesh(self.mesh)
        self._failures["mesh_rebuilds"] += 1

    def _grow_mesh(self) -> None:
        """One rung UP the ladder: re-extend the mesh toward the
        full-strength entries captured at construction (lanes first,
        then the peer axis doubles back) and re-key the program cache,
        so a descriptor that served before the loss finds its handles
        warm.  A no-op without a mesh or at full strength."""
        from ..parallel.fleet_mesh import grow_mesh, mesh_axis_sizes
        new = grow_mesh(self.mesh, self._full_devices,
                        full_shape=self._full_shape,
                        full_axes=self._full_axes)
        new_d = new.size if new is not None else 1
        if new is self.mesh or (new_d == self.n_devices
                                and mesh_axis_sizes(new) ==
                                mesh_axis_sizes(self.mesh)):
            return
        self.mesh = new
        self.n_lanes, self.n_peers, _ = mesh_axis_sizes(new)
        self.n_devices = new_d
        self.cache.rebind_mesh(new)
        self._elastic["mesh_grows"] += 1
        self._failures["mesh_rebuilds"] += 1

    def _degrade_batch(self, key: tuple, reqs: list, t_q0: float,
                       retries: int,
                       last_err: Optional[BaseException] = None) -> None:
        """The degradation ladder's bottom rung: serve each request by
        a direct solo run (service/resilience.py ``solo_run``).  When
        ``degrade_to_solo`` is off — or a solo run itself fails — the
        request fails terminally with a typed DispatchFailed instead;
        either way no handle is left pending."""
        self._failures["degraded_dispatches"] += 1
        if last_err is None:
            last_err = BucketQuarantined(key)
        for req in reqs:
            if not self.degrade_to_solo:
                self._fail_request(req, DispatchFailed(
                    req.rid, max(retries, 1), last_err), cause=last_err)
                continue
            t0 = self.clock()
            legs = 1
            try:
                if req.resume is not None:
                    # even the ladder's bottom rung preserves
                    # checkpointed work: resume the solo continuation
                    # from the lane's snapshot (service/resilience.py
                    # solo_resume) instead of re-running from tick 0
                    legs = req.resume.legs + 1
                    try:
                        res = solo_resume(req, self.device)
                    except Exception as e:
                        self._note_error(e)
                        # the snapshot could not be resumed — re-run
                        # whole (correct, but checkpointed work is
                        # lost: the one counted restart path)
                        self._elastic["restarted_lanes"] += 1
                        legs = 1
                        res = solo_run(req, self.device)
                else:
                    res = solo_run(req, self.device)
            except Exception as e:
                self._note_error(e)
                self._fail_request(req, DispatchFailed(
                    req.rid, retries + 1, e), cause=e)
                continue
            now = self.clock()
            missed = req.deadline_s is not None and now > req.deadline_s
            if missed:
                self._failures["deadline_misses"] += 1
            self._failures["degraded_requests"] += 1
            req.resume = None
            if self.store is not None:
                self.store.journal.outcome(req.rid, "degraded", res)
            self._handles.pop(req.rid)._complete(res, RequestMetrics(
                rid=req.rid, bucket=self._base_key(key), mode=req.mode,
                queue_wait_s=t_q0 - req.submit_s,
                run_wall_s=now - t0, latency_s=now - req.submit_s,
                batch=1, padded_batch=1, occupancy=1.0,
                cache_hit=False, builds=0, retries=retries,
                degraded=True, deadline_missed=missed,
                priority=req.priority, tenant=req.tenant, legs=legs))
            self._latencies.append(now - req.submit_s)
            self._note_class_terminal(req, now - req.submit_s, missed)
            self._completed += 1

    def _note_error(self, e: BaseException) -> None:
        """Keep the newest errors the failure path absorbed (a retry, a
        degraded batch), so ``stats()["last_errors"]`` names them."""
        self._errors.append(f"{type(e).__name__}: {e}"[:300])

    def _fail_request(self, req, error: BaseException,
                      cause: Optional[BaseException] = None) -> None:
        if cause is not None and error.__cause__ is None:
            error.__cause__ = cause
        self._failed += 1
        self._failures["failed_requests"] += 1
        self._class_stat(req.priority)["failed"] += 1
        if self.store is not None:
            self.store.journal.outcome(req.rid, "failed",
                                       error=type(error).__name__)
        self._handles.pop(req.rid)._fail(error)

    def _drop_expired(self, reqs: list, now: float) -> list:
        """Fail (terminally, typed) the requests whose deadline has
        passed; returns the still-live ones."""
        live = []
        for r in reqs:
            if r.deadline_s is not None and now >= r.deadline_s:
                self._failures["deadline_misses"] += 1
                self._class_stat(r.priority)["deadline_misses"] += 1
                self._fail_request(r, DeadlineExceeded(
                    r.rid, now - r.submit_s, r.deadline_s - r.submit_s))
            else:
                live.append(r)
        return live

    def _tenant_note(self, tenant: Optional[str], delta: int) -> None:
        """Maintain the per-tenant QUEUED count (quota admission reads
        it O(1)); entries drop to keep the dict bounded by the live
        tenant set."""
        if tenant is None:
            return
        c = self._tenant_queued.get(tenant, 0) + delta
        if c > 0:
            self._tenant_queued[tenant] = c
        else:
            self._tenant_queued.pop(tenant, None)

    # ---- per-priority-class accounting --------------------------------
    def _class_stat(self, priority: str) -> dict:
        return self._class_stats.setdefault(
            priority, {"completed": 0, "failed": 0,
                       "deadline_misses": 0})

    def _note_class_terminal(self, req, latency_s: float,
                             missed: bool) -> None:
        """One completed (or degraded-completed) request's per-class
        bookkeeping: its own bounded latency window + counters."""
        self._class_lat.setdefault(
            req.priority,
            deque(maxlen=self._stats_window)).append(latency_s)
        cs = self._class_stat(req.priority)
        cs["completed"] += 1
        if missed:
            cs["deadline_misses"] += 1

    def _expire_deadlines(self, now: float) -> None:
        """Queue-side deadline expiry (pump/flush): a request that can
        no longer make its deadline fails fast instead of wasting a
        lane.  Free until the first deadline-carrying request is
        admitted — a deadline-less service never pays the queue scan
        on its admission path."""
        if not self._has_deadlines:
            return
        for key in list(self._queues):
            q = self._queues[key]
            if not q or all(r.deadline_s is None for r in q):
                continue
            before = list(q)
            live = self._drop_expired(before, now)
            if len(live) != len(q):
                kept = {r.rid for r in live}
                for r in before:
                    if r.rid not in kept:
                        self._tenant_note(r.tenant, -1)
                q.clear()
                q.extend(live)

    @staticmethod
    def _min_remaining(reqs: list, now: float) -> Optional[float]:
        rem = [r.deadline_s - now for r in reqs
               if r.deadline_s is not None]
        return min(rem) if rem else None

    # ---- warm + metrics ----------------------------------------------
    def warm(self, cfg: SimConfig, mode: str = "trace") -> None:
        """Pre-build and execute a bucket's full-batch program.

        Compiles (and runs once, on ``max_batch`` filler lanes with a
        single unstacked lane) the widest program ``cfg``'s bucket can
        dispatch, without touching request metrics — so a
        latency-sensitive caller can take the build cost up front.
        Under ``pad_policy="full"`` (the default: one width per
        bucket) a warmed bucket never builds on dispatch again; under
        ``"pow2"``/``"none"`` this warms the full-batch width only —
        partial-batch widths still compile on first use.  Warmth is
        also bounded by the program cache: warming more than
        ``cache_max_entries`` distinct buckets LRU-evicts the earliest
        ones (programs included), so size the bound to the working set
        before a warm sweep.
        """
        key = self._bucket(cfg, mode)
        sim = self.cache.get(
            key, cfg,
            members=([bucket_key(cfg, mode)]
                     if key and key[0] == "canon" else None))
        self._filler.setdefault(key, cfg)
        self._bucket_stats.setdefault(key, {"requests": 0, "dispatches": 0,
                                            "builds": 0})
        width = self._width(self.capacity)
        padded = pad_configs([cfg], width, cfg)
        builds0 = run_build_count()
        c_warm0 = self.clock()
        first_leg = None
        if self.checkpoint_every is not None \
                and (cfg.model == "overlay" or mode == "trace"):
            end0 = cut_for_budget(cfg, 0, self.checkpoint_every)
            if end0 < cfg.total_ticks:
                first_leg = end0
        if first_leg is not None:
            # checkpointed serving dispatches LEG-length programs, not
            # the monolithic whole-run one — warm the same leg chain
            # the scheduler will run (one program per distinct leg
            # length), so elastic dispatches don't compile in-band
            leg = sim.run_leg(configs=padded, n_real=1,
                              ticks=first_leg, mode=mode)
            while not leg.done:
                nxt = cut_for_budget(cfg, leg.checkpoints[0].tick,
                                     self.checkpoint_every)
                leg = sim.run_leg(resume=leg.checkpoints,
                                  ticks=nxt - leg.checkpoints[0].tick,
                                  width=width)
            wall = float(leg.checkpoints[0].wall_seconds)
        elif mode == "bench":
            wall = float(sim.run_bench(configs=padded, warmup=False,
                                       n_real=1).wall_seconds)
        else:
            wall = float(sim.run(configs=padded, n_real=1,
                                 warmup=False).wall_seconds)
        self._bucket_stats[key]["builds"] += run_build_count() - builds0
        # seed the bucket's dispatch-wall EWMA so the SLO early-flush
        # estimate has a real number before the first live dispatch.
        # A warm run that just compiled reports an inflated wall —
        # which errs CONSERVATIVE (flush earlier than strictly needed)
        # and the EWMA converges within a few live dispatches
        self._bucket_wall.setdefault(key, wall)
        # seed the wall-per-tick estimate for checkpoint_every_s from
        # CLOCK deltas (deterministic under a virtual clock); the
        # just-compiled inflation again errs conservative — shorter
        # first legs, converging within a few dispatches
        self._tick_wall.setdefault(
            key, max(self.clock() - c_warm0, 0.0)
            / max(cfg.total_ticks, 1))
        if self.checkpoint_every is None \
                and self.checkpoint_every_s is not None \
                and (cfg.model == "overlay" or mode == "trace"):
            # the seconds budget resolves to ticks only AFTER this
            # warm seeded the wall-per-tick estimate — warm the same
            # leg chain the first live dispatch will now run, so a
            # warmed seconds-budget bucket neither compiles leg
            # programs in-band nor folds compile time into its first
            # EWMA samples.  (Later dispatches may re-quantize to a
            # different cut as the EWMA converges; cuts are few, so
            # the chain covers the common lengths.)
            budget = self._ticks_for_seconds(self._base_key(key))
            end0 = cut_for_budget(cfg, 0, budget) \
                if budget is not None else cfg.total_ticks
            if end0 < cfg.total_ticks:
                builds1 = run_build_count()
                leg = sim.run_leg(configs=padded, n_real=1,
                                  ticks=end0, mode=mode)
                while not leg.done:
                    nxt = cut_for_budget(cfg, leg.checkpoints[0].tick,
                                         budget)
                    leg = sim.run_leg(
                        resume=leg.checkpoints,
                        ticks=nxt - leg.checkpoints[0].tick,
                        width=width)
                self._bucket_stats[key]["builds"] += \
                    run_build_count() - builds1

    def stats(self) -> dict:
        """Service-level serving metrics (the BENCH json schema).

        ``latency`` percentiles and ``mean_occupancy`` describe the
        bounded stats window (see ``stats_window``); request/dispatch
        counters are lifetime-exact.  ``mean_occupancy`` is the
        unweighted mean over dispatches (each dispatch pays its own
        program, so a half-empty batch counts half no matter how many
        requests rode it).  ``program_hit_rate`` is the fraction of
        windowed dispatches that reused an already-built compiled
        program (zero new whole-run builds) — the compiled-program
        cache metric; the ProgramCache ``hit_rate`` below it only
        counts bucket-handle reuse.

        The open-loop traffic plane ADDS — without changing any
        existing aggregate field — ``latency_p99_s``, per-priority-
        class windows under ``classes`` (each class keeps its OWN
        bounded latency window, so sustained mixed traffic cannot
        smear one class's tail into another's percentiles),
        ``slo_early_flushes``, and per-tenant shed counts under
        ``tenant_shed``.

        ``mean_device_wait_s`` (each dispatch row's ``device_wait_s``,
        ``FleetResult.device_seconds``) runs from the program's launch
        to the host's wait for it returning: in the pipelined service
        that holds the stream wait behind earlier dispatches and the
        collection delay besides the run, so it is not device time (the
        ``fleet.device`` span of utils/spans.py is).  The SLO wall EWMA
        reads it as a part of the dispatch wall.
        """
        lat = np.asarray(self._latencies, dtype=np.float64)
        occ = np.asarray([d["occupancy"] for d in self._dispatches])
        hits = sum(1 for d in self._dispatches if d["builds"] == 0)
        dev = np.asarray([d["device_wait_s"] for d in self._dispatches])
        pack = np.asarray([d["pack_s"] for d in self._dispatches])
        fetch = np.asarray([d["fetch_s"] for d in self._dispatches])
        host = np.asarray([d["host_s"] for d in self._dispatches])
        walls = dev + host
        mean_pack = round(float(pack.mean()), 6) if pack.size else 0.0
        mean_fetch = round(float(fetch.mean()), 6) if fetch.size else 0.0
        out = {
            "requests": self._next_rid,
            "completed": self._completed,
            "failed": self._failed,
            "pending": self.pending,
            "in_flight": self.in_flight,
            "pipeline": self.pipeline,
            # the ring plane: configured depth, how deep each
            # bucket's ring is stacked RIGHT NOW (reqs per in-flight
            # batch, oldest first — empty dict when nothing is in
            # flight), and how often a dispatch found its ring full
            # and had to wait on (displace) the oldest slot.  Like
            # ``in_flight``, a read-only view: stats() never resolves.
            "pipeline_depth": self.pipeline_depth,
            "in_flight_by_bucket": {
                repr(k): [len(i.reqs) for i in ring]
                for k, ring in self._rings.items() if ring},
            "ring_stalls": self._ring_stalls,
            "dispatches": self._dispatch_count,
            "mean_occupancy": round(float(occ.mean()), 4) if occ.size else 0.0,
            "latency_p50_s": round(float(np.percentile(lat, 50)), 6)
            if lat.size else 0.0,
            "latency_p95_s": round(float(np.percentile(lat, 95)), 6)
            if lat.size else 0.0,
            "latency_p99_s": round(float(np.percentile(lat, 99)), 6)
            if lat.size else 0.0,
            "program_hit_rate": round(hits / len(self._dispatches), 4)
            if self._dispatches else 0.0,
            # where the per-dispatch wall goes, decomposed honestly
            #: pack (host staging + async dispatch) / execute
            # (``mean_device_wait_s``, launch to the host's wait
            # returning: not device time, see the docstring — the mesh
            # lever moves this, and pipelining overlaps the NEXT pack
            # under it) / fetch (host transfer + unstack).
            # ``mean_host_s``
            # = pack + fetch EXACTLY as reported: it is the sum of the
            # two rounded columns (independently rounding all three
            # breaks the identity by up to 1.5e-6); the old key is
            # kept for BENCH-json continuity.
            "mean_pack_s": mean_pack,
            "mean_device_wait_s": round(float(dev.mean()), 6)
            if dev.size else 0.0,
            "mean_fetch_s": mean_fetch,
            "mean_host_s": round(mean_pack + mean_fetch, 6),
            "device_wait_frac": round(float(dev.sum() / walls.sum()), 4)
            if dev.size and walls.sum() > 0 else 0.0,
            "cache": self.cache.stats(),
            "max_batch": self.max_batch,
            "pad_policy": self.pad_policy,
            "devices": self.n_devices,
            # the 2-D decomposition: batch shards x peer-table
            # shards at the CURRENT elasticity rung; devices ==
            # lanes * peers whenever a mesh rides
            "lanes": self.n_lanes,
            "peers": self.n_peers,
            "capacity": self.capacity,
            # the failure domain: lifetime-exact counters like
            # requests/dispatches above; the windowed per-dispatch
            # view carries "retries" in each _dispatches entry
            "failures": {k: (round(v, 6) if isinstance(v, float) else v)
                         for k, v in self._failures.items()},
            "last_errors": list(self._errors),
            "breaker_open_buckets":
                self.breaker.open_buckets(self.clock()),
            # the SLO / traffic plane: deadline-aware early
            # dispatches and per-tenant admission shedding
            "slo_early_flushes": self._early_flushes,
            "tenant_shed": dict(sorted(self._tenant_shed.items())),
            "wfq_served": dict(sorted(self._wfq_served.items())),
            # the elasticity plane: mesh grows, segment-
            # boundary checkpoints, lane migrations across mesh
            # rebuilds, resume dispatches, and the restarted-from-
            # tick-0 counter the elastic replay gate pins to 0
            "elastic": dict(self._elastic),
            "checkpoint_every": self.checkpoint_every,
            "checkpoint_every_s": self.checkpoint_every_s,
            # the compile-surface plane: whether requests
            # bucket by canonical equivalence class; the per-class
            # collapse map rides in "cache"["classes"]
            "canonicalize": self.canonicalize,
            # the durability plane:
            # spill/journal/recovery counters when a RunStore rides;
            # None on a store-less service (the key is always present
            # so dashboards need no schema branch)
            "durability": (self.store.stats()
                           if self.store is not None else None),
        }
        # per-priority-class view: each class's OWN windowed
        # percentiles + lifetime terminal counters (completed counts
        # degraded completions; failed counts typed failures incl.
        # queue-side deadline expiry)
        classes = {}
        for name in sorted(set(self._class_stats) | set(self._class_lat)):
            cs = dict(self._class_stat(name))
            w = np.asarray(self._class_lat.get(name, ()),
                           dtype=np.float64)
            terminal = cs["completed"] + cs["failed"]
            classes[name] = {
                **cs,
                "deadline_miss_rate":
                    round(cs["deadline_misses"] / terminal, 4)
                    if terminal else 0.0,
                "latency_p50_s": round(float(np.percentile(w, 50)), 6)
                if w.size else 0.0,
                "latency_p99_s": round(float(np.percentile(w, 99)), 6)
                if w.size else 0.0,
                "window": int(w.size),
            }
        out["classes"] = classes
        out["buckets"] = {repr(k): dict(v)
                          for k, v in self._bucket_stats.items()}
        return out

"""Request, handle, and metrics types for the fleet service (port of
``gossip_protocol_tpu/service/types.py``).

A request is one ``(config, seed, mode)`` simulation; the handle is
what ``FleetService.submit`` returns immediately — the serving layer
is continuous-batching, so the work runs later, when the request's
shape bucket flushes (service/scheduler.py).  Everything here is plain
host-side bookkeeping; device work lives entirely in core/fleet.py.
The port keeps the JAX names and fields, so the journal records and
the digests built over them agree across the packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..config import SimConfig

#: execution modes a request can ask for.  ``trace`` is the full-event
#: path (dense models) / metrics path (overlay) — what the grader
#: consumes; ``bench`` is the counters-only whole-run-on-device path.
MODES = ("trace", "bench")


@dataclass
class SimRequest:
    """One admitted simulation request.

    Immutable once queued, with one scheduler-owned exception: under
    checkpointed serving the scheduler advances ``resume`` (the
    lane's latest snapshot) and ``bucket`` (the resume sub-bucket the
    request re-queues under) as legs complete.
    """

    rid: int              # service-assigned id, submission order
    cfg: SimConfig        # the lane's full config (seed included)
    mode: str             # one of MODES
    bucket: tuple         # compatibility key (service/bucket.py)
    submit_s: float       # service clock at admission
    #: absolute service-clock deadline (None: no deadline).  Queued
    #: requests past it fail fast with DeadlineExceeded; dispatched
    #: requests that complete late are accounted in
    #: ``RequestMetrics.deadline_missed`` — never silently dropped.
    deadline_s: Optional[float] = None
    #: SLO priority class (service/slo.py): validated against the
    #: service's policy when one is set (and supplying the default
    #: deadline above), a free-form label otherwise; always feeds the
    #: per-class stats windows
    priority: str = "default"
    #: tenant attribution for per-tenant admission quotas and shed
    #: accounting (None: untenanted — never quota-limited)
    tenant: Optional[str] = None
    #: the lane's latest segment-boundary checkpoint
    #: (core/fleet.LaneCheckpoint) when the request runs as resumable
    #: legs.
    #: Set by the scheduler when a non-final leg resolves; the request
    #: then re-queues under a resume sub-bucket and its next dispatch
    #: re-enters the scan from this snapshot — never from tick 0.
    #: With a spill tier attached
    #: this may be a store.spill.SpilledCheckpoint proxy instead of a
    #: resident LaneCheckpoint — same digest/cfg/tick surface, state
    #: loaded (and validated) from disk only at dispatch.
    #: Cleared at completion.
    resume: Optional[object] = None


@dataclass
class RequestMetrics:
    """Per-request serving metrics, filled at completion.

    ``queue_wait_s + run_wall_s <= latency_s`` (latency also counts
    host-side unstacking).  ``occupancy`` is the real-lane fraction of
    the dispatched program this request rode in; ``cache_hit`` is True
    when the dispatch reused an already-built fleet program (zero new
    whole-run builds, ``core.tick.run_build_count``).
    """

    rid: int
    bucket: tuple
    mode: str
    queue_wait_s: float
    run_wall_s: float
    latency_s: float
    batch: int            # real lanes in the dispatch
    padded_batch: int     # compiled width actually dispatched
    occupancy: float      # batch / padded_batch
    cache_hit: bool
    builds: int           # whole-run builds this dispatch triggered
    #: failed dispatch attempts this request's batch survived before
    #: completing (0 on the clean path)
    retries: int = 0
    #: True when the request was served by the solo-run fallback (the
    #: degradation ladder's bottom rung, service/resilience.py) rather
    #: than a batched fleet program
    degraded: bool = False
    #: True when the request completed AFTER its deadline (the result
    #: is still delivered; expiry BEFORE dispatch fails the handle
    #: with DeadlineExceeded instead)
    deadline_missed: bool = False
    #: the request's SLO class and tenant, copied from the request so
    #: per-class/per-tenant analysis needs only the metrics stream
    priority: str = "default"
    tenant: Optional[str] = None
    #: dispatches this request rode to completion: 1 on the monolithic
    #: path; the number of resumable legs under checkpointed serving
    #: — each leg re-entered the scan from the previous leg's
    #: segment-boundary snapshot
    legs: int = 1


@dataclass
class RequestHandle:
    """Future-like handle for a submitted request.

    ``result()`` returns the lane's :class:`~..core.sim.SimResult`
    (dense) or :class:`~..models.overlay.OverlayResult` (overlay) —
    bit-identical to running the request's config alone
    (tests/test_torch_service.py).  If the request is still queued,
    ``result()`` flushes its bucket first, so it never deadlocks on a
    partial batch that would otherwise wait for ``max_wait``.

    Every handle reaches a TERMINAL state — ``completed``,
    ``degraded`` (served by the solo-run fallback), or ``failed``
    (``result()`` re-raises the typed error: DeadlineExceeded,
    DispatchFailed, ... — service/resilience.py).  The scheduler's
    dispatch path is atomic about this: a request popped for a
    dispatch is never left ``pending`` with no owner, whatever the
    dispatch did (tests/test_torch_resilience.py).
    """

    request: SimRequest
    _service: "FleetService" = field(repr=False)  # noqa: F821
    _result: Optional[object] = field(default=None, repr=False)
    _metrics: Optional[RequestMetrics] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)
    #: set by the pipelined scheduler when the request's batch has been
    #: LAUNCHED on device but not yet resolved (cleared if the batch is
    #: re-queued by an interrupted dispatch)
    _launched: bool = field(default=False, repr=False)

    @property
    def done(self) -> bool:
        """Terminal (completed, degraded, or failed)."""
        return self._metrics is not None or self._error is not None

    @property
    def failed(self) -> bool:
        return self._error is not None

    @property
    def status(self) -> str:
        """``pending`` | ``in_flight`` | ``completed`` | ``degraded``
        | ``failed``.  ``in_flight`` (pipelined scheduling)
        means the batch's device program is launched and executing;
        ``result()``/``flush()`` resolves it."""
        if self._error is not None:
            return "failed"
        if self._metrics is not None:
            return "degraded" if self._metrics.degraded else "completed"
        return "in_flight" if self._launched else "pending"

    def exception(self) -> Optional[BaseException]:
        """The terminal error (None unless :attr:`failed`)."""
        return self._error

    def result(self):
        # under checkpointed serving a flush of the request's
        # bucket may CHECKPOINT its batch and re-queue it under the
        # next leg's resume sub-bucket (request.bucket is updated in
        # place) — keep flushing the request's CURRENT bucket until it
        # is terminal; each flush advances the run by at least one
        # leg, so zero dispatches without a terminal state means the
        # flush was interrupted
        while not self.done:
            bucket = self.request.bucket
            n = self._service.flush(bucket)
            if self.done:
                break
            if n == 0 and self.request.bucket == bucket:
                # a flush can legitimately dispatch NOTHING yet still
                # advance this request: resolving an in-flight
                # pipelined leg checkpoints the batch and re-queues it
                # one cut further (request.bucket moves) — only a
                # zero-dispatch flush that left the request in the
                # SAME bucket is stuck.  Unreachable through the
                # scheduler's atomic dispatch path; kept as a guard
                # against interrupted flushes (KeyboardInterrupt
                # re-queues the batch and propagates)
                raise RuntimeError(
                    f"request {self.request.rid} is still pending "
                    "after a flush of its bucket; the flush was "
                    "interrupted — flush again")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def metrics(self) -> RequestMetrics:
        if not self.done:
            self.result()
        if self._error is not None:
            raise self._error
        return self._metrics

    def _complete(self, result, metrics: RequestMetrics) -> None:
        self._result = result
        self._metrics = metrics

    def _fail(self, error: BaseException) -> None:
        self._error = error

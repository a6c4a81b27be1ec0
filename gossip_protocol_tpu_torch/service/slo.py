"""SLO policy for the serving layer: priority classes, per-class
deadlines, and deadline-aware batch formation (a host-only copy of
``gossip_protocol_tpu/service/slo.py``).

Throughput-only flush policies are:
dispatch when a bucket is full, when its oldest request has waited
``max_wait_s``, or when a caller forces it.  Under an open-loop request
stream (service/traffic.py) that is not enough — a latency-sensitive
request stuck in a slowly-filling bucket will blow its deadline waiting
for lanes that may never arrive.  This module adds the *latency* side:

* **priority classes** — a request carries a class name
  (``submit(..., priority=)``); each class has a default relative
  deadline, so callers opt into an SLO by naming a class instead of
  hand-picking budgets.  Classes also carry the traffic generator's
  mix weights, so one object describes both what load looks like and
  what it is owed.
* **deadline-aware early flush** — the scheduler flushes a PARTIAL
  bucket early when its tightest deadline minus the bucket's estimated
  dispatch wall says the batch must go *now* to make it
  (``FleetService._should_flush_early``).  Both inputs already exist:
  deadlines ride the requests and the per-bucket wall comes
  from the pack/execute/fetch decomposition, folded into an EWMA
  per bucket (seeded by ``warm()``).  The trade is explicit: occupancy
  is sacrificed exactly when a deadline is at stake, never otherwise.
* **per-tenant admission quotas** — ``FleetService(tenant_quota=N)``
  bounds the *queued* requests any one tenant may hold, layered on the
  global ``max_queue_depth``: one hot tenant saturating the queue
  sheds typed (:class:`~.resilience.TenantQuotaExceeded`, a
  :class:`~.resilience.ShedRejection`) instead of starving everyone
  else's SLOs.  Queued work is never dropped — admission is refused,
  with the tenant named.

Determinism note (the same discipline as the chaos plane): the early
flush decision compares a *virtual* deadline margin against a
*measured* wall estimate.  For seed-replayable runs (the smoke load
gate, the chaos-under-load regression test) pin
``assumed_dispatch_wall_s`` so the decision is a pure function of the
schedule; leave it None in production/bench runs to use the measured
per-bucket EWMA.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping, Optional


@dataclass(frozen=True)
class ClassPolicy:
    """One priority class: its default relative deadline (None: no
    deadline — the class is throughput-only, and STAYS deadline-less
    even on a service with ``default_deadline_s`` set: an SLO policy
    owns the deadline decision) and its weight in the traffic
    generator's class mix."""

    deadline_s: Optional[float] = None
    weight: float = 1.0

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0 or None, got "
                             f"{self.deadline_s}")
        if self.weight < 0.0:
            raise ValueError(f"weight must be >= 0, got {self.weight}")


@dataclass(frozen=True)
class SLOPolicy:
    """Priority classes + the early-flush rule.

    A partial bucket is flushed early when its tightest remaining
    deadline margin drops to
    ``est_wall * safety_factor + margin_s`` — ``est_wall`` being the
    bucket's EWMA dispatch wall (or ``assumed_dispatch_wall_s`` when
    pinned for deterministic replays).  ``early_flush=False`` keeps
    the classes and deadlines but disables the early dispatch — the
    A/B leg the load bench compares miss rates against.
    """

    classes: Mapping[str, ClassPolicy] = field(
        default_factory=lambda: {"standard": ClassPolicy()})
    default_class: str = "standard"
    early_flush: bool = True
    #: deadline-aware DISPATCH ORDERING: ``pump()``
    #: pops the bucket holding the tightest queued deadline first
    #: instead of FIFO over bucket creation order — otherwise
    #: classes shape deadlines but not which bucket dispatches first,
    #: and a tight-deadline batch could sit behind a deadline-less one
    #: for a whole dispatch wall.  Deterministic (ties break on bucket
    #: creation order), so virtual-clock replays stay digest-stable.
    #: ``False`` is the A/B leg of the open-loop load bench.
    class_ordering: bool = True
    #: per-class WEIGHTED FAIR QUEUING between SLO classes:
    #: ``{class: weight}`` — when
    #: set, ``pump()`` orders buckets by normalized service deficit
    #: (lanes already dispatched for the bucket's dominant class,
    #: divided by that class's weight; least-served-per-weight first)
    #: instead of tightest-deadline-first, so a heavy class gets a
    #: proportionally larger share of dispatch slots under sustained
    #: mixed load while light classes can never be starved outright.
    #: Classes absent from the mapping inherit their ``ClassPolicy``
    #: weight.  Deterministic (ties break on bucket creation order) —
    #: virtual-clock replays stay digest-stable.  None (default):
    #: tightest-deadline-first ordering, the A/B leg of the load
    #: bench.
    weights: Optional[Mapping[str, float]] = None
    #: the dispatch-wall estimate is multiplied by this before being
    #: compared against the deadline margin — headroom for the
    #: estimate being an EWMA of a noisy wall
    safety_factor: float = 1.5
    margin_s: float = 0.0
    #: pin the wall estimate for seed-replayable runs (measured EWMAs
    #: differ run to run; a pinned estimate makes every early-flush
    #: decision a pure function of the arrival schedule)
    assumed_dispatch_wall_s: Optional[float] = None
    #: EWMA smoothing for the per-bucket measured wall
    wall_ewma_alpha: float = 0.3

    def __post_init__(self):
        if not self.classes:
            raise ValueError("SLOPolicy needs at least one class")
        if self.default_class not in self.classes:
            raise ValueError(
                f"default_class {self.default_class!r} is not one of "
                f"{sorted(self.classes)}")
        if self.safety_factor < 0.0 or self.margin_s < 0.0:
            raise ValueError("safety_factor and margin_s must be >= 0")
        if not 0.0 < self.wall_ewma_alpha <= 1.0:
            raise ValueError(f"wall_ewma_alpha must be in (0, 1], got "
                             f"{self.wall_ewma_alpha}")
        if self.weights is not None:
            unknown = set(self.weights) - set(self.classes)
            if unknown:
                raise ValueError(
                    f"weights name unknown classes {sorted(unknown)}; "
                    f"expected a subset of {sorted(self.classes)}")
            if any(w <= 0 for w in self.weights.values()):
                raise ValueError("WFQ weights must be > 0 (a zero "
                                 "weight would starve the class "
                                 "outright; leave it out instead)")

    def resolve(self, priority: Optional[str]) -> str:
        """Validate (or default) a submitted priority name."""
        if priority is None:
            return self.default_class
        if priority not in self.classes:
            raise ValueError(f"unknown priority class {priority!r}; "
                             f"expected one of {sorted(self.classes)}")
        return priority

    def deadline_for(self, priority: str) -> Optional[float]:
        return self.classes[priority].deadline_s

    def class_mix(self) -> dict:
        """``{name: weight}`` for the traffic generator."""
        return {name: c.weight for name, c in self.classes.items()}

    def with_early_flush(self, enabled: bool) -> "SLOPolicy":
        return replace(self, early_flush=enabled)

    def with_weights(self, weights: Optional[Mapping[str, float]]
                     ) -> "SLOPolicy":
        return replace(self, weights=weights)

    def weight_of(self, priority: str) -> float:
        """Effective WFQ weight of a class: the ``weights`` entry when
        present, else its ClassPolicy weight (floored at a small
        positive value so an unlisted zero-weight class is still
        schedulable)."""
        if self.weights is not None and priority in self.weights:
            return float(self.weights[priority])
        return max(float(self.classes[priority].weight), 1e-6) \
            if priority in self.classes else 1.0


def default_slo(scale: float = 1.0, early_flush: bool = True,
                assumed_dispatch_wall_s: Optional[float] = None
                ) -> SLOPolicy:
    """The three-class policy the load bench and smoke runs use:
    latency-sensitive ``interactive``, the bulk ``standard`` tier, and
    deadline-less ``batch``.  ``scale`` multiplies the deadlines (CPU
    dispatch walls are seconds; on a card they are far shorter)."""
    return SLOPolicy(
        classes={
            "interactive": ClassPolicy(deadline_s=3.0 * scale,
                                       weight=0.35),
            "standard": ClassPolicy(deadline_s=10.0 * scale, weight=0.5),
            "batch": ClassPolicy(deadline_s=None, weight=0.15),
        },
        default_class="standard", early_flush=early_flush,
        assumed_dispatch_wall_s=assumed_dispatch_wall_s)

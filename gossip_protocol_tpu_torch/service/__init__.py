"""Fleet service: continuous-batching simulation serving (port of
``gossip_protocol_tpu/service/``).

The layer above the batched engine (core/fleet.py): admit a stream of
heterogeneous ``(config, seed, mode)`` simulation requests, bucket
them by fleet-shape compatibility (shape key + segment-plan signature),
pad partial batches with inert filler lanes, and serve each bucket
through one cached fleet program — per-request results bit-identical to
solo runs, with per-request latency and per-dispatch occupancy metrics.
The failure plane (seeded faults, retry, breaker, solo fallback), the
open-loop traffic and SLO plane, canonical buckets and checkpointed,
journaled serving (``store/``) are the JAX package's, on the card
(``device="cuda"``, the default) or the CPU (``device="cpu"``), or
from a mesh of one process (``mesh=``, parallel/fleet_mesh.py) that
shrinks on a device loss and grows back on its return
(``elastic_replay``); ``loadbench.py`` is the open-loop load bench.
"""

from .bucket import bucket_key, pad_configs
from .cache import ProgramCache
from .faults import (FAULT_KINDS, FaultInjector, InjectedCompileFailure,
                     InjectedDeviceLoss, InjectedDispatchFailure,
                     InjectedFault)
from .replay import (Template, build_trace, chaos_replay,
                     elastic_replay, grader_templates,
                     overlay_templates, replay, result_digest)
from .resilience import (BreakerPolicy, BucketQuarantined, CircuitBreaker,
                         DeadlineExceeded, DispatchFailed,
                         PoisonedLaneError, RetryPolicy, ServiceError,
                         ShedRejection, TenantQuotaExceeded,
                         solo_execute, solo_resume, solo_run,
                         validate_checkpoint, validate_lane)
from .scheduler import PAD_POLICIES, FleetService
from .slo import ClassPolicy, SLOPolicy, default_slo
from .traffic import (ARRIVAL_KINDS, Arrival, TrafficPattern,
                      TrafficSchedule, VirtualClock, closed_schedule,
                      make_schedule, outcome_digest, run_schedule)
from .types import MODES, RequestHandle, RequestMetrics, SimRequest

__all__ = [
    "FleetService", "ProgramCache", "RequestHandle", "RequestMetrics",
    "SimRequest", "Template", "bucket_key", "build_trace",
    "grader_templates", "overlay_templates", "pad_configs", "replay",
    "chaos_replay", "MODES", "PAD_POLICIES",
    # the failure model: the fault plane + resilience machinery
    "FAULT_KINDS", "FaultInjector", "InjectedFault",
    "InjectedCompileFailure", "InjectedDispatchFailure",
    "InjectedDeviceLoss", "RetryPolicy", "BreakerPolicy",
    "CircuitBreaker", "ServiceError", "ShedRejection",
    "DeadlineExceeded", "DispatchFailed", "PoisonedLaneError",
    "BucketQuarantined", "solo_execute", "solo_run", "validate_lane",
    # the open-loop traffic + SLO plane: seeded arrival
    # processes, the virtual-clock loop, priority classes, quotas
    "ARRIVAL_KINDS", "Arrival", "TrafficPattern", "TrafficSchedule",
    "VirtualClock", "closed_schedule", "make_schedule",
    "outcome_digest", "run_schedule", "ClassPolicy", "SLOPolicy",
    "default_slo", "TenantQuotaExceeded",
    # the elasticity plane: mesh grow + segment-boundary
    # checkpointing + in-flight lane migration
    "elastic_replay", "solo_resume", "validate_checkpoint",
    # the durability plane:
    # per-result content digests for the journal + recovery gates
    "result_digest",
]

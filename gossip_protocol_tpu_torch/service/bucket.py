"""Shape-bucketing: which requests may ride one fleet program (port of
``gossip_protocol_tpu/service/bucket.py``; the keys are the JAX
package's tuples, built over the port's ``fleet_shape_key`` and
``plan_signature``).

A fleet program bakes a config *shape* (core/fleet.fleet_shape_key)
and — on paths that specialize per schedule phase — the segment plan
(models/segments.plan_signature).  The bucket key is exactly that
union, plus the execution mode and, for dense bench requests, the
static active-corner width (a bench fleet compiles ONE width, so
lanes must agree on ``active_bound`` up front rather than fail inside
``FleetSimulation.run_bench``).

Everything NOT in the key flows through the Schedule arrays as data
(seeds, victim draws, drop realizations), which is precisely why
batching within a bucket is exact: per-lane results stay bit-identical
to solo runs.  The key errs conservative — e.g. two dense trace
configs differing only in ``drop_open_tick`` could share today's
run (the window is schedule data there), but they get separate
buckets because the grid-kernel path does bake that boundary and a
serving layer must never depend on which engine path a bucket lands
on.

Partial batches are padded with FILLER lanes: replicas of the
bucket's first-seen config (same shape by construction, seed
irrelevant — filler results are masked out device-side and never
unstacked, core/fleet.py ``n_real``).

This EXACT key is one end of a dial.  Under a jittered mixed stream
(the scenario grammar) it degenerates toward one bucket — and one
fresh program build — per request; ``FleetService(canonicalize=True)``
buckets by the CANONICAL equivalence-class key instead
(service/canonical.py: pad-ladder rungs over ``n``, quantized phase
windows, world parameters as runtime operands), collapsing that
stream to one program per class while staying bit-identical per lane.
The exact key remains the fallback for everything canonicalization
does not serve (overlay, bench, checkpoint legs) and the MEMBER
identity recorded per class (ProgramCache.stats()["classes"]).
"""

from __future__ import annotations

from ..config import SimConfig
from ..core.fleet import fleet_shape_key
from ..models.segments import plan_signature
from .types import MODES


def bucket_key(cfg: SimConfig, mode: str) -> tuple:
    """Compatibility key: requests with equal keys batch together."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    key = (mode, fleet_shape_key(cfg), plan_signature(cfg))
    if cfg.model != "overlay":
        # the plan signature pins the drop WINDOW but not the
        # probability; one bucket must share the whole drop plan so
        # the fleet can keep one drop-plan row (core/fleet.py _shared_drop)
        # — a mixed-prob bucket would take the per-lane plan and build
        # a second program
        key += (cfg.msg_drop_prob if cfg.drop_msg else None,)
    if mode == "bench" and cfg.model != "overlay":
        from ..core.dense_corner import active_bound
        key += (active_bound(cfg),)
    return key


def pad_configs(cfgs: list, width: int, filler: SimConfig) -> list:
    """Pad a partial batch to ``width`` lanes with inert filler."""
    if len(cfgs) > width:
        raise ValueError(f"batch of {len(cfgs)} exceeds width {width}")
    return list(cfgs) + [filler] * (width - len(cfgs))

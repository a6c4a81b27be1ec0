"""Closed-loop seed sweep: fleets of ``batch`` lanes, each lane a seed
drawn from the run's seed, launched back to back with ``in_flight``
fleets enqueued at once (the next is launched before the oldest
resolves), through ``FleetSimulation.launch_bench`` and
``PendingFleet.resolve``.

A window launches fleets until its seconds are up, then resolves every
fleet it launched; its work is the configuration's N times its ticks for
every lane that came back, counted here and not by the program.  A
fleet's lanes are stratified over the failures' position (see
:func:`_lane_seeds`), since that sets how many peers stay live and so
the work of a dense lane.  One fleet of the window, drawn from the
seed, keeps its results for the check: one lane from each quarter of
the batch.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from benchmark.reference.prims import victim_draw

#: quarters of a fleet's lanes; one lane of each is checked
STRATA = 4


def _lane_seeds(rng, b: int) -> list[int]:
    """A fleet's lane seeds, lane ``j`` drawn until the protocol's
    failure-placement draw (:func:`~benchmark.reference.prims.victim_draw`)
    of its seed falls in the ``j``-th of ``b`` equal strata: every fleet
    sweeps the failures' position across its range, so every run offers
    the same mix of scenario sizes (how many peers stay live), in fresh
    seeds."""
    out = []
    for j in range(b):
        while True:
            s = int(rng.integers(1, 1 << 31))
            if int(victim_draw(s) * b) == j:
                out.append(s)
                break
    return out


def _recv(fr):
    """The overlay lanes' received merges a tick [lanes, T] (the
    roofline's data-dependent work); None for the dense model."""
    if not hasattr(fr.lanes[0], "metrics"):
        return None
    return np.stack([np.asarray(lane.metrics.recv) for lane in fr.lanes])


def setup(env) -> None:
    """Build the fleet and run ``in_flight`` fleets through the whole
    path once (kernel builds, the fleet's run closure, the allocator's
    blocks for fleets side by side)."""
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    tr = env.traffic
    env.sim = FleetSimulation(env.cfg, device=env.device)
    warm = np.random.default_rng((env.seed, 1))
    pend = [env.sim.launch_bench(seeds=_lane_seeds(warm, tr["batch"]),
                                 warmup=False)
            for _ in range(tr["in_flight"])]
    for p in pend:
        p.resolve()
    env.sync()


def lead_in(env) -> None:
    """One fleet, unmeasured, inside a traced run's profile."""
    env.sim.launch_bench(seeds=_lane_seeds(np.random.default_rng(
        (env.seed, 2)), env.traffic["batch"]), warmup=False).resolve()


def window(env, seconds: float, tracer) -> dict:
    tr = env.traffic
    b, depth = tr["batch"], tr["in_flight"]
    rng = env.rng
    pending: deque = deque()
    fleets = []
    keep = None
    launched = 0

    def resolve_oldest():
        nonlocal keep
        pend, seeds = pending.popleft()
        with tracer.span("bench.resolve"):
            fr = pend.resolve()
        t = time.perf_counter()
        lanes = min(len(fr.lanes), len(seeds))
        fleets.append(dict(
            lanes=lanes, ticks=env.conf["total_ticks"],
            node_ticks=env.conf["max_nnb"] * env.conf["total_ticks"] * lanes,
            pack_s=fr.pack_seconds,
            device_s=fr.device_seconds, fetch_s=fr.fetch_seconds,
            resolved_s=t - t0, recv=_recv(fr)))
        # reservoir of one fleet over the window, drawn from the seed
        if env.pick.random() * len(fleets) < 1.0:
            keep = (seeds, fr)

    tracer.open()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if len(pending) < depth:
            seeds = _lane_seeds(rng, b)
            with tracer.span("bench.launch"):
                pending.append((env.sim.launch_bench(seeds=seeds,
                                                     warmup=False), seeds))
            launched += b
        else:
            resolve_oldest()
    while pending:
        resolve_oldest()
    span = time.perf_counter() - t0
    tracer.close()
    env.kept = keep
    return dict(fleets=fleets, span_s=span, attempted=launched,
                node_ticks=sum(f["node_ticks"] for f in fleets),
                failed=launched - sum(f["lanes"] for f in fleets))


def answers(env, record: dict) -> list:
    """The lanes to check: from the kept fleet, one lane drawn from each
    quarter of the batch (each lane where it has four or fewer)."""
    if env.kept is None:
        return []
    seeds, fr = env.kept
    b = min(len(fr.lanes), len(seeds))
    bands = [range(q * b // STRATA, (q + 1) * b // STRATA)
             for q in range(STRATA)]
    picks = [int(env.pick.integers(r.start, r.stop)) for r in bands if r]
    return [(seeds[i], fr.lanes[i]) for i in picks]


def release(env) -> None:
    env.kept = None
    env.sim = None

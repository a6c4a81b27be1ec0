"""Closed-loop solo runs: one whole scenario at a time, back to back,
through ``OverlaySimulation.run`` (the path ``cli.py --model overlay``
takes), each run a seed drawn from the run's seed.

A window starts runs until its seconds are up; the run in flight when
they are finishes, and the window closes when it returns.  Each run is
recorded as a fleet of one lane (``lanes`` 1, its ticks, the
configuration's N times its ticks, and its received merges a tick
[1, T]), so the sweep cells' readers read it as they read a fleet.  Its
work is counted here and not by the program.  The window's runs are cut
by their start into ``checked`` equal spans of the window; each span
keeps one run's result for the check, drawn from the seed as a
reservoir, and every other result is dropped as soon as it is recorded
(a million-peer run's final state is most of a gigabyte).  A run that
raises counts as failed.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np


def _run(env, seed: int):
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    return OverlaySimulation(env.cfg.replace(seed=seed),
                             device=env.device).run()


def _seed(rng) -> int:
    return int(rng.integers(1, 1 << 31))


def setup(env) -> None:
    """Run the cell's shape twice through the whole path (kernel builds,
    the allocator's blocks for a run beside a kept result)."""
    warm = np.random.default_rng((env.seed, 1))
    keep = _run(env, _seed(warm))
    _run(env, _seed(warm))
    del keep
    env.sync()


def lead_in(env) -> None:
    """One run, unmeasured, inside a traced run's profile."""
    _run(env, _seed(np.random.default_rng((env.seed, 2))))


def window(env, seconds: float, tracer) -> dict:
    conf = env.conf
    strata = env.traffic["checked"]
    keep = [None] * strata
    seen = [0] * strata
    runs = []
    attempted = 0
    tracer.open()
    t0 = time.perf_counter()
    while (t := time.perf_counter() - t0) < seconds:
        part = min(int(t / seconds * strata), strata - 1)
        seed = _seed(env.rng)
        attempted += 1
        try:
            with tracer.span("bench.run"):
                res = _run(env, seed)
        except Exception:       # a failed run, counted as such
            print(f"solo: the run of seed {seed} failed\n"
                  f"{traceback.format_exc()}", file=sys.stderr, flush=True)
            continue
        runs.append(dict(
            lanes=1, ticks=conf["total_ticks"],
            node_ticks=conf["max_nnb"] * conf["total_ticks"],
            wall_s=res.wall_seconds, resolved_s=time.perf_counter() - t0,
            recv=np.asarray(res.metrics.recv).reshape(1, -1)))
        # a reservoir of one run in each span of the window
        seen[part] += 1
        if env.pick.random() * seen[part] < 1.0:
            keep[part] = (seed, res)
        res = None
    span = time.perf_counter() - t0
    tracer.close()
    env.kept = [k for k in keep if k is not None]
    return dict(fleets=runs, span_s=span, attempted=attempted,
                node_ticks=sum(r["node_ticks"] for r in runs),
                failed=attempted - len(runs))


def answers(env, record: dict) -> list:
    """The kept runs: ``(seed, OverlayResult)``, one from each span of
    the window that started a run."""
    return list(env.kept or [])


def release(env) -> None:
    env.kept = None

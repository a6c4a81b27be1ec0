"""Open-loop serving: single-seed requests of the configuration arrive on
the mix's Poisson schedule (:mod:`benchmark.arrivals`) into one
``FleetService`` (``max_batch``, ``max_wait_s``; the default padding and
pipeline; no deadlines, no fault injector), ``submit`` then
``handle.result()``.

A request is submitted when it falls due, whatever the service is doing,
and timed from its due time to the first moment the loop sees it done,
on the loop's own clock.  Between arrivals the loop pumps the service
(time-based flushes, the in-flight harvest) and looks at every open
request after each pump and each submission.  After the last arrival it
goes on pumping and looking, with no forced flush, until no request is
open or :data:`GRACE_S` has passed; one still open then never came.
Each completed request is read and dropped, as a user would; from each
quarter of the dispatches' lane positions one request, drawn from the
seed, keeps its result for the check.
"""

from __future__ import annotations

import time

from benchmark.arrivals import schedule

#: seconds past the window's close the loop waits for open requests
GRACE_S = 60.0
#: strata of a dispatch's lane positions; one request kept from each
STRATA = 4


def _service(env):
    from gossip_protocol_tpu_torch.service import FleetService
    tr = env.traffic
    return FleetService(max_batch=tr["max_batch"],
                        max_wait_s=tr["max_wait_s"], device=env.device)


def setup(env) -> None:
    """Build the service, warm the bucket's full-width program, and serve
    two full batches back to back (the pipelined path, the allocator's
    blocks for two fleets in flight)."""
    tr = env.traffic
    env.svc = _service(env)
    mode = env.conf["mode"]
    env.svc.warm(env.cfg, mode)
    hs = [env.svc.submit(env.cfg, seed=1_000_003 + i, mode=mode)
          for i in range(2 * tr["max_batch"])]
    env.svc.drain()
    for h in hs:
        h.result()
    env.sync()


def lead_in(env) -> None:
    mode = env.conf["mode"]
    hs = [env.svc.submit(env.cfg, seed=2_000_003 + i, mode=mode)
          for i in range(env.traffic["max_batch"])]
    env.svc.drain()
    for h in hs:
        h.result()


def _host_total(st: dict) -> tuple[int, float]:
    """(dispatches, summed pack + fetch seconds) so far: the stats'
    per-dispatch mean over its window, which holds every dispatch while
    there are fewer than its 16,384."""
    return st["dispatches"], st["mean_host_s"] * st["dispatches"]


def window(env, seconds: float, tracer) -> dict:
    tr = env.traffic
    svc, mode = env.svc, env.conf["mode"]
    arrivals = schedule(tr["rate_rps"], seconds, tr.get("arrival_seed", 0),
                        env.seed)
    d0, h0 = _host_total(svc.stats())
    lat, lag, open_ = [], [], []
    occ_lanes = occ_width = 0.0
    strata = [[0, None] for _ in range(STRATA)]

    def harvest():
        """Stamp every request first seen done, on the loop's clock; keep
        one of each stratum."""
        nonlocal occ_lanes, occ_width
        now = time.perf_counter() - t0
        done = [x for x in open_ if x[2].done]
        if not done:
            return
        open_[:] = [x for x in open_ if not x[2].done]
        done.sort(key=lambda x: x[2].request.rid)
        pos, prev = 0, None
        for due, seed, h in done:
            if h.failed:
                lat.append((due, None))
                continue
            lat.append((due, now - due))
            m = h.metrics
            occ_lanes += 1.0
            occ_width += m.padded_batch / m.batch
            grp = (m.run_wall_s, m.batch)
            pos = pos + 1 if grp == prev else 0
            prev = grp
            st = strata[min(STRATA - 1, pos * STRATA // m.batch)]
            st[0] += 1
            if env.pick.random() * st[0] < 1.0:    # reservoir of one
                st[1] = (seed, h.result())

    tracer.open()
    t0 = time.perf_counter()
    for due, seed in arrivals:
        while True:
            wait = due - (time.perf_counter() - t0)
            if wait <= 0.0:
                break
            with tracer.span("bench.pump"):
                svc.pump()
            harvest()
            wait = due - (time.perf_counter() - t0)
            if wait > 0.0:
                with tracer.span("bench.await_arrival"):
                    time.sleep(min(0.002, wait))
        lag.append(time.perf_counter() - t0 - due)
        with tracer.span("bench.submit"):
            h = svc.submit(env.cfg, seed=seed, mode=mode)
        open_.append((due, seed, h))
        harvest()
    with tracer.span("bench.drain"):
        while open_ and time.perf_counter() - t0 < seconds + GRACE_S:
            svc.pump()
            harvest()
            if open_:
                time.sleep(0.002)
    span = time.perf_counter() - t0
    tracer.close()
    lat += [(due, None) for due, _, _ in open_]      # never answered
    if open_:
        svc.drain()
    failed = sum(1 for _, x in lat if x is None)
    d1, h1 = _host_total(svc.stats())
    env.kept = [st[1] for st in strata if st[1] is not None]
    return dict(attempted=len(arrivals), failed=failed, span_s=span,
                # a request that failed or never came misses every limit:
                # it counts as waiting until the loop's end
                latencies_s=[span - due if x is None else x
                             for due, x in lat],
                lag_s=lag, offered_rps=len(arrivals) / seconds,
                completed=len(arrivals) - failed,
                dispatches=d1 - d0, host_s=h1 - h0,
                occupancy=(occ_lanes / occ_width) if occ_width else None)


def answers(env, record: dict) -> list:
    return list(env.kept)


def release(env) -> None:
    env.kept = []
    env.svc = None

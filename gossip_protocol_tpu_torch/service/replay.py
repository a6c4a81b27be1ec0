"""Mixed-workload trace replay: the service's acceptance harness (port
of ``gossip_protocol_tpu/service/replay.py``).

Builds a synthetic request stream — the three grader scenario kinds at
two sizes — replays it twice (sequential per-request execution, then
through :class:`~.scheduler.FleetService`), verifies per-request
bit-parity between the two, and reports serving metrics.  Shared by
``chip_smoke.py``'s serving phase and the tests
(tests/test_torch_service.py).

* **grader tier** — the exact course scenarios (dense full-view,
  N=10, 700 ticks: config.SINGLE_FAILURE / MULTI_FAILURE /
  MSG_DROP_SINGLE_FAILURE); on a card a bucket of them is one K1 fleet
  with a lane axis.
* **scale tier** — the same three scenario kinds in the bounded
  partial-view overlay family (fail / churn / drop10 at replay size);
  on a card a bucket rides K5's lane axis where its envelope holds.

:func:`result_digest` hashes host numpy of the JAX package's dtypes
(the clock as an int32 scalar), so a request's digest is the same in
both packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import (MSG_DROP_SINGLE_FAILURE, MULTI_FAILURE,
                      SINGLE_FAILURE, SimConfig)
from .scheduler import FleetService

#: overlay state/metric fields compared for parity (live_uncovered is
#: excluded by contract: the fleet reports the kernels' -1 sentinel,
#: core/fleet.py / tests/test_fleet.py)
_OV_STATE = ("tick", "ids", "hb", "ts", "in_group", "own_hb",
             "send_flags", "joinreq", "joinrep")
_OV_METRICS = ("in_group", "view_slots", "adds", "removals",
               "false_removals", "victim_slots", "sent", "recv")
_DENSE_STATE = ("tick", "in_group", "own_hb", "known", "hb", "ts",
                "gossip", "joinreq", "joinrep")


@dataclass(frozen=True)
class Template:
    """One (scenario kind, size tier) request template."""

    name: str
    cfg: SimConfig
    mode: str = "trace"


def grader_templates() -> list[Template]:
    """The grader tier: the three exact course scenarios (dense N=10)."""
    return [Template("dense-single", SINGLE_FAILURE),
            Template("dense-multi", MULTI_FAILURE),
            Template("dense-drop10", MSG_DROP_SINGLE_FAILURE)]


def overlay_templates(n: int = 512, ticks: int = 96) -> list[Template]:
    """The scale tier: the same scenario kinds, overlay family.

    Mirrors ``bench_overlay``'s fail/churn/drop shapes at replay size
    (churn keeps the ramp inside the pre-churn window; drop keeps it
    before the tick-50 window opening, like the reference's msgdrop
    scenario).
    """
    # ramps scale with the tick budget: the whole join ramp must land
    # before the churn window opens (ticks/4) resp. before the fail
    # tick and the tick-50 drop-window opening
    ramp_fail = min(40, max(1, ticks // 2 - 8))
    ramp_churn = max(1, ticks // 4 - 4)
    fail = SimConfig(max_nnb=n, model="overlay", single_failure=True,
                     drop_msg=False, seed=0, total_ticks=ticks,
                     fail_tick=ticks // 2, step_rate=ramp_fail / n)
    churn = SimConfig(max_nnb=n, model="overlay", single_failure=False,
                      drop_msg=False, seed=0, total_ticks=ticks,
                      churn_rate=0.2, rejoin_after=40,
                      step_rate=ramp_churn / n)
    drop = SimConfig(max_nnb=n, model="overlay", single_failure=True,
                     drop_msg=True, msg_drop_prob=0.1, seed=0,
                     total_ticks=ticks, fail_tick=ticks // 2,
                     step_rate=ramp_fail / n)
    return [Template("overlay-fail", fail), Template("overlay-churn", churn),
            Template("overlay-drop10", drop)]


def build_trace(templates: list[Template],
                seeds_per_template: int) -> list[tuple[Template, int]]:
    """Seed-major interleaving: every template at seed k arrives before
    any template at seed k+1, so buckets fill concurrently — the shape
    mix a real request stream would present, not sorted batches."""
    return [(tpl, 1000 + s) for s in range(seeds_per_template)
            for tpl in templates]


def _solo_run(tpl: Template, seed: int, device=None):
    """Direct single-simulation execution of one request — the SAME
    implementation the degradation fallback uses
    (service/resilience.py ``solo_execute``), so the parity reference
    and the fallback cannot drift apart."""
    from .resilience import solo_execute
    return solo_execute(tpl.cfg.replace(seed=seed), tpl.mode, device)


def run_sequential(trace, device=None) -> tuple[list, float]:
    """The baseline leg: every request alone, in arrival order, after
    the caller's warmup pass built every kernel — the honest "no
    serving layer" alternative, not a strawman.
    """
    t0 = time.perf_counter()
    out = [_solo_run(tpl, seed, device) for tpl, seed in trace]
    return out, time.perf_counter() - t0


def run_service(trace, max_batch: int = 8,
                service: FleetService | None = None,
                pipeline: bool | None = None,
                pipeline_depth: int | None = None, device=None
                ) -> tuple[list, FleetService, float]:
    """The serving leg: submit the stream, drain, collect results."""
    svc = service if service is not None else FleetService(
        max_batch=max_batch, pipeline=pipeline,
        pipeline_depth=pipeline_depth, device=device)
    t0 = time.perf_counter()
    handles = [svc.submit(tpl.cfg, seed=seed, mode=tpl.mode)
               for tpl, seed in trace]
    svc.drain()
    results = [h.result() for h in handles]
    return results, svc, time.perf_counter() - t0


def warm(trace, service: FleetService) -> None:
    """Build both legs' kernels and programs before timing (one pass
    per distinct template, on the service's device): the comparison
    measures serving, not building."""
    done = set()
    for tpl, _ in trace:
        if tpl.name in done:
            continue
        done.add(tpl.name)
        _solo_run(tpl, 1, service.device)
        service.warm(tpl.cfg, tpl.mode)


def _host(name: str, a):
    """A result field as host numpy of the JAX package's dtype: tensors
    leave their device, the host clock becomes an int32 scalar."""
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    if name.endswith("tick") and not isinstance(a, np.ndarray):
        return np.asarray(a, np.int32)
    return np.asarray(a)


def _eq(name: str, a, b) -> bool:
    a, b = _host(name, a), _host(name, b)
    if (a is None) != (b is None):
        return False
    return a is None or (a.dtype == b.dtype and np.array_equal(a, b))


def _mismatch(tpl: Template, ref, got) -> str | None:
    """First differing field between a solo result and a service lane
    (None: bit-identical, dtypes included)."""
    if tpl.cfg.model == "overlay":
        for f in _OV_STATE:
            if not _eq(f"state.{f}", getattr(ref.final_state, f),
                       getattr(got.final_state, f)):
                return f"final_state.{f}"
        for f in _OV_METRICS:
            if not _eq(f, getattr(ref.metrics, f), getattr(got.metrics, f)):
                return f"metrics.{f}"
        return None
    for f in ("added", "removed", "sent", "recv"):
        if not _eq(f, getattr(ref, f), getattr(got, f)):
            return f
    for f in _DENSE_STATE:
        if not _eq(f"state.{f}", getattr(ref.final_state, f),
                   getattr(got.final_state, f)):
            return f"final_state.{f}"
    return None


def result_digest(res) -> str:
    """Stable content hash of ONE request's result — exactly the
    parity fields ``_mismatch`` compares, so two results with equal
    digests are bit-identical by the replay harness's own standard.

    This is what the write-ahead journal records per terminal request
    (store/journal.py ``outcome``): a run killed after a request
    completed can still prove that request's bit-parity against an
    uninterrupted baseline without the result surviving the death.
    Every field is folded as host numpy of the JAX package's dtype
    (:func:`_host`), so the digest of a request equals the JAX
    ``result_digest`` of its JAX run.
    """
    import hashlib
    h = hashlib.sha256()

    def _fold(tag: str, a) -> None:
        h.update(tag.encode())
        a = _host(tag, a)
        if a is None:
            h.update(b"<none>")
            return
        a = np.ascontiguousarray(a)
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())

    if hasattr(res, "metrics"):           # overlay result
        for f in _OV_STATE:
            _fold(f"state.{f}", getattr(res.final_state, f))
        for f in _OV_METRICS:
            _fold(f"metrics.{f}", getattr(res.metrics, f))
    else:                                 # dense result (trace/bench)
        for f in ("added", "removed", "sent", "recv"):
            _fold(f, getattr(res, f))
        for f in _DENSE_STATE:
            _fold(f"state.{f}", getattr(res.final_state, f))
    return h.hexdigest()[:16]


def verify_parity(trace, seq_results, svc_results) -> list[str]:
    """Per-request bit-parity of the two legs; returns mismatches."""
    bad = []
    for (tpl, seed), ref, got in zip(trace, seq_results, svc_results):
        field = _mismatch(tpl, ref, got)
        if field is not None:
            bad.append(f"{tpl.name} seed={seed}: {field}")
    return bad


def node_ticks(trace) -> int:
    return sum(t.cfg.n * t.cfg.total_ticks for t, _ in trace)


def replay(templates: list[Template], seeds_per_template: int,
           max_batch: int = 8, check_parity: bool = True,
           mesh=None, sequential=None, return_legs: bool = False,
           pipeline: bool | None = None,
           pipeline_depth: int | None = None, device=None):
    """Full A/B replay on ``device`` (``cuda`` unless ``cpu``); returns
    the service-metrics dict.

    Raises on any per-request parity mismatch — a serving layer that
    changes results has no throughput to report — and on any failed or
    degraded request; the returned ``failures`` carry the retry count.
    ``mesh`` waits for the multi-device slice (ROADMAP M11).

    The sequential baseline of one trace is the same however the
    service side is configured, so a caller comparing several service
    configurations (device counts, batch widths) can run it once:
    ``return_legs=True`` additionally returns ``(seq_results,
    seq_wall)``, and ``sequential=`` feeds that pair back in place of
    a fresh baseline run — parity is still verified per request
    against it.
    """
    trace = build_trace(templates, seeds_per_template)
    svc = FleetService(max_batch=max_batch, mesh=mesh,
                       pipeline=pipeline,
                       pipeline_depth=pipeline_depth, device=device)
    warm(trace, svc)
    if sequential is None:
        seq_results, seq_wall = run_sequential(trace, svc.device)
    else:
        seq_results, seq_wall = sequential
        if len(seq_results) != len(trace):
            raise ValueError(
                f"sequential= leg has {len(seq_results)} results but "
                f"the trace has {len(trace)} requests; both replays "
                "must use the same templates and seeds_per_template")
    svc_results, svc, svc_wall = run_service(trace, service=svc)
    # the clean-path harness must stay loud about engine failures: the
    # resilient scheduler would otherwise convert a broken fleet path
    # into solo-run fallbacks that pass parity trivially (solo IS the
    # reference) — a fault-free replay that degrades anything is a bug
    fail_stats = svc.stats()
    if fail_stats["failed"] or fail_stats["failures"]["degraded_requests"]:
        raise RuntimeError(
            f"fault-free replay had {fail_stats['failed']} failed and "
            f"{fail_stats['failures']['degraded_requests']} degraded "
            f"requests (retries="
            f"{fail_stats['failures']['retries']}); the fleet dispatch "
            "path is broken — its errors are on the request handles")
    if check_parity:
        bad = verify_parity(trace, seq_results, svc_results)
        if bad:
            raise RuntimeError(
                f"service results diverged from solo runs ({len(bad)}): "
                + "; ".join(bad[:5]))
    stats = svc.stats()
    nt = node_ticks(trace)
    # builds attributable to service buckets (warm + dispatch); the
    # cache's own ``builds`` is a process-wide delta that also counts
    # the sequential leg's solo compilations
    per_bucket_builds = [b["builds"] for b in stats["buckets"].values()]
    metrics = {
        "requests": len(trace),
        "distinct_templates": len(templates),
        "devices": stats["devices"],
        "lanes": stats["lanes"],
        "peers": stats["peers"],
        "capacity": stats["capacity"],
        "sequential_wall_s": round(seq_wall, 3),
        "service_wall_s": round(svc_wall, 3),
        "speedup_vs_sequential": round(seq_wall / svc_wall, 2),
        "aggregate_node_ticks_per_s": round(nt / svc_wall, 1),
        "sequential_node_ticks_per_s": round(nt / seq_wall, 1),
        "latency_p50_s": stats["latency_p50_s"],
        "latency_p95_s": stats["latency_p95_s"],
        "mean_occupancy": stats["mean_occupancy"],
        "pipeline": stats["pipeline"],
        "pipeline_depth": stats["pipeline_depth"],
        "ring_stalls": stats["ring_stalls"],
        "mean_pack_s": stats["mean_pack_s"],
        "mean_device_wait_s": stats["mean_device_wait_s"],
        "mean_fetch_s": stats["mean_fetch_s"],
        "mean_host_s": stats["mean_host_s"],
        "device_wait_frac": stats["device_wait_frac"],
        # compiled-program reuse per dispatch (zero new builds) — the
        # honest cache metric; ProgramCache.hit_rate only counts
        # bucket-handle reuse
        "cache_hit_rate": stats["program_hit_rate"],
        "buckets": stats["cache"]["buckets"],
        "service_builds": sum(per_bucket_builds),
        "max_builds_per_bucket": max(per_bucket_builds, default=0),
        "dispatches": stats["dispatches"],
        "parity_checked": bool(check_parity),
        "latency_p99_s": stats["latency_p99_s"],
        "failures": stats["failures"],
    }
    if return_legs:
        return metrics, (seq_results, seq_wall)
    return metrics


def chaos_replay(templates: list[Template], seeds_per_template: int,
                 max_batch: int = 8, mesh=None, fault_seed: int = 0,
                 fault_rate: float = 0.12, device_loss_at="mid",
                 max_retries: int = 4, backoff_base_s: float = 0.01,
                 sequential=None, return_legs: bool = False,
                 pipeline: bool | None = None,
                 pipeline_depth: int | None = None, device=None):
    """The chaos acceptance harness: the mixed replay under a SEEDED
    fault schedule (service/faults.py) plus one mid-replay device
    loss (retried like any dispatch failure without a lane mesh), on
    ``device``, with the gate enforced in-line:

    * **100% completion, 0 stranded handles** — every submitted
      request reaches a terminal state, and every terminal state is a
      result (completed or degraded-to-solo); any failed or pending
      handle raises.
    * **bit-parity for every non-degraded request** against the
      sequential solo leg (degraded requests ARE solo runs, so they
      are checked too — a degraded mismatch raises just the same).
    * **replayability** — the returned ``fault_events`` /
      ``schedule_digest`` / ``outcomes`` are pure functions of
      ``(templates, seeds_per_template, max_batch, mesh, fault_seed,
      fault_rate, device_loss_at)``: two runs with the same arguments
      produce identical fault sequences and identical per-request
      outcomes.  Nothing may depend on wall time: ``max_wait_s`` stays
      None (dispatch order is a pure function of submit order) and the
      circuit-breaker cooldown is infinite (an opened bucket stays
      deterministically quarantined rather than half-open-probing on
      elapsed wall time).

    ``device_loss_at="mid"`` schedules the loss at roughly the middle
    dispatch; pass an attempt index to pin it, or None for no loss.
    ``sequential=``/``return_legs=`` share one solo baseline across
    several chaos configurations, exactly like :func:`replay`.
    """
    from .faults import FaultInjector
    from .resilience import BreakerPolicy, RetryPolicy
    trace = build_trace(templates, seeds_per_template)
    n_dev = n_lanes = 1
    if device_loss_at == "mid":
        # roughly the middle fault-free dispatch of the stream
        dispatches = max(1, len(trace) // max(1, max_batch * n_lanes))
        device_loss_at = max(2, dispatches // 2)
    injector = FaultInjector(seed=fault_seed, fault_rate=fault_rate,
                             device_loss_at=device_loss_at)
    svc = FleetService(
        max_batch=max_batch, mesh=mesh, injector=injector,
        retry=RetryPolicy(max_retries=max_retries,
                          backoff_base_s=backoff_base_s,
                          seed=fault_seed),
        # determinism requires every scheduling decision to be a pure
        # function of the seeded arguments: max_wait_s stays None (no
        # time-based flushes) and the breaker cooldown is infinite —
        # a bucket the fault schedule manages to open stays
        # deterministically quarantined (its requests degrade to solo,
        # which still completes and parity-checks) instead of
        # half-open-probing on real elapsed wall time.  Pipelining
        # (the default) keeps determinism: launches, resolves, and
        # retries all happen at fixed points of the submit/flush
        # sequence, so attempt indices — and with them the fault
        # schedule — are still a pure function of submit order.
        breaker=BreakerPolicy(reset_after_s=float("inf")),
        pipeline=pipeline, pipeline_depth=pipeline_depth, device=device)
    warm(trace, svc)
    if sequential is None:
        seq_results, seq_wall = run_sequential(trace, svc.device)
    else:
        seq_results, seq_wall = sequential
        if len(seq_results) != len(trace):
            raise ValueError(
                f"sequential= leg has {len(seq_results)} results but "
                f"the trace has {len(trace)} requests")
    t0 = time.perf_counter()
    handles = [svc.submit(tpl.cfg, seed=seed, mode=tpl.mode)
               for tpl, seed in trace]
    svc.drain()
    svc_wall = time.perf_counter() - t0

    stranded = [h.request.rid for h in handles if not h.done]
    failed = [h.request.rid for h in handles if h.failed]
    if stranded or failed:
        errs = "; ".join(
            f"rid {h.request.rid}: {h.exception()!r}"
            for h in handles if h.failed)[:500]
        raise RuntimeError(
            f"chaos replay left {len(stranded)} stranded and "
            f"{len(failed)} failed handles of {len(handles)} "
            f"(seed={fault_seed}): {errs}")
    svc_results = [h.result() for h in handles]
    degraded = [h.request.rid for h in handles
                if h.status == "degraded"]
    bad = verify_parity(trace, seq_results, svc_results)
    # degraded requests are served by the parity reference itself
    # (solo runs), so ANY mismatch — degraded or not — is a failure
    if bad:
        raise RuntimeError(
            f"chaos replay diverged from solo runs ({len(bad)}): "
            + "; ".join(bad[:5]))
    stats = svc.stats()
    outcomes = [(h.request.rid, h.status, h.metrics.retries)
                for h in handles]
    import hashlib
    outcome_digest = hashlib.sha256(
        repr(outcomes).encode()).hexdigest()[:16]
    metrics = {
        "requests": len(trace),
        "completed": len(svc_results),
        "stranded": 0,
        "failed": 0,
        "completion_rate": 1.0,
        "degraded_requests": len(degraded),
        "parity_checked": True,
        "fault_seed": fault_seed,
        "fault_rate": fault_rate,
        "device_loss_at": device_loss_at,
        "faults": injector.summary(),
        "fault_events": list(injector.events),
        "schedule_digest": injector.schedule_digest(),
        "outcome_digest": outcome_digest,
        "outcomes": outcomes,
        "failures": stats["failures"],
        "last_errors": stats["last_errors"],
        "devices_start": n_dev,
        "devices_end": stats["devices"],
        "sequential_wall_s": round(seq_wall, 3),
        "service_wall_s": round(svc_wall, 3),
        "speedup_vs_sequential": round(seq_wall / svc_wall, 2),
        "latency_p50_s": stats["latency_p50_s"],
        "latency_p95_s": stats["latency_p95_s"],
        "mean_occupancy": stats["mean_occupancy"],
        "dispatches": stats["dispatches"],
        "pipeline": stats["pipeline"],
        "pipeline_depth": stats["pipeline_depth"],
        "ring_stalls": stats["ring_stalls"],
        "breaker_open_buckets": stats["breaker_open_buckets"],
    }
    if return_legs:
        return metrics, (seq_results, seq_wall)
    return metrics


def elastic_replay(*args, **kwargs):
    """The JAX package's elastic acceptance harness serves the replay as
    resumable legs under a device loss AND a device return, and gates on
    the mesh shrinking and growing back.  Its gate needs a lane mesh,
    which the port gains with the multi-device slice (ROADMAP M11);
    checkpointed serving itself runs here (``FleetService(
    checkpoint_every=)``, ``store/harness.py kill_restart_replay``)."""
    raise NotImplementedError(
        "elastic_replay gates on a mesh shrink and grow; the port's lane "
        "mesh comes with the multi-device slice (ROADMAP M11)")

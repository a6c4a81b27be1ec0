"""Kill-and-restart acceptance harness (port of
``gossip_protocol_tpu/store/harness.py``).

Proves the durability subsystem end to end: a mixed replay stream
served WITH a run directory is killed mid-run (``os._exit`` — no
atexit, no flush, the honest crash model), then a FRESH process
recovers the run directory and finishes the stream.  The gate:

* every request reaches a terminal state exactly once across the two
  processes (pre-kill completions come from the journal's outcome
  records, post-recovery completions from live handles);
* ``restarted_lanes == 0`` — no checkpointed work was ever re-run
  from tick 0, even across the death;
* the per-request result content digests
  (service/replay.result_digest) are identical to an uninterrupted
  baseline run — bit-parity by the replay harness's own standard.

Two kill topologies share all the gating logic: ``child=True`` runs
the doomed serve in a subprocess (``python -m
gossip_protocol_tpu_torch.store.harness serve ...``, on the parent's
device) so recovery is genuinely cross-process — the acceptance
configuration; the in-process variant abandons the doomed service
object instead (fast, used by tests/test_torch_durability.py).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile

#: the doomed child's exit code — distinguishable from a crash (1),
#: a usage error (2), and a clean finish (0, which the gate REJECTS:
#: the kill must land mid-run)
KILL_EXIT = 47

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _templates(n_overlay: int, t_overlay: int):
    from ..service.replay import grader_templates, overlay_templates
    return grader_templates() + overlay_templates(n=n_overlay,
                                                  ticks=t_overlay)


def _warm_service(svc, trace) -> None:
    done = set()
    for tpl, _ in trace:
        if tpl.name not in done:
            done.add(tpl.name)
            svc.warm(tpl.cfg, tpl.mode)


def _drive(svc, kill_after=None, on_kill=None) -> bool:
    """Drive a service to completion one bucket-flush at a time,
    checking the kill threshold between flushes; returns False when
    the kill fired (True: ran to completion below the threshold)."""
    def _tripped() -> bool:
        if kill_after is not None and svc._dispatch_count >= kill_after:
            if on_kill is not None:
                on_kill()
            return True
        return False

    if _tripped():
        return False
    while True:
        progressed = False
        for key in list(svc._queues):
            if not svc._queues.get(key):
                continue
            svc.flush(key)
            progressed = True
            if _tripped():
                return False
        if svc.in_flight:
            svc.resolve_inflight()
            progressed = True
            if _tripped():
                return False
        if not progressed:
            return True


def _serve(run_dir: str, seeds_per_template: int, n_overlay: int,
           t_overlay: int, max_batch: int, checkpoint_every: int,
           kill_after, on_kill=None, device=None) -> bool:
    """The doomed serve: submit the standard mixed stream against a
    run directory and drive it until done or killed."""
    from ..service.replay import build_trace
    from ..service.scheduler import FleetService
    trace = build_trace(_templates(n_overlay, t_overlay),
                        seeds_per_template)
    svc = FleetService(max_batch=max_batch,
                       checkpoint_every=checkpoint_every,
                       run_dir=run_dir, device=device)
    _warm_service(svc, trace)
    # The crash window opens only once every submit is ACKNOWLEDGED
    # (journaled): full buckets auto-flush during this loop, so the
    # dispatch count can pass kill_after mid-submission, but dying
    # here would lose un-journaled requests — those are a
    # client-resubmit story, not a durability gate.  _drive's entry
    # check fires at the first flush boundary at/after kill_after.
    for tpl, seed in trace:
        svc.submit(tpl.cfg, seed=seed, mode=tpl.mode)
    return _drive(svc, kill_after=kill_after, on_kill=on_kill)


def run_killed_serve(run_dir: str, seeds_per_template: int,
                     n_overlay: int, t_overlay: int, max_batch: int,
                     checkpoint_every: int, kill_after: int,
                     device: str = "cuda", timeout_s: float = 1800.0):
    """Run the doomed serve in a SUBPROCESS (the genuine crash model) on
    ``device``; returns the CompletedProcess."""
    env = os.environ.copy()
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "gossip_protocol_tpu_torch.store.harness",
           "serve", run_dir, str(seeds_per_template), str(n_overlay),
           str(t_overlay), str(max_batch), str(checkpoint_every),
           str(kill_after), str(device)]
    return subprocess.run(cmd, env=env, capture_output=True,
                          text=True, timeout=timeout_s, cwd=_REPO)


def _digest_of(per_rid: dict) -> str:
    """One run-level digest over the per-rid content digests."""
    h = hashlib.sha256()
    for rid in sorted(per_rid):
        h.update(f"{rid}:{per_rid[rid]};".encode())
    return h.hexdigest()[:16]


def kill_restart_replay(seeds_per_template: int = 34,
                        n_overlay: int = 512, t_overlay: int = 96,
                        max_batch: int = 8, checkpoint_every: int = 48,
                        kill_frac: float = 0.5, run_dir=None,
                        baseline=None, child: bool = True, device=None):
    """One kill-and-restart pass over the standard mixed stream on
    ``device`` (``cuda`` unless ``cpu``; the doomed child runs there
    too); returns ``(metrics, baseline)`` — pass ``baseline`` back in to
    amortize the uninterrupted reference run across a sweep.

    Raises on ANY gate violation: a child that finished instead of
    dying, an incomplete or double-counted request set, a non-zero
    ``restarted_lanes``, or a single digest mismatch.
    """
    from ..service.replay import (build_trace, result_digest,
                                  run_service, warm)
    from ..service.scheduler import FleetService
    from ..state import resolve_device
    from .journal import read_journal

    dev = resolve_device(device)
    trace = build_trace(_templates(n_overlay, t_overlay),
                        seeds_per_template)
    if baseline is None:
        # the uninterrupted reference: same stream, same batching,
        # same checkpoint cadence, NO store — rids are submission
        # order in both runs, so digests compare rid-for-rid
        svc0 = FleetService(max_batch=max_batch,
                            checkpoint_every=checkpoint_every, device=dev)
        warm(trace, svc0)
        results, svc0, wall = run_service(trace, service=svc0)
        baseline = {
            "digests": {i: result_digest(r)
                        for i, r in enumerate(results)},
            "dispatches": svc0._dispatch_count,
            "wall_s": wall,
        }
    kill_after = max(1, int(baseline["dispatches"] * kill_frac))
    if run_dir is None:
        run_dir = tempfile.mkdtemp(prefix="gossip-run-")

    if child:
        cp = run_killed_serve(run_dir, seeds_per_template, n_overlay,
                              t_overlay, max_batch, checkpoint_every,
                              kill_after, device=dev.type)
        if cp.returncode != KILL_EXIT:
            raise RuntimeError(
                f"doomed child exited {cp.returncode}, expected "
                f"{KILL_EXIT} (killed mid-run); stderr tail:\n"
                + "\n".join(cp.stderr.splitlines()[-15:]))
    else:
        finished = _serve(run_dir, seeds_per_template, n_overlay,
                          t_overlay, max_batch, checkpoint_every,
                          kill_after, device=dev)
        if finished:
            raise RuntimeError(
                f"in-process serve finished below kill_after="
                f"{kill_after}; pick a smaller kill_frac")

    # pre-kill terminal outcomes come from the dead process's journal
    pre = {}
    for rec in read_journal(run_dir):
        if rec.get("rec") == "outcome":
            if rec["status"] == "failed":
                raise RuntimeError(
                    f"rid {rec['rid']} FAILED before the kill "
                    f"({rec.get('error')}) — the gate stream has no "
                    f"failure plane; this is a bug")
            pre[rec["rid"]] = rec.get("digest")

    svc, handles = FleetService.recover(run_dir, device=dev)
    if not _drive(svc):
        raise RuntimeError("recovered service stalled")
    post = {rid: result_digest(h.result())
            for rid, h in handles.items()}

    overlap = set(pre) & set(post)
    if overlap:
        raise RuntimeError(
            f"{len(overlap)} requests terminal in BOTH processes "
            f"(e.g. rid {sorted(overlap)[0]}) — double service")
    got = {**pre, **post}
    want = set(range(len(trace)))
    if set(got) != want:
        missing = sorted(want - set(got))[:5]
        extra = sorted(set(got) - want)[:5]
        raise RuntimeError(
            f"completion gate: {len(got)}/{len(trace)} terminal "
            f"(missing {missing}, extra {extra})")
    restarted = svc.stats()["elastic"]["restarted_lanes"]
    if restarted != 0:
        raise RuntimeError(
            f"restarted_lanes == {restarted} across the death "
            f"(gate requires 0)")
    bad = [rid for rid in sorted(got)
           if got[rid] != baseline["digests"][rid]]
    if bad:
        raise RuntimeError(
            f"{len(bad)} digest mismatches vs the uninterrupted "
            f"baseline (first: rid {bad[0]})")

    stats = svc.stats()
    metrics = {
        "requests": len(trace),
        "completed": len(got),
        "completion_rate": len(got) / len(trace),
        "completed_before_kill": len(pre),
        "recovered_requests": len(post),
        "restarted_lanes": restarted,
        "digest_match": True,
        "outcome_digest": _digest_of(got),
        "baseline_digest": _digest_of(baseline["digests"]),
        "kill_after_dispatches": kill_after,
        "baseline_dispatches": baseline["dispatches"],
        "checkpoint_every": checkpoint_every,
        "max_batch": max_batch,
        "cross_process": bool(child),
        "failures": stats["failures"],
        "durability": stats["durability"],
        "run_dir": run_dir,
    }
    return metrics, baseline


def main(argv) -> int:
    """``python -m gossip_protocol_tpu_torch.store.harness serve <run_dir>
    <seeds> <n> <t> <max_batch> <checkpoint_every> <kill_after>
    <device>`` — the doomed child of :func:`run_killed_serve`."""
    if len(argv) != 9 or argv[0] != "serve":
        print(main.__doc__, file=sys.stderr)
        return 2
    run_dir = argv[1]
    seeds, n, t, mb, ce, kill_after = (int(a) for a in argv[2:8])
    finished = _serve(run_dir, seeds, n, t, mb, ce, kill_after,
                      on_kill=lambda: os._exit(KILL_EXIT), device=argv[8])
    return 0 if finished else 1  # 1: unreachable (on_kill exits)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

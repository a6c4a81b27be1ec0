"""Acceptance grader: the Grader.sh checks, reimplemented over dbg.log
(counterpart of ``gossip_protocol_tpu/grader.py``; the checks are
copied line for line, the scenarios run on the port).

The reference's grading harness (Grader.sh:40-189) greps dbg.log for
"joined"/"removed"/"Node failed at time" lines and scores three
scenarios (max attainable 90/100 — the msgdrop accuracy block is
commented out, Grader.sh:181-189).  This module reproduces those checks
line-for-line in Python — including grep's *substring* matching of
address strings — so it can grade this framework's output and the
reference binary's output identically.

Run all three scenarios and grade them:

    python -m gossip_protocol_tpu_torch.grader [--testcases DIR] [--device cpu]
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


def _lines(dbg_path: str, needle: str) -> list[str]:
    with open(dbg_path) as f:
        return [ln for ln in f.read().split("\n") if needle in ln]


def _uniq(lines: list[str]) -> list[str]:
    return sorted(set(lines))


def _observer(line: str) -> str:
    """Field 2 of a log line (cut -d' ' -f2): the observer address."""
    return line.split(" ")[1] if line.startswith(" ") else line.split(" ")[0]


def _subject(line: str) -> str:
    """The 'Node <addr>' subject of a joined/removed line."""
    m = re.search(r"Node (\S+) (?:joined|removed)", line)
    return m.group(1) if m else ""


@dataclass
class ScenarioGrade:
    name: str
    join_points: int = 0
    join_max: int = 10
    completeness_points: int = 0
    completeness_max: int = 10
    accuracy_points: int = 0
    accuracy_max: int = 10
    detail: dict = field(default_factory=dict)

    @property
    def points(self) -> int:
        return self.join_points + self.completeness_points + self.accuracy_points

    @property
    def max_points(self) -> int:
        return self.join_max + self.completeness_max + self.accuracy_max


def check_join(dbg_path: str, n: int = 10) -> bool:
    """Join completeness (Grader.sh:40-60): either N*N unique
    (observer, subject-phrase) pairs, or every one of N observers saw
    N-1 distinct others."""
    joined = _uniq(_lines(dbg_path, "joined"))
    pairs = {(_observer(ln), _subject(ln)) for ln in joined}
    if len(pairs) == n * n:
        return True
    observers = {_observer(ln) for ln in joined}
    ok = 0
    for obs in observers:
        subs = {_subject(ln) for ln in joined
                if _observer(ln) == obs and obs not in _subject(ln)}
        if len(subs) == n - 1:
            ok += 1
    return ok == n


def failed_addrs(dbg_path: str) -> list[str]:
    """Failed-node addresses (Grader.sh:61: awk '{print $1}' on the
    'Node failed at time' lines — $1 is the observer address because the
    line starts with a space)."""
    return _uniq([_observer(ln) for ln in _lines(dbg_path, "Node failed at time")])


def grade_single(dbg_path: str, n: int = 10,
                 join_pts: int = 10, comp_pts: int = 10,
                 acc_pts: int | None = 10) -> ScenarioGrade:
    """Single-failure scoring (Grader.sh:40-76; msgdrop variant uses
    15/15 and skips accuracy, Grader.sh:152-189)."""
    g = ScenarioGrade("single", join_max=join_pts, completeness_max=comp_pts,
                      accuracy_max=acc_pts or 0)
    if check_join(dbg_path, n):
        g.join_points = join_pts
    failed = failed_addrs(dbg_path)
    removed = _uniq(_lines(dbg_path, "removed"))
    failcount = sum(1 for ln in removed if any(a in ln for a in failed))
    g.detail["failcount"] = failcount
    if failcount >= n - 1:
        g.completeness_points = comp_pts
    if acc_pts:
        wrong = sum(1 for ln in removed if not any(a in ln for a in failed))
        g.detail["false_removals"] = wrong
        if wrong == 0 and failcount > 0:
            g.accuracy_points = acc_pts
    return g


def grade_multi(dbg_path: str, n: int = 10) -> ScenarioGrade:
    """Multi-failure scoring (Grader.sh:89-139): per failed node,
    completeness needs >=5 observers (2 pts each, first 6 nodes checked);
    accuracy needs exactly 20 unique removal lines not mentioning it."""
    g = ScenarioGrade("multi")
    if check_join(dbg_path, n):
        g.join_points = 10
    failed = failed_addrs(dbg_path)
    removed = _uniq(_lines(dbg_path, "removed"))
    comp = 0
    for k, a in enumerate(failed):
        if k >= 6:
            break
        if sum(1 for ln in removed if a in ln) >= 5:
            comp += 2
    g.completeness_points = min(comp, 10)
    acc = 0
    for a in failed:
        if sum(1 for ln in removed if a not in ln) == 20:
            acc += 2
        if acc > 9:
            break
    g.accuracy_points = min(acc, 10)
    return g


def grade_all(run_scenario_fn=None, testcases_dir: str = "testcases",
              workdir: str = ".", device=None) -> dict:
    """Grade the three shipped scenarios; mirrors Grader.sh's totals.

    ``run_scenario_fn(conf_path, workdir)`` must produce
    ``workdir/dbg.log`` for the given testcase; the default runs each
    scenario on the port, sequentially, on ``device`` (``cuda`` unless
    ``cpu`` is asked for).
    """
    if run_scenario_fn is None:
        def run_scenario_fn(conf, wd):
            _default_runner(conf, wd, device)
    dbg = os.path.join(workdir, "dbg.log")
    results = {}

    run_scenario_fn(os.path.join(testcases_dir, "singlefailure.conf"), workdir)
    results["singlefailure"] = grade_single(dbg)

    run_scenario_fn(os.path.join(testcases_dir, "multifailure.conf"), workdir)
    results["multifailure"] = grade_multi(dbg)

    run_scenario_fn(os.path.join(testcases_dir, "msgdropsinglefailure.conf"), workdir)
    results["msgdropsinglefailure"] = grade_single(
        dbg, join_pts=15, comp_pts=15, acc_pts=None)

    results["total"] = sum(r.points for r in results.values()
                           if isinstance(r, ScenarioGrade))
    return results


def _default_runner(conf: str, workdir: str, device=None) -> None:
    from .config import SimConfig
    from .core.sim import run_scenario
    run_scenario(SimConfig.from_conf(conf), outdir=workdir, device=device)


#: the three shipped scenarios, in Grader.sh order
SCENARIOS = ("singlefailure", "multifailure", "msgdropsinglefailure")


def grade_all_fleet(testcases_dir: str = "testcases", workdir: str = ".",
                    device=None) -> dict:
    """Grade the three shipped scenarios from one fleet run (the JAX
    ``grade_all_fleet``).

    The scenarios share a fleet shape (N=10, 700 ticks; their single /
    multi / drop differences are all schedule data), so they run as one
    B=3 :class:`~.core.fleet.FleetSimulation` on ``device`` (``cuda``
    unless ``cpu``): one draw, one merge and one epilogue launch a tick
    for the three lanes on a card.  Per-lane events are bit-identical
    to the solo runs, so the grades and totals equal :func:`grade_all`'s.
    The command line has no switch for it, as in the JAX package.
    """
    from .config import SimConfig
    from .core.fleet import FleetSimulation

    cfgs = [SimConfig.from_conf(os.path.join(testcases_dir, f"{s}.conf"))
            for s in SCENARIOS]
    fleet = FleetSimulation(cfgs[0], device=device).run(configs=cfgs)
    dbg = os.path.join(workdir, "dbg.log")
    results = {}
    for name, lane in zip(SCENARIOS, fleet.lanes):
        lane.write_logs(workdir)
        if name == "singlefailure":
            results[name] = grade_single(dbg)
        elif name == "multifailure":
            results[name] = grade_multi(dbg)
        else:
            results[name] = grade_single(dbg, join_pts=15, comp_pts=15,
                                         acc_pts=None)
    results["total"] = sum(r.points for r in results.values()
                           if isinstance(r, ScenarioGrade))
    return results


def grade_all_service(testcases_dir: str = "testcases",
                      workdir: str = ".", service=None, device=None) -> dict:
    """Grade the three shipped scenarios through the fleet SERVICE (the
    JAX ``grade_all_service``).

    Each scenario is submitted as a trace request to a
    :class:`~.service.FleetService` (on ``device``: ``cuda`` unless
    ``cpu``) and graded from its handle's lane result.  The bucketer
    does the batching: single and multi share one bucket (equal shape
    and segment plan), msgdrop's drop window lands in its own.  Per-lane
    events are bit-identical to solo runs, so the totals mirror
    :func:`grade_all` exactly.
    """
    from .config import SimConfig
    from .service import FleetService

    svc = service if service is not None else FleetService(
        max_batch=len(SCENARIOS), pad_policy="none", device=device)
    handles = [svc.submit(SimConfig.from_conf(
        os.path.join(testcases_dir, f"{s}.conf")), mode="trace")
        for s in SCENARIOS]
    svc.drain()
    dbg = os.path.join(workdir, "dbg.log")
    results = {}
    for name, h in zip(SCENARIOS, handles):
        h.result().write_logs(workdir)
        if name == "multifailure":
            results[name] = grade_multi(dbg)
        elif name == "msgdropsinglefailure":
            results[name] = grade_single(dbg, join_pts=15, comp_pts=15,
                                         acc_pts=None)
        else:
            results[name] = grade_single(dbg)
    results["total"] = sum(r.points for r in results.values()
                           if isinstance(r, ScenarioGrade))
    return results


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Grade the three scenarios "
                                 "(Grader.sh-equivalent checks)")
    ap.add_argument("--testcases", default="testcases")
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device for the N=10 grading runs (default cuda; "
                         "raises when no card is visible)")
    ap.add_argument("--log", default=None, metavar="DBG_LOG",
                    help="grade an existing dbg.log instead of running "
                         "the scenarios (use with --kind)")
    ap.add_argument("--kind", default="single",
                    choices=["single", "multi", "drop"],
                    help="scenario kind of --log")
    args = ap.parse_args(argv)

    if args.log is not None:
        if args.kind == "single":
            g = grade_single(args.log)
        elif args.kind == "multi":
            g = grade_multi(args.log)
        else:
            g = grade_single(args.log, join_pts=15, comp_pts=15, acc_pts=None)
        print(f"{args.log}: {g.points}/{g.max_points}  {g.detail}")
        return 0 if g.points == g.max_points else 1

    results = grade_all(None, args.testcases, args.workdir, args.device)
    for name, g in results.items():
        if isinstance(g, ScenarioGrade):
            print(f"{name}: join {g.join_points}/{g.join_max}  "
                  f"completeness {g.completeness_points}/{g.completeness_max}  "
                  f"accuracy {g.accuracy_points}/{g.accuracy_max}")
    print(f"Final grade {results['total']}")
    return 0 if results["total"] == 90 else 1


if __name__ == "__main__":
    raise SystemExit(main())

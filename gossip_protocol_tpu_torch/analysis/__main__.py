"""CLI: ``python -m gossip_protocol_tpu_torch.analysis``.

Runs the port's invariant passes and exits non-zero on any finding.
``--list`` prints the rule catalog; ``--pass`` / ``--rule`` restrict the
run (an unknown rule, or one whose pass is deselected, is refused: the
run would check nothing); ``--json`` prints one machine-readable
document; ``--device`` is where the runtime and guard passes run their
small programs: the card by default (the run stops when none is
visible), or ``cpu``, where the two sync-debug rules are reported as not
checked (``set_sync_debug_mode`` acts only on a card) and a run asking
for them by ``--rule`` is refused.
"""

from __future__ import annotations

import argparse
import json
import sys


def _roster() -> list[dict]:
    from .runtime import check
    return [{"name": p.name, "provenance": p.provenance,
             "rules": list(p.rules), "notes": p.notes}
            for p in check.last_programs]


def main(argv=None) -> int:
    from . import (NOTHING_TO_CHECK, PASSES, RULES, rule_names, run_all,
                   unchecked_rules)
    from ..state import resolve_device
    ap = argparse.ArgumentParser(
        prog="python -m gossip_protocol_tpu_torch.analysis",
        description="the port's invariant analysis")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--rule", action="append",
                    help="run only this rule (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON document (findings and the "
                         "runtime programs) instead of the report; the "
                         "exit code is the same")
    ap.add_argument("--list", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--device", default="cuda",
                    help="device of the runtime and guard passes "
                         "(default cuda; cpu leaves the sync-debug rules "
                         "unchecked)")
    args = ap.parse_args(argv)

    if args.list:
        for r in RULES:
            print(f"{r.name:34s} [{r.pass_name}]  {r.protects}")
        return 0

    passes = tuple(args.passes) if args.passes else PASSES
    rules = tuple(args.rule) if args.rule else None
    if rules is not None:
        unknown = [r for r in rules if r not in set(rule_names())]
        if unknown:
            ap.error(f"unknown rule(s) {unknown}; see --list")
        runnable = {r.name for r in RULES if r.pass_name in passes}
        dead = [r for r in rules if r not in runnable]
        if dead:
            ap.error(f"rule(s) {dead} are not in the selected pass(es) "
                     f"{list(passes)} — this run would check nothing; "
                     "drop --pass or fix --rule")
    device = None
    if "runtime" in passes or "guard" in passes:
        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(str(e))
    skip = set(unchecked_rules(device)) if device is not None else set()
    if rules is not None and set(rules) <= skip:
        ap.error(f"rule(s) {list(rules)} are checked only on a card "
                 f"(set_sync_debug_mode); {device} would check nothing")
    findings = run_all(passes=passes, rules=rules, device=device)
    selected = [r.name for r in RULES if r.pass_name in passes
                and (rules is None or r.name in rules)]
    active = [r for r in selected
              if r not in skip and r not in NOTHING_TO_CHECK]
    unchecked = [r for r in selected if r in skip]
    idle = [r for r in selected if r in NOTHING_TO_CHECK]
    programs = _roster() if "runtime" in passes else []

    if args.json:
        print(json.dumps({
            "ok": not findings, "passes": list(passes), "rules": active,
            "not_checked": unchecked, "nothing_to_check": idle,
            "device": None if device is None else str(device),
            "programs": programs,
            "findings": [{"rule": f.rule, "where": f.where,
                          "detail": f.detail, "path": f.path}
                         for f in findings],
            "count": len(findings)}, indent=1))
        return 1 if findings else 0

    where = "" if device is None else f" on {device}"
    print(f"analysis: {len(active)} rule(s) over passes "
          f"{'+'.join(passes)}{where}: {', '.join(active)}")
    if unchecked:
        print(f"not checked on {device}: {', '.join(unchecked)} "
              "(set_sync_debug_mode acts only on a card; run with "
              "--device cuda)")
    if idle:
        print(f"nothing to check: {', '.join(idle)} (the port updates "
              "state tensors in place)")
    for p in programs:
        print(f"  program {p['name']}: {len(p['rules'])} rule(s)  "
              f"({p['notes']})")
    if findings:
        print(f"\n{len(findings)} finding(s):\n", file=sys.stderr)
        for f in findings:
            print(f"  {f}\n", file=sys.stderr)
        return 1
    print("clean: no findings")
    return 0


if __name__ == "__main__":
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    raise SystemExit(main())

"""Invariant analysis for the port (counterpart of
``gossip_protocol_tpu/analysis/``).

The JAX package holds its engine and serving stack to structural
invariants with four passes; the port keeps the same sixteen rules and
checks each one its own way, because the port traces no program:

* :mod:`.purity_lint` and :mod:`.cache_keys` (pass ``ast``) — the JAX
  package's source rules, retargeted at ``gossip_protocol_tpu_torch/``:
  seeded draws only in the replay paths, host staging free of device
  tensor work, no in-place writes into host views, journal before
  terminal status, every config field a cached builder reads folded
  into its key;
* :mod:`.runtime` (pass ``runtime``) — the invariants the JAX package
  reads off traced programs (``jaxpr_audit.py``, ``sharding_flow.py``)
  become counts over small registered runs: draw calls a fleet tick and
  a K2 stack, collectives by mesh axis, replicated ``shard_map`` outputs
  equal on every shard, the 2-D mesh's specs against the ones derived
  from the state's fields, no host sync in a solo run's tick loop;
* :mod:`.guards` (pass ``guard``) — a warmed lap builds no run and
  starts no nvcc; a launched fleet's wait and resolve make no implicit
  host-device transfer.

Run everything: ``python -m gossip_protocol_tpu_torch.analysis`` (on the
card; ``--device cpu`` runs the small programs on the CPU, where the two
sync-debug rules are reported as not checked; exits non-zero on any
finding; ``--list`` prints the catalog below).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Finding:
    """One rule violation, with enough provenance to act on it."""

    rule: str     # rule name from the catalog below
    where: str    # program name or file:line
    detail: str   # what is wrong, in one sentence
    path: str = ""  # function or source line

    def __str__(self) -> str:
        loc = f"{self.where}" + (f" [{self.path}]" if self.path else "")
        return f"{self.rule}: {loc}\n    {self.detail}"


@dataclass
class RuleInfo:
    """Catalog entry: which pass checks a rule and what it protects in
    the port."""

    name: str
    pass_name: str   # "ast" | "runtime" | "guard"
    protects: str


#: The rule catalog: the JAX package's sixteen names, each with the
#: port's pass and what it protects here.
RULES: tuple[RuleInfo, ...] = (
    RuleInfo("cond-stays-cond", "runtime",
             "the drop draw stays shared: one draw call a fleet tick for "
             "all its lanes and one a K2 call for its whole tick stack, "
             "never one a lane or a tick"),
    RuleInfo("zero-collectives-per-tick", "runtime",
             "solo runs, fleets and the lane mesh issue no collective"),
    RuleInfo("donation-taken", "runtime",
             "nothing to check: the port updates state tensors in place "
             "and never copies a carry a JAX program would donate; the "
             "rule reports no finding"),
    RuleInfo("no-transfer-in-scan", "runtime",
             "a solo run's tick loop makes no host-device sync or "
             "pageable copy (torch.cuda.set_sync_debug_mode('error'); "
             "checked only on a card)"),
    RuleInfo("no-wall-clock-in-pure-paths", "ast",
             "worlds/faults/traffic/scenarios and the ring order draw "
             "only from seeded (seed, idx) keys; no time.* calls, no "
             "mutable RNG"),
    RuleInfo("host-staging-is-numpy", "ast",
             "schedule builders, host lane stacking, checkpoint snapshot "
             "and stitch and the store's spill and journal build no "
             "torch tensor and call no .to( / .cuda("),
    RuleInfo("no-inplace-on-host-views", "ast",
             "no slice writes into arrays aliased from result or metric "
             "attributes (.numpy() views of tensors included)"),
    RuleInfo("cache-key-complete", "ast",
             "every SimConfig field a cached builder reads is folded into "
             "its fleet / bucket key or flows through the schedule as "
             "data"),
    RuleInfo("canon-key-complete", "ast",
             "every SimConfig field a canonical-path builder reads is "
             "folded into the equivalence-class key or rides the padded "
             "schedule as per-request data"),
    RuleInfo("lanes-axis-zero-collectives", "runtime",
             "no collective runs over the lanes axis of a mesh program "
             "(1-D lane mesh and 2-D lanes x peers)"),
    RuleInfo("peers-axis-collective-budget", "runtime",
             "every tick of the 2-D fleet program issues on the peers "
             "axis exactly the collectives its comm owes a shard-tick, "
             "at most LANE_PEER_TICK_COLLECTIVE_BUDGET"),
    RuleInfo("replicated-plane-stays-replicated", "runtime",
             "every P() output of a registered shard_map is equal on all "
             "shards (the stitch keeps the first shard's)"),
    RuleInfo("spec-derivation-consistent", "runtime",
             "the 2-D program's shard_map specs equal the ones derived "
             "from the WorldState / Schedule fields, and "
             "compose_lane_peer_specs agrees"),
    RuleInfo("journal-before-mutation", "ast",
             "every terminal-status setter in the scheduler and recovery "
             "is dominated by its write-ahead journal.outcome append"),
    RuleInfo("no-recompile-steady-state", "guard",
             "a warmed second lap builds no fleet program "
             "(core/tick.py run_build_count) and starts no nvcc"),
    RuleInfo("no-implicit-transfer-in-resolve", "guard",
             "a launched fleet's wait and resolve make no implicit "
             "host-device transfer (set_sync_debug_mode('error'); checked "
             "on a card)"),
)

PASSES = ("ast", "runtime", "guard")

#: the rules read by ``torch.cuda.set_sync_debug_mode``, which acts only
#: on a card
SYNC_DEBUG_RULES = ("no-transfer-in-scan", "no-implicit-transfer-in-resolve")

#: catalogued rules with nothing to check in the port
NOTHING_TO_CHECK = ("donation-taken",)


def rule_names() -> list[str]:
    return [r.name for r in RULES]


def unchecked_rules(device) -> tuple:
    """The rules a run on ``device`` cannot check: the sync-debug rules
    off a card."""
    import torch
    return () if torch.device(device).type == "cuda" else SYNC_DEBUG_RULES


def run_all(passes=PASSES, rules=None, device=None) -> list[Finding]:
    """Run the passes and return every finding.  ``rules`` restricts to
    a subset of rule names; ``device`` is where the runtime and guard
    passes run their small programs: the card unless the caller asks for
    ``cpu`` (raising when no card is visible), where the rules of
    :func:`unchecked_rules` are left out."""
    findings: list[Finding] = []
    if "ast" in passes:
        from . import cache_keys, purity_lint
        findings += purity_lint.lint(rules=rules)
        findings += [f for f in cache_keys.check()
                     if rules is None or f.rule in rules]
    if "runtime" in passes or "guard" in passes:
        from ..state import resolve_device
        device = resolve_device(device)
    if "runtime" in passes:
        from . import runtime
        findings += runtime.check(rules=rules, device=device)
    if "guard" in passes:
        from . import guards
        findings += guards.self_check(rules=rules, device=device)
    return findings


__all__ = ["Finding", "RuleInfo", "RULES", "PASSES", "SYNC_DEBUG_RULES",
           "NOTHING_TO_CHECK", "rule_names", "unchecked_rules", "run_all"]

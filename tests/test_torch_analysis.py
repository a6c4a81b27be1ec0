"""The port's invariant analysis (gossip_protocol_tpu_torch/analysis/).

Every rule both ways, as tests/test_analysis.py holds the JAX package's:
the clean port tree gives no finding, and a synthetic violation fires
the rule — a fixture source for the AST rules, an injected extra draw
call / collective / disagreeing shard / wrong spec / rebuild for the
runtime and guard rules.  The passes run on the card unless asked for
the CPU; these tests ask.  The sync-debug rules (``no-transfer-in-scan``,
``no-implicit-transfer-in-resolve``) bite only on a card, so on the CPU
they are reported as not checked: their firing cases are in
tests/test_torch_cuda.py.  Runs at N <= 64 for a few ticks.
"""

import dataclasses
import json
import subprocess

import pytest
import torch

from gossip_protocol_tpu.analysis import rule_names as jax_rule_names
from gossip_protocol_tpu_torch.analysis import (RULES, Finding, rule_names,
                                                run_all)
from gossip_protocol_tpu_torch.analysis import __main__ as cli
from gossip_protocol_tpu_torch.analysis import (cache_keys, guards,
                                                purity_lint, runtime)
from gossip_protocol_tpu_torch.parallel import mesh as pmesh


def _program(name):
    return next(p for p in runtime.build_programs() if p.name == name)


def _fire(prog, rules=None):
    return runtime.check_observation(prog, runtime.observe(prog, "cpu"),
                                     rules)


# ---- the catalog -----------------------------------------------------
def test_catalog_keeps_the_jax_rule_names():
    assert rule_names() == jax_rule_names()
    assert len(RULES) == 16
    assert {r.pass_name for r in RULES} == {"ast", "runtime", "guard"}
    donation = [r for r in RULES if r.name == "donation-taken"][0]
    assert "nothing to check" in donation.protects
    assert not any(
        "nothing to check" in r.protects or "not applicable" in r.protects
        for r in RULES if r.name != "donation-taken")
    # every runtime rule but donation-taken is held by a program
    held = {r for p in runtime.build_programs() for r in p.rules}
    runtime_rules = {r.name for r in RULES if r.pass_name == "runtime"}
    assert held == runtime_rules - {"donation-taken"}


# ---- the clean tree --------------------------------------------------
def test_clean_tree_passes_ast_rules():
    findings = purity_lint.lint() + cache_keys.check()
    assert findings == [], "\n".join(str(f) for f in findings)
    assert cache_keys.overlay_bakes_whole_config()


def test_clean_tree_passes_runtime_rules():
    findings = runtime.check(device="cpu")
    assert findings == [], "\n".join(str(f) for f in findings)
    names = {p.name for p in runtime.check.last_programs}
    assert {"solo-dense-trace", "solo-overlay", "solo-dense-composed",
            "solo-overlay-composed", "fleet-dense-bench", "fleet-overlay",
            "fleet-dense-leg", "mesh-dense-bench-d2",
            "mesh2d-lanes-peers"} == names


def test_clean_tree_passes_guards():
    assert guards.self_check(device="cpu") == []


def test_every_named_function_exists():
    """The retargeted rule lists name only functions the port defines."""
    for spec in (purity_lint.HOST_STAGING_FUNCS,
                 purity_lint.RING_ORDER_FUNCS, cache_keys.BUILDER_FUNCS,
                 cache_keys.KEY_FUNCS, cache_keys.DATA_FUNCS,
                 cache_keys.CANON_KEY_FUNCS, cache_keys.CANON_BUILDER_FUNCS):
        assert all(f.startswith("gossip_protocol_tpu_torch/") for f in spec)
        assert cache_keys.missing_functions(spec) == []


def test_renamed_function_is_a_finding(monkeypatch):
    monkeypatch.setitem(
        purity_lint.HOST_STAGING_FUNCS, "gossip_protocol_tpu_torch/state.py",
        ("make_schedule_host", "make_schedule_host_gone"))
    monkeypatch.setitem(
        cache_keys.KEY_FUNCS, "gossip_protocol_tpu_torch/config.py",
        ("worlds_key", "worlds_key_gone"))
    lint = [f for f in purity_lint.lint() if f.path.endswith("_gone")]
    keys = [f for f in cache_keys.check() if f.path.endswith("_gone")]
    assert [f.rule for f in lint] == ["host-staging-is-numpy"]
    assert [f.rule for f in keys] == ["cache-key-complete"]


# ---- the allowlist ---------------------------------------------------
def test_allowlist_entries_are_justified_and_live():
    entries, bad = purity_lint.load_allowlist()
    assert bad == [] and len(entries) == 2
    for e in entries:
        assert e.why.strip()
        raw = purity_lint.raw_findings(e.rule, e.file)
        assert any(e.match in f.path for f in raw), \
            f"stale allowlist entry (masks nothing): {e}"


def test_allowlist_entry_without_why_is_a_finding(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\nrule = "host-staging-is-numpy"\n'
                 'file = "gossip_protocol_tpu_torch/state.py"\n'
                 'match = "torch.zeros"\n\n'
                 '[[allow]]\nrule = "no-wall-clock-in-pure-paths"\n'
                 'file = "x.py"\nmatch = "time.time()"\nwhy = "  "\n')
    entries, bad = purity_lint.load_allowlist(str(p))
    assert entries == [] and len(bad) == 2
    assert all(f.rule == "allowlist" and "why" in f.detail for f in bad)
    p.write_text("[[allow]\nrule = ")
    _, bad = purity_lint.load_allowlist(str(p))
    assert [f.rule for f in bad] == ["allowlist"]


# ---- AST rule fixtures -----------------------------------------------
def test_unseeded_rng_and_wall_clock_are_caught():
    src = """
import random
import time
import time as clk
from time import perf_counter
import numpy as np

def bad_draw(seed, idx):
    rng = np.random.default_rng()           # unseeded
    r2 = np.random.default_rng(seed)        # non-tuple key
    u = np.random.random()                  # mutable global RNG
    t = time.perf_counter()                 # wall clock call
    t2 = perf_counter()                     # from-import escape
    t3 = clk.monotonic()                    # module-alias escape
    r = random.random()                     # stdlib global RNG
    return rng, r2, u, t, t2, t3, r

def good_draw(seed, idx, now=time.perf_counter):
    rng = np.random.default_rng((seed, idx))
    return rng.random()
"""
    findings = purity_lint.lint_source(src, rule="no-wall-clock-in-pure-paths")
    assert len(findings) == 7, [str(f) for f in findings]
    assert {int(f.where.split(":")[-1]) for f in findings} == \
        set(range(9, 16))


def test_wall_clock_in_ring_order_is_caught():
    src = """
import time

class Svc:
    def _harvest_ready(self):
        return sorted(self._rings, key=lambda k: time.monotonic())

    def _deadline_slack(self, req):
        return req.deadline - time.monotonic()
"""
    findings = purity_lint.lint_source(
        src, rule="no-wall-clock-in-pure-paths",
        pure_funcs=("_harvest_ready",))
    assert [f.where.split(":")[-1] for f in findings] == ["6"]
    rel = "gossip_protocol_tpu_torch/service/scheduler.py"
    assert rel in purity_lint.RING_ORDER_FUNCS
    assert purity_lint.raw_findings("no-wall-clock-in-pure-paths", rel) == []


@pytest.mark.parametrize("body,hit", [
    ("return torch.stack([torch.as_tensor(x) for x in trees])",
     "torch.stack"),
    ("return torch.zeros(4, device='cuda')", "torch.zeros"),
    ("return torch.from_numpy(np.stack(trees)).to('cuda')", ".to("),
    ("return torch.from_numpy(np.stack(trees)).cuda()", ".cuda("),
    ("return torch.from_numpy(np.stack(trees)).pin_memory()", None),
])
def test_device_work_in_staging_function_is_caught(body, hit):
    src = f"""
import numpy as np
import torch

def stack_lanes_host(trees):
    {body}

def other(trees):
    return torch.zeros(4, device='cuda')
"""
    findings = purity_lint.lint_source(
        src, rule="host-staging-is-numpy", staging_funcs=("stack_lanes_host",))
    if hit is None:
        assert findings == []
    else:
        assert len(findings) == 1 and findings[0].path == "stack_lanes_host"
        assert hit in findings[0].detail


def test_inplace_write_on_host_view_is_caught():
    src = """
import numpy as np

def poison_direct(lane):
    lane.metrics.sent[:] = -1

def poison_via_numpy(lane):
    sent = lane.final_state.ids.numpy()     # shares the tensor's memory
    sent[...] = -1

def poison_via_alias(lane):
    m = np.asarray(lane.metrics.recv)
    m2 = m.reshape(2, -1)
    m2[:] = 0

def fine(lane, y):
    out = np.zeros(8)
    out[:4] = 1
    safe = np.array(lane.metrics.sent)
    safe[:] = 0
    lane.chunks[-1] = y
"""
    findings = purity_lint.lint_source(src, rule="no-inplace-on-host-views")
    assert {f.where.split(":")[-1] for f in findings} == {"5", "9", "14"}


def test_mutation_before_journal_is_caught():
    src = """
class Scheduler:
    def finish_ok(self, req, out):
        self.store.journal.outcome(req.rid, "completed", out)
        req._complete(out)

    def finish_bad(self, req, err):
        req._fail(err)
        self.store.journal.outcome(req.rid, "failed", err)
"""
    findings = purity_lint.lint_source(src, rule="journal-before-mutation")
    assert [f.path for f in findings] == ["finish_bad"]


def test_unkeyed_builder_field_fails_with_its_name():
    fixture = cache_keys.fields_read_source("""
def make_fixture_run(cfg):
    return cfg.total_ticks + cfg.drop_open_tick
""", funcs=("make_fixture_run",))
    assert set(fixture) == {"total_ticks", "drop_open_tick"}
    missing = cache_keys.missing_fields(
        builders=fixture,
        covered=cache_keys.covered_fields() - {"drop_open_tick"})
    assert set(missing) == {"drop_open_tick"}


def test_dropped_key_function_fails_check(monkeypatch):
    """With ``worlds_key`` gone from the keys, the world fields the
    builders read are no longer covered: check() names them."""
    monkeypatch.delitem(cache_keys.KEY_FUNCS,
                        "gossip_protocol_tpu_torch/config.py")
    monkeypatch.setattr(cache_keys, "DATA_MODULES", ())
    bad = {f.detail.split()[0] for f in cache_keys.check()
           if f.rule == "cache-key-complete"}
    assert "SimConfig.byz_rate" in bad


def test_unkeyed_canonical_field_fails_naming_builder_line():
    fixture = cache_keys.fields_read_source("""
def make_tick(cfg):
    return cfg.wave_size + cfg.flap_rate
""", funcs=("make_tick",), relfile="fixture_tick.py")
    missing = cache_keys.canonical_missing_fields(
        builders=fixture,
        covered=cache_keys.canonical_covered_fields() - {"wave_size"})
    assert missing == {"wave_size": ["fixture_tick.py:3"]}


def test_canonical_builder_reads_are_covered_by_name():
    builders = cache_keys.canonical_builder_fields()
    covered = cache_keys.canonical_covered_fields()
    for fld in ("max_nnb", "t_remove", "partition_groups"):
        assert fld in builders
        assert fld in cache_keys.canonical_missing_fields(
            builders=builders, covered=covered - {fld})
    assert "msg_drop_prob" not in builders


# ---- runtime rules ---------------------------------------------------
def test_per_lane_draw_is_caught(monkeypatch):
    """cond-stays-cond: a fleet tick that draws once a lane."""
    from gossip_protocol_tpu_torch.core import tick as tick_mod
    _fresh_fleet_programs(monkeypatch)
    real = tick_mod.drop_masks_lanes

    def per_lane(plan, t, n, *a, **k):
        for b in range(plan.batch - 1):
            real(plan.rows(b, b + 1), t, n, *a, **k)
        return real(plan, t, n, *a, **k)
    monkeypatch.setattr(tick_mod, "drop_masks_lanes", per_lane)
    findings = _fire(_program("fleet-dense-bench"))
    assert [f.rule for f in findings] == ["cond-stays-cond"]
    assert "drop_masks_lanes': 60" in findings[0].detail


def test_per_tick_draw_in_k2_is_caught(monkeypatch):
    """cond-stays-cond: a K2 call that draws once a tick of its stack."""
    from gossip_protocol_tpu_torch.core import dense_mega
    real = dense_mega.drop_stack

    def per_tick(rng, t0, s_ticks, n, sched, device):
        for s in range(s_ticks - 1):
            dense_mega.drop_masks(rng, t0 + s, [sched.drop_on(t0 + s)],
                                  sched.drop_prob, n, device=device)
        return real(rng, t0, s_ticks, n, sched, device)
    monkeypatch.setattr(dense_mega, "drop_stack", per_tick)
    findings = _fire(_program("solo-dense-trace"))
    assert [f.rule for f in findings] == ["cond-stays-cond"]


def _fresh_fleet_programs(monkeypatch):
    """An empty fleet program cache for the test, so the injected change
    is built into the program instead of a cached clean one (and the
    injected program never reaches a later test)."""
    from gossip_protocol_tpu_torch.core import fleet
    monkeypatch.setattr(fleet, "_FLEET_FN_CACHE", {})


def test_degree_of_reads_host_thresholds():
    """The repair no-transfer-in-scan found on the card: the overlay's
    degree column compares against the host thresholds one at a time
    (the threshold table's copy to the card synchronized every K4 run);
    the degrees are the table comparison's."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.models import overlay as pov
    from gossip_protocol_tpu_torch.ops.overlay_rules import _SALT_DEGREE
    from gossip_protocol_tpu_torch.utils.hash32 import MASK32, mix32_t
    for topo, n in (("powerlaw", 4096), ("uniform", 64)):
        cfg = SimConfig(model="overlay", max_nnb=n, topology=topo)
        sched = pov.make_overlay_schedule(cfg)
        rows = torch.arange(n)
        du = mix32_t(sched.seed, rows & MASK32, _SALT_DEGREE)
        thr = torch.tensor(sched.deg_thr, dtype=torch.int64)
        want = (1 + (du[:, None] < thr[None, :]).sum(1)).to(torch.int32)
        got = pov.degree_of(sched, rows)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(want.max()) > 1 and len(sched.deg_thr) >= 1


def _inject_collectives(monkeypatch, axis, count, first_tick_only=False):
    """``count`` extra psums on ``axis`` in the mesh programs' fleet tick,
    every tick or only each shard's first."""
    from gossip_protocol_tpu_torch.parallel import fleet_mesh
    _fresh_fleet_programs(monkeypatch)
    real = fleet_mesh.make_fleet_tick

    def make(*a, **k):
        tick = real(*a, **k)
        seen = set()

        def noisy(states, *b, **kk):
            me = pmesh.ctx().coords
            if not (first_tick_only and me in seen):
                for _ in range(count):
                    pmesh.ctx().psum(torch.zeros(1), axis)
            seen.add(me)
            return tick(states, *b, **kk)
        return noisy
    monkeypatch.setattr(fleet_mesh, "make_fleet_tick", make)


def test_lane_collective_is_caught(monkeypatch):
    """zero-collectives-per-tick and lanes-axis-zero-collectives: a psum
    over the lanes axis in the lane mesh's tick."""
    _inject_collectives(monkeypatch, "lanes", 1)
    rules = {f.rule for f in _fire(_program("mesh-dense-bench-d2"))}
    assert rules == {"zero-collectives-per-tick",
                     "lanes-axis-zero-collectives"}


@pytest.mark.parametrize("first_tick_only,bad", [(False, 30), (True, 1)])
def test_over_budget_peer_exchange_is_caught(monkeypatch, first_tick_only,
                                             bad):
    """peers-axis-collective-budget: the 2x4 tick owes 1 all_to_all, 3
    ppermutes and 1 psum on peers, the budget of 5; one extra psum busts
    it, in every tick or in the first alone (no average hides it)."""
    _inject_collectives(monkeypatch, "peers", 1, first_tick_only)
    findings = _fire(_program("mesh2d-lanes-peers"))
    assert [f.rule for f in findings] == ["peers-axis-collective-budget"]
    assert f"{bad} of 30 ticks" in findings[0].detail
    assert "tick 0 issued 6" in findings[0].detail


def test_owed_collectives_over_the_budget_are_caught(monkeypatch):
    """A comm that owes more than the budget a shard-tick fires the rule
    even when every tick issues what it owes."""
    from gossip_protocol_tpu_torch.parallel import fleet_mesh
    owed = fleet_mesh.lane_peer_tick_collectives(4)
    assert sum(owed.values()) == fleet_mesh.LANE_PEER_TICK_COLLECTIVE_BUDGET
    prog = runtime.Program("fixture-budget", "test",
                           ("peers-axis-collective-budget",), None)
    obs = runtime.Observation(
        ticks=2, expected_draws={}, owed_peer_collectives=owed,
        tick_collectives=[{("peers", k): n for k, n in owed.items()}] * 2)
    assert runtime.check_observation(prog, obs) == []
    monkeypatch.setattr(fleet_mesh, "LANE_PEER_TICK_COLLECTIVE_BUDGET", 4)
    findings = runtime.check_observation(prog, obs)
    assert [f.rule for f in findings] == ["peers-axis-collective-budget"]
    assert "over the budget of 4" in findings[0].detail


def test_collective_counts_once_a_collective():
    mesh = pmesh.Mesh([torch.device("cpu")] * 4, ("peers",))

    def body(x):
        pmesh.ctx().psum(x, "peers")
        pmesh.ctx().ppermute(x, "peers", [(0, 1), (1, 0), (2, 3), (3, 2)])
        return x
    pmesh.reset_collective_counts()
    pmesh.shard_map(body, mesh, in_specs=(pmesh.P("peers"),),
                    out_specs=pmesh.P("peers"))(torch.arange(8))
    assert pmesh.collective_counts() == {("peers", "psum"): 1,
                                         ("peers", "ppermute"): 1}


def test_disagreeing_replicated_output_is_caught():
    """replicated-plane-stays-replicated: a P() output that differs by
    shard (the stitch would keep shard 0's)."""
    mesh = pmesh.Mesh([torch.device("cpu")] * 2, ("lanes",))

    def body(x):
        return x, torch.tensor([pmesh.ctx().axis_index("lanes")])

    def run(device, section):
        with section():
            pmesh.shard_map(body, mesh, in_specs=(pmesh.P("lanes"),),
                            out_specs=(pmesh.P("lanes"), pmesh.P()))(
                torch.arange(4))
        return runtime.Observation(ticks=1, expected_draws={
            "drop_masks": 0, "drop_masks_lanes": 0})
    prog = runtime.Program("fixture-unequal", "test", (
        "replicated-plane-stays-replicated",), run)
    findings = _fire(prog)
    assert [f.rule for f in findings] == ["replicated-plane-stays-replicated"]
    assert "[1]" in findings[0].detail


def test_drifted_spec_is_caught(monkeypatch):
    """spec-derivation-consistent: a composition that drops the peer
    split of the ``gossip_age`` table (the bench tick carries it through
    untouched, so the run still completes) disagrees with the fields'
    derivation, in the composed tree and in the shard_map's specs."""
    from gossip_protocol_tpu_torch.parallel import fleet_mesh
    _fresh_fleet_programs(monkeypatch)
    real = fleet_mesh.compose_lane_peer_specs

    def drifted(lane, peer):
        return dataclasses.replace(real(lane, peer),
                                   gossip_age=pmesh.P("lanes"))
    monkeypatch.setattr(fleet_mesh, "compose_lane_peer_specs", drifted)
    findings = _fire(_program("mesh2d-lanes-peers"))
    assert {f.rule for f in findings} == {"spec-derivation-consistent"}
    assert len(findings) == 2
    assert all("'gossip_age'" in f.detail for f in findings)


def test_spec_derivation_matches_the_fields():
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.parallel.fleet_mesh import (
        _lane_specs, compose_lane_peer_specs)
    from gossip_protocol_tpu_torch.parallel.sharded import peer_spec_trees
    from gossip_protocol_tpu_torch.state import WorldState
    cfg = SimConfig(max_nnb=16, total_ticks=4)
    states = FleetSimulation(cfg, device="cpu")._init_stacked(
        [cfg.replace(seed=s) for s in (1, 2)], cfg.n)
    want, sched = runtime.derive_lane_peer_specs(states, cfg.n)
    got = compose_lane_peer_specs(_lane_specs(WorldState),
                                  peer_spec_trees()[0])
    assert got == want and sched == pmesh.P()
    assert want.known == pmesh.P("lanes", "peers", None)
    assert want.in_group == pmesh.P("lanes") and want.tick == pmesh.P()
    sched_specs = peer_spec_trees()[1]
    assert all(getattr(sched_specs, f.name) == pmesh.P()
               for f in dataclasses.fields(sched_specs))


# ---- guards ----------------------------------------------------------
def test_steady_state_gate_clean_and_injected():
    assert guards.steady_state_build_gate("cpu")["ok"]
    res = guards.steady_state_build_gate("cpu", inject_rebuild=True)
    assert not res["ok"] and res["runs"] == 1


def test_nvcc_build_trips_the_budget(monkeypatch, tmp_path):
    """A kernel library compiled inside the guarded block counts against
    the budget (nvcc itself faked: there is no nvcc here)."""
    from gossip_protocol_tpu_torch.ops.cuda import _build

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", ""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    with pytest.raises(guards.RebuildBudget, match="3 nvcc"):
        with guards.build_budget(0, what="fixture"):
            _build.build()
    with guards.build_budget(0, what="fixture") as c:
        _build.build()              # every library exists now
    assert c.nvcc == 0


def test_resolve_guard_refuses_the_cpu():
    """The transfer gate checks nothing off a card, so it refuses the
    CPU, and the guard pass leaves its rule out there."""
    with pytest.raises(ValueError, match="only on a card"):
        guards.resolve_transfer_gate("cpu")
    assert guards.self_check(rules=("no-implicit-transfer-in-resolve",),
                             device="cpu") == []


@pytest.mark.parametrize("call", [
    lambda: run_all(passes=("runtime",)),
    lambda: runtime.check(),
    lambda: guards.self_check(),
    lambda: guards.steady_state_build_gate(),
])
def test_passes_run_on_the_card_by_default(monkeypatch, call):
    """The runtime and guard passes run on the card unless the caller
    asks for the CPU, and raise when no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


# ---- the CLI ---------------------------------------------------------
def test_cli_rejects_unknown_and_deselected_rules(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--rule", "no-such-rule"])
    assert e.value.code == 2
    assert "unknown rule" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(["--pass", "ast", "--rule", "cond-stays-cond"])
    assert e.value.code == 2


def test_cli_list_and_json(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(r in out for r in rule_names())
    assert cli.main(["--pass", "ast", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["count"] == 0 and doc["passes"] == ["ast"]


def test_cli_defaults_to_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--pass", "runtime"])
    assert e.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_cli_reports_sync_rules_unchecked_on_cpu(monkeypatch, capsys):
    """On the CPU the sync-debug rules are reported as not checked and
    are not counted among the clean rules; asking for them alone is
    refused."""
    import gossip_protocol_tpu_torch.analysis as pkg
    from gossip_protocol_tpu_torch.analysis import SYNC_DEBUG_RULES
    monkeypatch.setattr(pkg, "run_all", lambda **kw: [])
    assert cli.main(["--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["not_checked"] == list(SYNC_DEBUG_RULES)
    assert doc["nothing_to_check"] == ["donation-taken"]
    assert not set(SYNC_DEBUG_RULES) & set(doc["rules"])
    assert len(doc["rules"]) == 13 and doc["device"] == "cpu"
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "13 rule(s)" in out and "not checked on cpu: " in out
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--rule", "no-transfer-in-scan"])
    assert e.value.code == 2
    assert "only on a card" in capsys.readouterr().err


def test_cli_exits_nonzero_on_a_finding(monkeypatch, capsys):
    monkeypatch.setattr(
        purity_lint, "lint",
        lambda rules=None: [Finding("host-staging-is-numpy", "x.py:1", "y")])
    assert cli.main(["--pass", "ast"]) == 1
    assert "host-staging-is-numpy" in capsys.readouterr().err


def test_module_entry_point_runs_clean(tmp_path):
    """``python -m gossip_protocol_tpu_torch.analysis`` on the tree: all
    three passes, exit 0."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "gossip_protocol_tpu_torch.analysis",
         "--device", "cpu"], cwd=root, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "clean: no findings" in res.stdout
    assert ("not checked on cpu: no-transfer-in-scan, "
            "no-implicit-transfer-in-resolve") in res.stdout
    assert run_all(passes=("ast",)) == []

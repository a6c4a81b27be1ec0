"""Runtime pass: the invariants the JAX package reads off traced programs
(``jaxpr_audit.py``, ``sharding_flow.py``), checked as counts over small
registered runs.

The port traces no program, so each rule becomes an observation of a
few ticks of a tiny config, on the device the pass is given (the card
unless the caller asks for ``cpu``), built from the same configs as the JAX
registry (``jaxpr_audit.py:174-206``):

``cond-stays-cond``
    The JAX rule keeps the shared drop draw a real ``lax.cond``, never a
    both-branches select run per lane or per tick.  Here: a fleet tick
    makes ONE draw call (``ops/drop.py drop_masks_lanes``) for all its
    lanes on each shard, and a K2 call makes ONE draw call
    (``drop_masks``) for its whole tick stack.  Counted by the wrappers'
    ``calls``, on any device.
``zero-collectives-per-tick`` / ``lanes-axis-zero-collectives``
    Solo runs, fleets and the lane mesh issue no collective; no mesh
    program issues one on the ``lanes`` axis (``parallel/mesh.py
    collective_counts``).
``peers-axis-collective-budget``
    Every tick of the 2-D lanes x peers fleet program issues on
    ``peers`` exactly the collectives its comm owes a shard-tick
    (``parallel/fleet_mesh.py lane_peer_tick_collectives``: 1
    ``all_to_all``, P - 1 ``ppermute``, 1 ``psum``), and those are at
    most ``LANE_PEER_TICK_COLLECTIVE_BUDGET``.  The program is registered
    on a 2 x 4 mesh, as the JAX one is, where the two are equal: one
    extra collective in any tick fires the rule.
``replicated-plane-stays-replicated``
    Every ``P()`` output of a registered ``shard_map`` is equal on all
    shards (``parallel/mesh.py observe_maps``; the stitch would keep
    the first shard's and hide a disagreement).
``spec-derivation-consistent``
    The 2-D program's ``shard_map`` specs, and
    ``compose_lane_peer_specs``, equal the specs derived from the
    staged ``WorldState``'s fields (a leaf with a leading lane axis is
    lane-sharded, an (N, N) table is also row-sharded on ``peers``, the
    clock is replicated) and from the ``Schedule`` (replicated whole).
``no-transfer-in-scan``
    A solo run's tick loop makes no host-device sync and no pageable
    copy: it runs under ``torch.cuda.set_sync_debug_mode("error")``.
    The mode does nothing on the CPU, so the rule is checked only on a
    card; on the CPU :func:`check` leaves it out (``unchecked_rules``).
``donation-taken``
    Nothing to check: the port updates state tensors in place and never
    copies a carry a JAX program would donate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from . import Finding

class SyncInLoop(RuntimeError):
    """A guarded tick loop synchronized the host with the card."""


@dataclass
class Observation:
    """What one registered run did."""

    ticks: int                     # ticks each shard ran
    #: draw calls the routing owes, ``{"drop_masks": n,
    #: "drop_masks_lanes": n}`` (one a fleet shard-tick, one a K2 stack)
    expected_draws: dict
    draws: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)   # {(axis, kind): n}
    maps: list = field(default_factory=list)          # mesh.MapRecord
    #: the 2-D program's derived ``(state spec, schedule spec)``
    derived_specs: Optional[tuple] = None
    composed_state_spec: object = None
    sync_error: Optional[str] = None
    #: the 2-D program: each tick's ``{(axis, kind): n}`` on the mesh's
    #: origin shard, and what its comm owes a shard-tick on ``peers``
    tick_collectives: Optional[list] = None
    owed_peer_collectives: Optional[dict] = None


@dataclass
class Program:
    """A registered run: ``run(device, section) -> Observation``.  The run
    does its set-up and warm-up outside and wraps the run it is judged
    on in ``section(sync=...)``: the counters are zeroed at its entry and
    read at its exit, and with ``sync=True`` on a card it runs under the
    sync-debug mode "error"."""

    name: str
    provenance: str
    rules: tuple
    run: Callable
    notes: str = ""


def _provenance(fn) -> str:
    try:
        f = inspect.unwrap(fn)
        path = inspect.getsourcefile(f)
        _, line = inspect.getsourcelines(f)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return f"{os.path.relpath(path, root)}:{line}"
    except (TypeError, OSError):
        return repr(fn)


# ------------------------------------------------------------ the configs

def dense_cfg():
    """The JAX registry's dense config: N=16, 30 ticks, 10% drop."""
    from ..config import SimConfig
    return SimConfig(max_nnb=16, total_ticks=30, drop_msg=True,
                     msg_drop_prob=0.1, single_failure=True)


def overlay_cfg():
    """The JAX registry's overlay config: N=64, 96 ticks, 20% churn."""
    from ..config import SimConfig
    return SimConfig(model="overlay", max_nnb=64, total_ticks=96,
                     churn_rate=0.2, rejoin_after=None, seed=1,
                     step_rate=4.0 / 64)


def _draws(per_tick_lanes: int = 0, stacks: int = 0) -> dict:
    return {"drop_masks": stacks, "drop_masks_lanes": per_tick_lanes}


# ------------------------------------------------------------ the programs

def _solo_dense_trace(device, section) -> Observation:
    from ..core.dense_mega import dense_mega_supported
    from ..core.tick import make_run
    from ..ops.cuda.dense_mega import dense_mega_ticks_for
    from ..state import init_state, make_schedule
    cfg = dense_cfg()
    run = make_run(cfg, with_events=True)
    sched = make_schedule(cfg, device)
    run(init_state(cfg, device), sched)               # warm: kernel builds
    state = init_state(cfg, device)
    _sync(device)
    with section(sync=True):
        run(state, sched)
    t = cfg.total_ticks
    if dense_mega_supported(cfg, True):
        s = dense_mega_ticks_for(cfg.n)
        expect = _draws(stacks=-(-t // s))
    else:
        expect = _draws(stacks=t)
    return Observation(ticks=t, expected_draws=expect)


def _solo_overlay(device, section) -> Observation:
    from ..models.overlay import (init_overlay_state, make_overlay_run,
                                  make_overlay_schedule)
    cfg = overlay_cfg()
    run = make_overlay_run(cfg)
    sched = make_overlay_schedule(cfg)
    run(init_overlay_state(cfg, device), sched)
    state = init_overlay_state(cfg, device)
    _sync(device)
    with section(sync=True):
        run(state, sched)
    return Observation(ticks=cfg.total_ticks, expected_draws=_draws())


def composed_dense_cfg():
    """The JAX registry's composed dense config: byz + latency + flap +
    partition on the drop config (the composable route)."""
    return dense_cfg().replace(
        byz_rate=0.2, byz_boost=8, link_latency=3, flap_rate=0.3,
        flap_period=12, flap_down=4, partition_groups=2,
        partition_open_tick=8, partition_close_tick=16)


def composed_overlay_cfg():
    """The JAX registry's composed overlay config (byz + latency over the
    churn script), with the partition world too, whose sends read the
    next tick's partners (the worlds' per-tick route)."""
    return overlay_cfg().replace(
        byz_rate=0.15, byz_boost=8, link_latency=3, partition_groups=2,
        partition_open_tick=8, partition_close_tick=40)


def _solo_dense_composed(device, section) -> Observation:
    from ..core.tick import make_run
    from ..state import init_state, make_schedule
    cfg = composed_dense_cfg()
    run = make_run(cfg, with_events=True)
    sched = make_schedule(cfg, device)
    run(init_state(cfg, device), sched)
    state = init_state(cfg, device)
    _sync(device)
    with section(sync=True):
        run(state, sched)
    return Observation(ticks=cfg.total_ticks,
                       expected_draws=_draws(stacks=cfg.total_ticks))


def _solo_overlay_composed(device, section) -> Observation:
    from ..models.overlay import (init_overlay_state, make_overlay_run,
                                  make_overlay_schedule)
    cfg = composed_overlay_cfg()
    run = make_overlay_run(cfg)
    sched = make_overlay_schedule(cfg)
    run(init_overlay_state(cfg, device), sched)
    state = init_overlay_state(cfg, device)
    _sync(device)
    with section(sync=True):
        run(state, sched)
    return Observation(ticks=cfg.total_ticks, expected_draws=_draws())


def _fleet_dense_bench(device, section) -> Observation:
    from ..core.fleet import FleetSimulation
    cfg = dense_cfg()
    with section():
        FleetSimulation(cfg, device=device).run_bench(seeds=[1, 2],
                                                      warmup=False)
    return Observation(ticks=cfg.total_ticks,
                       expected_draws=_draws(cfg.total_ticks))


def _fleet_overlay(device, section) -> Observation:
    from ..core.fleet import FleetSimulation
    cfg = overlay_cfg()
    with section():
        FleetSimulation(cfg, device=device).run(seeds=[1, 2], warmup=False)
    return Observation(ticks=cfg.total_ticks, expected_draws=_draws())


def _fleet_dense_leg(device, section) -> Observation:
    """A dense trace fleet cut at its first segment cut and resumed from
    its checkpoints: the resumed leg draws once a tick like the first."""
    from ..core.fleet import FleetSimulation
    from ..models.segments import checkpoint_ticks
    cfg = dense_cfg()
    sim = FleetSimulation(cfg, device=device)
    with section():
        leg = sim.run_leg(seeds=[1, 2], ticks=checkpoint_ticks(cfg)[0])
        sim.run_leg(resume=leg.checkpoints)
    return Observation(ticks=cfg.total_ticks,
                       expected_draws=_draws(cfg.total_ticks))


def _mesh_dense_bench_d2(device, section) -> Observation:
    from ..parallel.fleet_mesh import MeshFleetSimulation, make_lane_mesh
    cfg = dense_cfg()
    sim = MeshFleetSimulation(cfg, make_lane_mesh(2, device=device))
    with section():
        sim.run_bench(seeds=[1, 2, 3, 4], warmup=False)
    return Observation(ticks=cfg.total_ticks,
                       expected_draws=_draws(2 * cfg.total_ticks))


def derive_lane_peer_specs(states, n: int):
    """The 2-D specs derived from a staged fleet state's fields: a leaf
    with a leading lane axis is lane-sharded, one whose trailing axes are
    (N, N) is also row-sharded on ``peers``, a scalar (the clock) is
    replicated; the schedule is replicated whole."""
    from ..parallel.fleet_mesh import LANE_AXIS
    from ..parallel.mesh import P
    from ..parallel.sharded import PEER_AXIS
    b = states.known.shape[0]
    kw = {}
    for f in dataclasses.fields(type(states)):
        v = getattr(states, f.name)
        shape = tuple(getattr(v, "shape", ()))
        if not shape or shape[0] != b:
            kw[f.name] = P()
        elif shape[-2:] == (n, n):
            kw[f.name] = P(LANE_AXIS, PEER_AXIS, *([None] * (len(shape) - 2)))
        else:
            kw[f.name] = P(LANE_AXIS)
    return type(states)(**kw), P()


#: the registered 2-D mesh, lanes x peers: the JAX registry's 2 x 4
MESH2D = (2, 4)


@contextlib.contextmanager
def _tick_collectives(per_tick: list):
    """Append each tick's collectives on the mesh's origin shard
    (``{(axis, kind): n}``) to ``per_tick``: the fleet tick is wrapped to
    read the collective counter at its entry and exit, and the block
    gets an empty fleet program cache so that the program is built with
    the wrapped tick (and leaves no wrapped program behind)."""
    from ..core import fleet
    from ..parallel import fleet_mesh
    from ..parallel import mesh as pmesh
    make, cache = fleet_mesh.make_fleet_tick, fleet._FLEET_FN_CACHE

    def counted_make(*a, **k):
        tick = make(*a, **k)

        def counted(*args, **kw):
            if any(pmesh.ctx().coords):
                return tick(*args, **kw)
            c0 = pmesh.collective_counts()
            out = tick(*args, **kw)
            c1 = pmesh.collective_counts()
            per_tick.append({key: n - c0.get(key, 0)
                             for key, n in c1.items() if n != c0.get(key, 0)})
            return out
        return counted

    fleet_mesh.make_fleet_tick, fleet._FLEET_FN_CACHE = counted_make, {}
    try:
        yield
    finally:
        fleet_mesh.make_fleet_tick, fleet._FLEET_FN_CACHE = make, cache


def _mesh2d_lanes_peers(device, section) -> Observation:
    from ..parallel.fleet_mesh import (MeshFleetSimulation, _lane_specs,
                                       compose_lane_peer_specs,
                                       lane_peer_tick_collectives,
                                       make_lane_peer_mesh)
    from ..parallel.sharded import peer_spec_trees
    from ..state import WorldState
    cfg = dense_cfg()
    lanes, peers = MESH2D
    seeds = list(range(1, 2 * lanes + 1))
    sim = MeshFleetSimulation(cfg, make_lane_peer_mesh(lanes, peers,
                                                       device=device))
    per_tick: list = []
    with _tick_collectives(per_tick), section():
        sim.run_bench(seeds=seeds, warmup=False)
    states = sim._init_stacked([cfg.replace(seed=s) for s in seeds], cfg.n)
    return Observation(
        ticks=cfg.total_ticks,
        expected_draws=_draws(lanes * peers * cfg.total_ticks),
        derived_specs=derive_lane_peer_specs(states, cfg.n),
        composed_state_spec=compose_lane_peer_specs(
            _lane_specs(WorldState), peer_spec_trees()[0]),
        tick_collectives=per_tick,
        owed_peer_collectives=lane_peer_tick_collectives(peers))


def build_programs() -> list[Program]:
    """The registry: the JAX registry's programs at its configs."""
    from ..core.fleet import FleetSimulation
    from ..core.tick import make_run
    from ..models.overlay import make_overlay_run
    from ..parallel.fleet_mesh import MeshFleetSimulation
    solo = ("cond-stays-cond", "zero-collectives-per-tick",
            "no-transfer-in-scan")
    fleet = ("cond-stays-cond", "zero-collectives-per-tick")
    return [
        Program("solo-dense-trace", _provenance(make_run), solo,
                _solo_dense_trace, "N=16, 30 ticks, 10% drop, K2 route"),
        Program("solo-overlay", _provenance(make_overlay_run), solo,
                _solo_overlay, "N=64, 96 ticks, 20% churn, K4 route"),
        Program("solo-dense-composed", _provenance(make_run), solo,
                _solo_dense_composed,
                "byz + latency + flap + partition on the drop config, the "
                "composable route"),
        Program("solo-overlay-composed", _provenance(make_overlay_run), solo,
                _solo_overlay_composed,
                "byz + latency + partition over the churn script, the "
                "worlds' per-tick route"),
        Program("fleet-dense-bench",
                _provenance(FleetSimulation.run_bench), fleet,
                _fleet_dense_bench, "B=2, the K1 route's lane axis"),
        Program("fleet-overlay", _provenance(FleetSimulation.run), fleet,
                _fleet_overlay, "B=2, K5's lane axis"),
        Program("fleet-dense-leg", _provenance(FleetSimulation.run_leg),
                fleet, _fleet_dense_leg,
                "B=2 trace, cut at its first segment cut and resumed"),
        Program("mesh-dense-bench-d2",
                _provenance(MeshFleetSimulation.run_bench),
                fleet + ("lanes-axis-zero-collectives",
                         "replicated-plane-stays-replicated"),
                _mesh_dense_bench_d2, "B=4 on a 2-entry lane mesh"),
        Program("mesh2d-lanes-peers",
                _provenance(MeshFleetSimulation.run_bench),
                ("cond-stays-cond", "lanes-axis-zero-collectives",
                 "peers-axis-collective-budget",
                 "replicated-plane-stays-replicated",
                 "spec-derivation-consistent"),
                _mesh2d_lanes_peers,
                "B=4 on a 2x4 lanes x peers mesh, the RingComm tick"),
    ]


# ------------------------------------------------------------ observing

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def observe(prog: Program, device=None) -> Observation:
    """Run one program on ``device`` (the card unless the caller asks
    for ``cpu``); its judged section's counts go into the
    :class:`Observation` it returns."""
    from ..ops.drop import drop_masks, drop_masks_lanes
    from ..parallel import mesh as pmesh
    from ..state import resolve_device
    device = resolve_device(device)
    seen: dict = {}
    card = device.type == "cuda"

    @contextlib.contextmanager
    def section(sync: bool = False):
        pmesh.reset_collective_counts()
        d0 = (drop_masks.calls, drop_masks_lanes.calls)
        with pmesh.observe_maps() as maps:
            if sync and card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            except RuntimeError as e:
                if not (sync and card):
                    raise
                seen["sync"] = str(e).splitlines()[0]
                raise SyncInLoop(seen["sync"]) from e
            finally:
                if sync and card:
                    torch.cuda.set_sync_debug_mode(0)
        seen.update(
            draws={"drop_masks": drop_masks.calls - d0[0],
                   "drop_masks_lanes": drop_masks_lanes.calls - d0[1]},
            collectives=pmesh.collective_counts(), maps=list(maps))

    try:
        obs = prog.run(device, section)
    except SyncInLoop:
        return Observation(ticks=0, expected_draws={},
                           sync_error=seen["sync"])
    if "draws" not in seen:
        raise RuntimeError(f"{prog.name} ran no judged section")
    obs.draws, obs.collectives, obs.maps = \
        seen["draws"], seen["collectives"], seen["maps"]
    return obs


# ------------------------------------------------------------ the rules

def check_observation(prog: Program, obs: Observation,
                      rules=None) -> list[Finding]:
    """Every rule of ``prog`` (restricted to ``rules``) over ``obs``."""
    from ..parallel.fleet_mesh import (LANE_AXIS,
                                       LANE_PEER_TICK_COLLECTIVE_BUDGET)
    from ..parallel.sharded import PEER_AXIS
    out = []

    def want(r):
        return r in prog.rules and (rules is None or r in rules)

    def find(rule, detail):
        out.append(Finding(rule, prog.name, detail, path=prog.provenance))

    if obs.sync_error is not None:
        if want("no-transfer-in-scan"):
            find("no-transfer-in-scan",
                 f"the tick loop synchronized with the card under "
                 f"set_sync_debug_mode('error'): {obs.sync_error}")
        return out
    if want("cond-stays-cond") and obs.draws != obs.expected_draws:
        find("cond-stays-cond",
             f"draw calls {obs.draws}, the routing owes "
             f"{obs.expected_draws} (one a fleet shard-tick for all its "
             "lanes, one a K2 stack) — the shared draw runs a lane or a "
             "tick at a time")
    total = sum(obs.collectives.values())
    if want("zero-collectives-per-tick") and total:
        find("zero-collectives-per-tick",
             f"{total} collective(s) {sorted(obs.collectives.items())} in a "
             "program that must move nothing between shards")
    lanes = {k: v for k, v in obs.collectives.items() if k[0] == LANE_AXIS}
    if want("lanes-axis-zero-collectives") and lanes:
        find("lanes-axis-zero-collectives",
             f"collective(s) on the {LANE_AXIS!r} axis: "
             f"{sorted(lanes.items())} — lanes are independent runs")
    if want("peers-axis-collective-budget"):
        out += _check_peer_ticks(prog, obs, LANE_PEER_TICK_COLLECTIVE_BUDGET,
                                 PEER_AXIS)
    if want("replicated-plane-stays-replicated"):
        if not obs.maps:
            find("replicated-plane-stays-replicated",
                 "the program ran no shard_map: nothing was checked")
        for rec in obs.maps:
            if rec.unequal_replicated:
                find("replicated-plane-stays-replicated",
                     f"{rec.body}: P() output leaves "
                     f"{rec.unequal_replicated} differ between shards — "
                     "the stitch keeps the first shard's")
    if want("spec-derivation-consistent"):
        out += _check_specs(prog, obs)
    return out


def _check_peer_ticks(prog: Program, obs: Observation, budget: int,
                      axis: str) -> list[Finding]:
    """Every tick's collectives on ``axis`` equal what the comm owes a
    shard-tick, and that is within ``budget``."""
    def find(detail):
        return Finding("peers-axis-collective-budget", prog.name, detail,
                       path=prog.provenance)
    owed, ticks = obs.owed_peer_collectives, obs.tick_collectives
    if owed is None or ticks is None:
        return [find("the program recorded no per-tick collectives")]
    out = []
    if sum(owed.values()) > budget:
        out.append(find(f"the comm owes {owed} a shard-tick on {axis!r}, "
                        f"over the budget of {budget}"))
    if len(ticks) != obs.ticks:
        out.append(find(f"{len(ticks)} ticks observed on the origin shard, "
                        f"the run has {obs.ticks}"))
    got = [{k: n for (ax, k), n in t.items() if ax == axis} for t in ticks]
    bad = [i for i, g in enumerate(got) if g != owed]
    if bad:
        i = bad[0]
        out.append(find(
            f"{len(bad)} of {len(ticks)} ticks issue other collectives on "
            f"{axis!r} than the {sum(owed.values())} the comm owes {owed}: "
            f"tick {i} issued {sum(got[i].values())} {got[i]}"))
    return out


def _check_specs(prog: Program, obs: Observation) -> list[Finding]:
    out = []
    if obs.derived_specs is None or not obs.maps:
        return [Finding("spec-derivation-consistent", prog.name,
                        "no derived specs or shard_map to compare",
                        path=prog.provenance)]
    want_state, want_sched = obs.derived_specs
    cands = [("compose_lane_peer_specs", obs.composed_state_spec)] + [
        (f"shard_map in_specs of {rec.body}", rec.in_specs[0])
        for rec in obs.maps]
    for what, got in cands:
        for f in dataclasses.fields(type(want_state)):
            a, b = getattr(got, f.name, None), getattr(want_state, f.name)
            if tuple(a or ()) != tuple(b):
                out.append(Finding(
                    "spec-derivation-consistent", prog.name,
                    f"{what}: state leaf {f.name!r} has spec {a}, the "
                    f"fields derive {b}", path=prog.provenance))
    for rec in obs.maps:
        if tuple(rec.in_specs[1]) != tuple(want_sched):
            out.append(Finding(
                "spec-derivation-consistent", prog.name,
                f"shard_map in_specs of {rec.body}: the staged schedule "
                f"has spec {rec.in_specs[1]}, the fields derive "
                f"{want_sched}", path=prog.provenance))
    return out


def check(rules=None, device=None, programs=None) -> list[Finding]:
    """Run the registry (or ``programs``) on ``device`` (the card unless
    the caller asks for ``cpu``) and check every rule the device can
    check: ``donation-taken`` has nothing to check, and on the CPU
    ``no-transfer-in-scan`` is left out (``unchecked_rules``)."""
    from . import RULES, unchecked_rules
    from ..state import resolve_device
    device = resolve_device(device)
    skip = set(unchecked_rules(device))
    rules = {r.name for r in RULES if rules is None or r.name in rules} \
        - skip
    progs = build_programs() if programs is None else programs
    out = []
    for prog in progs:
        if not set(prog.rules) & rules:
            continue
        out += check_observation(prog, observe(prog, device), rules)
    check.last_programs = progs
    return out


check.last_programs = []

"""Bounded partial-view overlay (port of ``gossip_protocol_tpu/models/overlay.py``).

The overlay is the scale family: O(N·K) view tables, O(N·F·K) work a
tick, up to N = 2^20 peers.  Its protocol and its bits are the JAX
package's (read that module's docstring for the design): per tick every
in-group node exchanges its whole K-slot view plus a self-entry with
the F partners ``i ^ m_f(t)``; tables share one epoch-slotted map, so a
merge is a lane-aligned lexicographic (key, payload) max; staleness
detection is the reference's TREMOVE rule; every draw is a ``mix32``
counter hash of (seed, id, tick).

The per-tick rules (entry packing, slot map, merge, schedule, re-slot,
the tick ``overlay_step``) live in
``ops/overlay_rules.py``, shared with the kernels' plain versions; this
module builds the schedule and routes the run.

What differs here, none of it in the bits:

* ``OverlayState`` is a dataclass of tensors with the clock as a host
  int; the schedule is host scalars.  Everything a tick decides from
  the clock alone (the XOR masks, the drop window, the slot epoch) is
  host arithmetic, so a run never waits on the card to learn it.
* ``x[i ^ m]`` is a plain index: the permutation matmuls of the JAX
  tick existed only to avoid TPU gathers, and ``LocalOverlayComm`` goes:
  :func:`make_overlay_tick` takes ``comm=None`` for one device, or a
  ``RingOverlayComm`` (models/overlay_sharded.py) for one shard of a
  peer-sharded run.
* The (N, K) phase of every tick is K3 (``ops/cuda/overlay_exchange.py``
  ``fused_overlay_tick``): the CUDA kernel for CUDA tensors, its plain
  PyTorch version for CPU tensors.  The plain version IS the port's form
  of the JAX package's XLA phases, so there is one tick, not two.
* Routing (:func:`make_overlay_run`), the same on either device: K4
  (``models/overlay_mega.py``, 16 ticks a call) where
  :func:`~.overlay_mega.mega_supported` holds (N <= 4096); else K5
  (``models/overlay_grid.py``, 16 ticks a call with the schedule's dead
  phases elided per launch) where :func:`~.overlay_grid.grid_supported`
  holds (power-of-two N up to 2^20, 8 to 64 view slots, F <= 8); else the
  per-tick tick with K3.  As in the JAX package, whose own tests hold
  the grid, mega and per-tick paths bit-identical to its XLA tick, the
  route changes no bit.

World configs (worlds.py) route as the JAX package routes them
(``models/overlay.py:661-662``): never through K3, K4 or K5, but a tick
at a time through ``ops/overlay_rules.py overlay_world_exchange``, the
counterpart of the JAX XLA tick, on either device.  The choice is the
config's.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import INTRODUCER, SimConfig
from ..core.sim import _sync
from ..ops.cuda.overlay_exchange import fused_overlay_tick
from ..ops.overlay_rules import (_SALT_DEGREE, ID_BITS, METRIC_FIELDS,
                                 OverlaySchedule, OverlayState, RowColumns,
                                 WorldFlags, exchange_mask, overlay_step)
from ..state import NEVER, resolve_device
from ..utils.hash32 import MASK32, mix32_t, threshold32

#: track the live-coverage histogram per tick only up to this N
COVERAGE_N_LIMIT = 4096

# ------------------------------------------------------- schedule

def make_overlay_schedule(cfg: SimConfig) -> OverlaySchedule:
    """The JAX ``make_overlay_schedule``: host scalars, the worlds'
    resolved windows included."""
    from .. import worlds
    from ..utils.prng import fail_schedule_uniform
    from .segments import step_fraction
    n = cfg.n
    step_num, step_den = step_fraction(cfg.step_rate)
    if cfg.churn_rate > 0:
        # the churn window must not overlap the start ramp (a churned
        # peer failing before its start would be introduced while failed)
        last_start = (n - 1) * step_num // step_den
        churn_lo = cfg.total_ticks // 4
        if last_start >= churn_lo:
            raise ValueError(
                f"start ramp ends at t={last_start} but churn opens at "
                f"t={churn_lo}; lower step_rate (e.g. {churn_lo / (2 * n)}) "
                "or lengthen the run")
    victim_lo, victim_hi = 0, 0
    if cfg.churn_rate <= 0:
        u = fail_schedule_uniform(cfg.seed)
        if cfg.single_failure:
            victim_lo = int(u * n) % n
            victim_hi = victim_lo + 1
        else:
            victim_lo = (int(u * n) % n) // 2
            victim_hi = victim_lo + n // 2
    part_open, part_close = worlds.partition_window(cfg)
    flap_lo, flap_hi = worlds.flap_window(cfg)
    return OverlaySchedule(
        seed=cfg.seed & MASK32, step_num=step_num, step_den=step_den,
        victim_lo=victim_lo, victim_hi=victim_hi, fail_tick=cfg.fail_tick,
        rejoin_after=(cfg.rejoin_after if cfg.rejoin_after is not None
                      else int(NEVER)),
        churn_thr=threshold32(cfg.churn_rate) if cfg.churn_rate > 0 else 0,
        churn_lo=cfg.total_ticks // 4,
        churn_span=max(cfg.total_ticks // 2, 1),
        churn_after=(cfg.rejoin_after if cfg.rejoin_after is not None
                     else 40),
        drop_on=bool(cfg.drop_msg), drop_open=cfg.drop_open_tick,
        drop_close=cfg.drop_close_tick,
        drop_thr=threshold32(cfg.msg_drop_prob),
        deg_thr=tuple(int(x) for x in
                      degree_thresholds(cfg, resolved_dims(cfg)[1])),
        part_groups=cfg.partition_groups if cfg.partition_groups >= 2
        else 0,
        part_open=part_open, part_close=part_close,
        asym_on=bool(cfg.asym_drop), wave_size=cfg.wave_size,
        wave_tick=worlds.wave_start(cfg) if cfg.wave_size > 0 else 0,
        wave_speed=max(cfg.wave_speed, 1),
        wave_center=worlds.wave_center(cfg) if cfg.wave_size > 0 else 0,
        wave_mod=n, zombie_on=bool(cfg.zombie),
        flap_thr=worlds.flap_threshold(cfg),
        flap_period=max(cfg.flap_period, 1), flap_down=cfg.flap_down,
        flap_open=flap_lo, flap_close=flap_hi if cfg.flap_rate > 0 else -1,
        byz_thr=worlds.byz_threshold(cfg), byz_boost=cfg.byz_boost,
        link_lat=cfg.link_latency)


@dataclass
class OverlayMetrics:
    """Per-tick counters, each [T] (tensors or numpy arrays)."""

    in_group: object
    view_slots: object
    adds: object
    removals: object
    false_removals: object
    victim_slots: object
    live_uncovered: object      # -1 where not tracked
    sent: object
    recv: object

    @classmethod
    def from_rows(cls, rows) -> "OverlayMetrics":
        """From (T, 9) rows in :data:`METRIC_FIELDS` order."""
        return cls(**{f: rows[:, j] for j, f in enumerate(METRIC_FIELDS)})

    def to_numpy(self) -> "OverlayMetrics":
        return OverlayMetrics(**{
            f: np.asarray(getattr(self, f).cpu() if torch.is_tensor(
                getattr(self, f)) else getattr(self, f))
            for f in METRIC_FIELDS})


def resolved_dims(cfg: SimConfig):
    """(K, F): view slots (auto ~4·log2 N, 16..64) and exchange fanout
    (auto 3, or 8 for the power-law hub cap)."""
    b = int(math.ceil(math.log2(max(cfg.n, 4))))
    k = cfg.overlay_view if cfg.overlay_view > 0 \
        else min(64, max(16, 8 * ((b + 1) // 2)))
    if cfg.fanout > 0:
        f = cfg.fanout
    elif cfg.topology == "powerlaw":
        f = 8
    else:
        f = 3
    return k, f


def degree_thresholds(cfg: SimConfig, f: int) -> np.ndarray:
    """uint32 CDF thresholds of the bounded Pareto out-degree draw:
    ``deg(i) = 1 + sum_k [mix32(seed, i, SALT_DEGREE) < thr_k]``."""
    if cfg.topology == "uniform":
        return np.full(max(f - 1, 1), 0xFFFFFFFF, np.uint32)
    if cfg.topology != "powerlaw":
        raise ValueError(f"unknown overlay topology {cfg.topology!r}")
    a = float(cfg.powerlaw_alpha)
    if a <= 1.0:
        raise ValueError("powerlaw_alpha must be > 1")
    thr = [min(0xFFFFFFFF, int(round(4294967296.0 * k ** (-(a - 1.0)))))
           for k in range(2, f + 1)]
    return np.asarray(thr if thr else [0], np.uint32)


def degree_of(sched: OverlaySchedule, rows: torch.Tensor) -> torch.Tensor:
    """i32 out-degree of each row (F for every row of a uniform graph,
    up to the rare hash equal to 0xFFFFFFFF).  The thresholds are host
    ints compared one at a time, so no table is copied to the card (a
    pageable copy synchronizes the host with it)."""
    du = mix32_t(sched.seed, rows.to(torch.int64) & MASK32, _SALT_DEGREE)
    deg = torch.ones_like(du, dtype=torch.int32)
    for thr in sched.deg_thr:
        deg = deg + (du < int(thr)).to(torch.int32)
    return deg


def init_overlay_state(cfg: SimConfig, device=None) -> OverlayState:
    dev = resolve_device(device)
    n = cfg.n
    k, f = resolved_dims(cfg)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return OverlayState(
        tick=0, ids=torch.full((n, k), -1, dtype=torch.int32, device=dev),
        hb=z(n, k), ts=z(n, k), in_group=z(n, dtype=torch.bool),
        own_hb=z(n), send_flags=z(n, f, dtype=torch.bool),
        send_hist=z(n, f), joinreq=z(n, dtype=torch.bool),
        joinrep=z(n, dtype=torch.bool))


# ---------------------------------------------------------------- columns

def schedule_columns(sched: OverlaySchedule, n: int, device) -> RowColumns:
    rows = torch.arange(n, dtype=torch.int64, device=device)
    return RowColumns(rows=rows, is_intro=rows == INTRODUCER,
                      start=sched.start_of(rows), fail=sched.fail_of(rows),
                      rejoin=sched.rejoin_of(rows),
                      deg=degree_of(sched, rows))


# ------------------------------------------------------------------- tick

def tick_flags(cfg: SimConfig) -> dict:
    """The config's static switches of the tick: whether peers rejoin
    (churn, ``rejoin_after`` or the flap world's up-edges) and whether
    out-degrees are power-law."""
    return dict(can_rejoin=cfg.churn_rate > 0 or cfg.rejoin_after is not None
                or cfg.flap_rate > 0,
                powerlaw=cfg.topology == "powerlaw")


def world_flags(cfg: SimConfig) -> WorldFlags | None:
    """The adversarial worlds a config turns on, or None (the course
    worlds): the tick's static branches (JAX ``make_overlay_tick``)."""
    if not cfg.has_worlds:
        return None
    return WorldFlags(part=cfg.partition_groups >= 2, asym=cfg.asym_drop,
                      zombie=cfg.zombie, flap=cfg.flap_rate > 0,
                      byz=cfg.byz_rate > 0, latency=cfg.link_latency)


def make_overlay_tick(cfg: SimConfig, exchange=fused_overlay_tick,
                      with_coverage: bool | None = None, comm=None):
    """Build ``tick(state, sched, cols=None) -> (state', metrics i32[9])``.

    ``exchange`` is K3 (the kernel for CUDA tensors, its plain version
    for CPU tensors); passing ``fused_overlay_tick_plain`` runs the plain
    version on any device (the kernel's yardstick), and any function of
    K3's contract may stand in to capture or compare its inputs.  A
    world config never calls ``exchange``: its (N, K) phase is
    ``overlay_world_exchange`` (the JAX package's XLA tick).  The
    per-tick ``live_uncovered`` histogram is tracked for N <=
    COVERAGE_N_LIMIT, else reported as -1; ``with_coverage`` overrides
    (the fleet passes False, as the JAX fleet does).  ``comm`` makes the
    tick one shard of a peer-sharded run (``ops/overlay_rules.py
    overlay_step``): the state's tables hold the shard's rows, and K3
    takes its sharded contract (a world config's exchange takes the
    comm itself).
    """
    n = cfg.n
    k, f = resolved_dims(cfg)
    if n & (n - 1) or n > 1 << ID_BITS:
        raise ValueError("overlay peer count must be a power of two "
                         f"<= {1 << ID_BITS}")
    if cfg.total_ticks > 4094:
        raise ValueError("the packed (ts, hb) winner payload caps runs at "
                         "4094 ticks")
    worlds = world_flags(cfg)
    if worlds is not None and exchange is not fused_overlay_tick:
        raise ValueError("a world config runs the worlds' exchange, not K3 "
                         "or a stand-in for it")
    kw = dict(k=k, f=f, t_remove=cfg.t_remove, exchange=exchange,
              with_coverage=(n <= COVERAGE_N_LIMIT if with_coverage is None
                             else with_coverage), worlds=worlds, comm=comm,
              **tick_flags(cfg))
    intro_cache = {}

    def tick(state: OverlayState, sched: OverlaySchedule,
             cols: RowColumns | None = None):
        if cols is None:
            cols = schedule_columns(sched, n, state.device)
        if sched not in intro_cache:
            i0 = torch.zeros(1, dtype=torch.int64)
            intro_cache[sched] = (int(sched.fail_of(i0)[0]),
                                  int(sched.rejoin_of(i0)[0]))
        fail0, rejoin0 = intro_cache[sched]
        masks = [exchange_mask(sched.seed, state.tick - 1, fi, n)
                 for fi in range(f)]
        return overlay_step(state, sched, cols, masks, fail0=fail0,
                            rejoin0=rejoin0, **kw)

    return tick


def make_overlay_run(cfg: SimConfig, length: int | None = None, *,
                     mega: bool | None = None, grid: bool | None = None,
                     start_tick: int | None = None,
                     exchange=fused_overlay_tick):
    """``run(state, sched) -> (final, OverlayMetrics[length])`` with the
    metrics as tensors on the run's device.

    Routing: K4 (16 ticks a call, ``models/overlay_mega.py``) where
    ``mega_supported(cfg)`` holds; else K5 (16 ticks a call,
    ``models/overlay_grid.py``) where ``grid_supported(cfg)`` holds;
    else the per-tick tick with K3.  ``mega`` and ``grid`` override.
    World configs fall outside both envelopes and run the per-tick tick
    with the worlds' exchange.
    On CUDA tensors the kernels run, on CPU tensors their plain
    versions.  K4 and K5 report ``live_uncovered`` = -1.  The schedule
    is closed-form in the clock carried in the state, so a shorter run
    resumes mid-run bit-identically.  ``start_tick`` pins the K5 route's
    start tick, which segments its plan (``models/segments.py``); that
    run then refuses a state at another clock.  ``exchange`` replaces K3
    on the per-tick route only (``mega=False, grid=False``;
    :func:`make_overlay_tick`).
    """
    from .overlay_grid import grid_supported, make_grid_run
    from .overlay_mega import make_mega_run, mega_supported
    length = cfg.total_ticks if length is None else length
    if mega is None:
        mega = mega_supported(cfg)
    if grid is None:
        grid = not mega and grid_supported(cfg)
    if (mega or grid) and cfg.has_worlds:
        raise ValueError("world configs run the per-tick worlds' tick, "
                         "not K4 or K5")
    if (mega or grid) and exchange is not fused_overlay_tick:
        raise ValueError("exchange replaces K3 on the per-tick route only; "
                         "pass mega=False, grid=False")
    if mega:
        return make_mega_run(cfg, length)
    if grid:
        return make_grid_run(cfg, length, start_tick=start_tick)
    tick = make_overlay_tick(cfg, exchange)

    def run(state: OverlayState, sched: OverlaySchedule):
        cols = schedule_columns(sched, cfg.n, state.device)
        rows = []
        for _ in range(length):
            state, m = tick(state, sched, cols)
            rows.append(m)
        met = torch.stack(rows) if rows else torch.zeros(
            (0, len(METRIC_FIELDS)), dtype=torch.int32, device=state.device)
        return state, OverlayMetrics.from_rows(met)

    return run


# ------------------------------------------------------------------ fleet

#: fleet run closures by (seed-stripped config, batch, length, route,
#: start tick); misses count on core/tick.py run_build_count
_OVERLAY_FLEET_CACHE: dict = {}


def make_overlay_fleet_run(cfg: SimConfig, batch: int,
                           length: int | None = None, start_tick: int = 0):
    """``run(states, scheds) -> (finals, OverlayMetrics[batch, length])``
    over ``batch`` lanes of one config shape at one shared clock:
    ``states`` a stacked :class:`OverlayState` (``models/overlay_grid.py
    stack_states``), ``scheds`` the B lane schedules.

    Routing (core/fleet.py is the orchestrator), the same on ``cuda``
    and ``cpu``:

    * where :func:`~.overlay_grid.grid_supported` holds, K5's leading
      lane axis (:func:`~.overlay_grid.make_grid_fleet_run`): one K5
      call a launch for the whole fleet, the plan segmented from
      ``start_tick``;
    * elsewhere (the worlds, K > 64 or F > 8) each lane runs the
      per-tick route (K3, or the worlds' exchange) in turn, with the
      per-tick ``live_uncovered`` off (-1), as the JAX fleet's vmapped
      XLA tick reports it.

    Each lane equals :func:`make_overlay_run` of its schedule bit for
    bit, ``live_uncovered`` aside.
    """
    from ..core.tick import note_build
    from .overlay_grid import grid_supported
    length = cfg.total_ticks if length is None else length
    grid = grid_supported(cfg)
    key = (cfg.replace(seed=0), batch, length, grid,
           start_tick if grid else 0)
    if key in _OVERLAY_FLEET_CACHE:
        return _OVERLAY_FLEET_CACHE[key]
    note_build()
    run = build_overlay_fleet_run(cfg, batch, length, start_tick)
    _OVERLAY_FLEET_CACHE[key] = run
    return run


def build_overlay_fleet_run(cfg: SimConfig, batch: int, length: int,
                            start_tick: int = 0):
    """The uncached closure behind :func:`make_overlay_fleet_run` (a
    mesh fleet's lane shards build theirs inside its own cached, counted
    program, parallel/fleet_mesh.py)."""
    from .overlay_grid import (grid_supported, lane_state,
                               make_grid_fleet_run, stack_states)
    if grid_supported(cfg):
        return make_grid_fleet_run(cfg, length, batch, start_tick=start_tick)
    tick = make_overlay_tick(cfg, with_coverage=False)

    def run(states: OverlayState, scheds):
        if len(scheds) != batch or states.ids.shape[0] != batch:
            raise ValueError(f"expected {batch} lanes, got "
                             f"{states.ids.shape[0]} states and "
                             f"{len(scheds)} schedules")
        finals, mets = [], []
        for b, sched in enumerate(scheds):
            state = lane_state(states, b)
            cols = schedule_columns(sched, cfg.n, state.device)
            rows = []
            for _ in range(length):
                state, m = tick(state, sched, cols)
                rows.append(m)
            finals.append(state)
            mets.append(torch.stack(rows) if rows else torch.zeros(
                (0, len(METRIC_FIELDS)), dtype=torch.int32,
                device=state.device))
        met = torch.stack(mets)
        return stack_states(finals), OverlayMetrics(**{
            f: met[..., j] for j, f in enumerate(METRIC_FIELDS)})

    return run


# ------------------------------------------------------------ checkpoints

_FIELDS = tuple(f.name for f in dataclasses.fields(OverlayState))


def _overlay_expect(host) -> dict:
    n, k = np.asarray(host["ids"]).shape
    f = np.asarray(host["send_flags"]).shape[1]
    return {"tick": (), "ids": (n, k), "hb": (n, k), "ts": (n, k),
            "in_group": (n,), "own_hb": (n,), "send_flags": (n, f),
            "send_hist": (n, f), "joinreq": (n,), "joinrep": (n,)}


def overlay_state_to_host(state: OverlayState) -> dict:
    """State -> the JAX package's host dict / npz schema."""
    return {name: (np.asarray(state.tick, np.int32) if name == "tick"
                   else getattr(state, name).detach().cpu().numpy())
            for name in _FIELDS}


def overlay_state_from_host(host: dict, device=None) -> OverlayState:
    """Inverse of :func:`overlay_state_to_host`; accepts the dict of the
    JAX ``overlay_state_to_host`` (schema-checked as there)."""
    dev = resolve_device(device)
    missing = set(_FIELDS) - host.keys()
    if missing:
        raise ValueError(f"checkpoint is missing fields: {sorted(missing)}")
    extra = host.keys() - set(_FIELDS)
    if extra:
        raise ValueError(
            f"checkpoint has unknown fields {sorted(extra)} — written by an "
            "incompatible OverlayState schema?")
    for name, shape in _overlay_expect(host).items():
        got = np.asarray(host[name]).shape
        if got != shape:
            raise ValueError(
                f"checkpoint field {name!r} has shape {got}, expected {shape}")
    return OverlayState(**{
        name: (int(np.asarray(host[name])) if name == "tick"
               else torch.from_numpy(np.array(host[name])).to(dev))
        for name in _FIELDS})


def save_overlay_checkpoint(state: OverlayState, path: str) -> None:
    """Write a mid-run checkpoint; the path is used verbatim."""
    with open(path, "wb") as f:
        np.savez(f, **overlay_state_to_host(state))


def load_overlay_checkpoint(path: str, device=None) -> OverlayState:
    with np.load(path) as z:
        return overlay_state_from_host({k: z[k] for k in z.files}, device)


# --------------------------------------------------- result and simulation

@dataclass
class OverlayResult:
    cfg: SimConfig
    sched: OverlaySchedule
    final_state: OverlayState
    metrics: OverlayMetrics      # numpy arrays, each [T]
    wall_seconds: float

    @property
    def ticks_run(self) -> int:
        return int(np.asarray(self.metrics.in_group).shape[0])

    @property
    def node_ticks_per_second(self) -> float:
        if self.ticks_run == 0 or self.wall_seconds <= 0.0:
            return 0.0
        return self.cfg.n * self.ticks_run / self.wall_seconds

    def _failed_at_end(self, flap: bool = True):
        """bool[N] failed at the state's clock: the fail window, and the
        flap world's down phases unless ``flap`` is False."""
        i = torch.arange(self.cfg.n, dtype=torch.int64)
        t_end = self.final_state.tick
        if not flap:
            return self.sched.window_failed_at(i, t_end).numpy()
        return self.sched.failed_at(i, t_end).numpy()

    def uncovered_members(self) -> np.ndarray:
        """ids of live members present in NO view of the final tables,
        judged at the state's own clock."""
        ids = self.final_state.ids.cpu().numpy()
        n = self.cfg.n
        if ids.max() >= n:
            raise AssertionError(
                f"corrupt view table: id {ids.max()} >= N={n}")
        present = np.zeros(n, bool)
        present[ids[ids >= 0]] = True
        i = np.arange(n)
        live = self.final_state.in_group.cpu().numpy() \
            & ~self._failed_at_end() & (i != INTRODUCER)
        return np.flatnonzero(live & ~present)

    def final_coverage(self):
        """(live_uncovered_count, victim_entries_left) of the final
        tables; see :meth:`uncovered_members`.  A victim entry names a
        subject inside its fail window (a flap-down subject is not one,
        as in the JAX package)."""
        ids = self.final_state.ids.cpu().numpy()
        victim_left = int(self._failed_at_end(flap=False)[
            ids[ids >= 0]].sum())
        return int(self.uncovered_members().size), victim_left


class OverlaySimulation:
    """Orchestrator for cfg.model == "overlay" runs (metrics mode), on
    ``cuda`` unless ``device="cpu"``.  ``per_tick=True`` takes the
    per-tick route (K3 a tick on a card) whatever the envelopes say, as
    the JAX ``OverlaySimulation(use_pallas=False)``; the default routes
    as :func:`make_overlay_run`."""

    def __init__(self, cfg: SimConfig, device=None, per_tick: bool = False):
        if cfg.model != "overlay":
            raise ValueError("OverlaySimulation requires cfg.model='overlay'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.per_tick = per_tick

    def run(self, profile_dir: str | None = None,
            resume_from: OverlayState | None = None,
            ticks: int | None = None) -> OverlayResult:
        """Run the scenario; ``resume_from`` continues a (checkpointed)
        state bit-identically, ``ticks`` stops the segment early.
        ``profile_dir`` runs it under ``torch.profiler`` (the card's
        kernels too, on ``cuda``) and writes a Chrome trace,
        ``overlay_n{N}_t{first}-{end}.json``, into that directory."""
        if profile_dir is not None:
            return self._run_profiled(profile_dir, resume_from, ticks)
        cfg = self.cfg
        sched = make_overlay_schedule(cfg)
        state = init_overlay_state(cfg, self.device) if resume_from is None \
            else resume_from.to(self.device)
        first = state.tick
        if first > cfg.total_ticks:
            raise ValueError(f"resume_from is at tick {first}, past "
                             f"total_ticks={cfg.total_ticks}")
        if ticks is not None and ticks < 0:
            raise ValueError(f"ticks must be >= 0, got {ticks}")
        t_end = cfg.total_ticks if ticks is None \
            else min(cfg.total_ticks, first + ticks)
        # the start tick is known here, so the K5 route segments its plan
        route = dict(mega=False, grid=False) if self.per_tick else {}
        run = make_overlay_run(cfg, t_end - first, start_tick=first, **route)
        _sync(self.device)
        t0 = time.perf_counter()
        final, metrics = run(state, sched)
        _sync(self.device)
        wall = time.perf_counter() - t0
        if final.tick != t_end:
            raise RuntimeError("overlay run did not complete")
        return OverlayResult(cfg=cfg, sched=sched, final_state=final,
                             metrics=metrics.to_numpy(), wall_seconds=wall)

    def _run_profiled(self, profile_dir: str, resume_from, ticks):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        first = 0 if resume_from is None else resume_from.tick
        with profile(activities=acts) as prof:
            res = self.run(resume_from=resume_from, ticks=ticks)
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"overlay_n{self.cfg.n}_t{first}-"
            f"{res.final_state.tick}.json"))
        return res

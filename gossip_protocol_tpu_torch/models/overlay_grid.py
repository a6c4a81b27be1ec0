"""Host harness of the grid-scale overlay kernel K5 (port of
``gossip_protocol_tpu/models/overlay_grid.py``).

Packs an :class:`~.overlay.OverlayState` into K5's (N, 128) plane (ids
| payload words, the aux state riding the payload words' spare high
bytes; ``ops/cuda/overlay_grid.py``), runs whole ``GRID_TICKS``
launches of ``grid_overlay_ticks`` per segment of the schedule plan
(``models/segments.py``), then a remainder, and unpacks into the same
``(final_state, OverlayMetrics[T])`` contract as
:func:`~.overlay.make_overlay_run`.  Per-tick ``live_uncovered`` is the
"not tracked" sentinel -1, as on the TPU; coverage is checked on the
final state (``OverlayResult.final_coverage``).

:func:`make_grid_fleet_run` steps B independent simulations (distinct
seeds, one config shape) with one K5 call per launch through the
kernel's leading fleet axis: a stacked state (:func:`stack_states`)
with one host clock shared by every lane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..config import SimConfig
from ..ops.cuda.overlay_grid import (GRID_TICKS, MET_ADDS, MET_FALSE_REMOVALS,
                                     MET_IN_GROUP, MET_RECV, MET_REMOVALS,
                                     MET_SENT, MET_VICTIM, MET_VIEW, PLANE_W,
                                     boot_block, grid_overlay_ticks,
                                     pack_plane, unpack_plane)
from ..ops.overlay_rules import (ID_BITS, OverlaySchedule, OverlayState,
                                 as_i32, exchange_mask)
from ..utils import spans
from .overlay import OverlayMetrics, resolved_dims
from .segments import plan_segments, step_fraction

_FIELDS = tuple(f.name for f in dataclasses.fields(OverlayState)
                if f.name != "tick")


def grid_supported(cfg: SimConfig) -> bool:
    """Whether K5 covers this config: power-of-two 8 <= N <= 2^20 with a
    2K <= 128-lane plane, K >= 8, F <= 8, runs of at most 4094 ticks,
    ``step_num * (N-1) < 2^31`` (K5's division-free start ramp), no
    world."""
    n = cfg.n
    k, f = resolved_dims(cfg)
    num, _ = step_fraction(cfg.step_rate)
    return (cfg.model == "overlay" and n & (n - 1) == 0 and n >= 8
            and n <= (1 << ID_BITS) and 2 * k <= 128 and k >= 8 and f <= 8
            and cfg.total_ticks <= 4094 and num * (n - 1) < 2 ** 31
            and not cfg.has_worlds and not cfg.has_latency)


def grid_kernel_kwargs(cfg: SimConfig, k: int, f: int) -> dict:
    """K5's static arguments for a config (all but ``s_ticks``, the
    flags and ``batch``): one definition for the solo and fleet runs."""
    return dict(n=cfg.n, k=k, f_rounds=f, t_remove=cfg.t_remove,
                churn_lo=cfg.total_ticks // 4,
                churn_span=max(cfg.total_ticks // 2, 1),
                can_rejoin=cfg.churn_rate > 0 or cfg.rejoin_after is not None,
                churn_mode=cfg.churn_rate > 0,
                powerlaw=cfg.topology == "powerlaw")


def _clock_guard(start_tick: int | None, tick: int, what: str) -> None:
    """Refuse a plan pinned to another start tick: its phase flags would
    describe the wrong absolute ticks."""
    if start_tick is not None and int(tick) != start_tick:
        raise ValueError(
            f"segmented {what} was planned for start tick {start_tick} "
            f"but the state is at tick {int(tick)}; build the run with the "
            "matching start_tick (or None for the unsegmented variant)")


def pack_grid_plane(cfg: SimConfig, state: OverlayState) -> torch.Tensor:
    """OverlayState -> the packed (N, PLANE_W) plane (a stacked state
    gives (B, N, PLANE_W))."""
    lead = state.ids.shape[:-2]
    flat = {f: getattr(state, f).reshape(-1, *getattr(state, f).shape[
        len(lead) + 1:]) for f in _FIELDS}
    plane = pack_plane(flat["ids"], flat["hb"], flat["ts"], flat["in_group"],
                       flat["own_hb"], flat["joinreq"], flat["joinrep"],
                       flat["send_flags"])
    return plane.view(*lead, cfg.n, PLANE_W)


def unpack_grid_plane(cfg: SimConfig, plane: torch.Tensor,
                      tick: int) -> OverlayState:
    """Inverse of :func:`pack_grid_plane` (``tick`` is the host clock)."""
    k, f = resolved_dims(cfg)
    lead = plane.shape[:-2]
    fields = unpack_plane(plane.reshape(-1, PLANE_W), k, f)
    fields = {name: v.reshape(*lead, cfg.n, *v.shape[1:])
              for name, v in fields.items()}
    # the grid envelope excludes the latency plane (grid_supported)
    return OverlayState(tick=int(tick), send_hist=torch.zeros(
        (*lead, cfg.n, f), dtype=torch.int32, device=plane.device), **fields)


@functools.lru_cache(maxsize=64)
def _intro_window(sched: OverlaySchedule) -> tuple[int, int]:
    """The introducer's (fail, rejoin) ticks (host ints; once a
    schedule, since every launch reads them)."""
    i0 = torch.zeros(1, dtype=torch.int64)
    return int(sched.fail_of(i0)[0]), int(sched.rejoin_of(i0)[0])


def _boot_rows(cfg: SimConfig, sched: OverlaySchedule, plane: torch.Tensor,
               t0: int, join_live: bool = True) -> torch.Tensor:
    """The (8, PLANE_W) boot block of a launch at tick ``t0``: row 0 the
    introducer's plane row, row 1 lanes [0, K) the tick's JOINREQ
    per-slot aggregate (later ticks' aggregates accumulate in K5);
    ``ops/cuda/overlay_grid.py boot_block``.  Row 1 is what K5's carry
    hands a launch and the plain version of its boot pre-pass
    (``grid_boot_rows``, which a run's first launch at a tick > 0 runs);
    the plain K5 derives the block from the state itself."""
    fail0, rejoin0 = _intro_window(sched)
    return boot_block(plane, k=resolved_dims(cfg)[0], t0=t0, seed=sched.seed,
                      fail0=fail0, rejoin0=rejoin0, join_live=join_live)


def _sp_vector(sched: OverlaySchedule, t0: int, s_ticks: int, n: int,
               f: int) -> np.ndarray:
    """One ``sp`` row: K5's scalars, the F-1 degree thresholds and the
    launch's (S, F) XOR masks (int32 bits)."""
    fail0, rejoin0 = _intro_window(sched)
    scalars = [t0, sched.seed, sched.victim_lo, sched.victim_hi,
               sched.fail_tick, sched.rejoin_after, sched.churn_thr,
               sched.churn_after, int(sched.drop_on), sched.drop_open,
               sched.drop_close, sched.drop_thr, fail0, rejoin0,
               sched.step_num, sched.step_den]
    deg = list(sched.deg_thr)[:f - 1]
    masks = [exchange_mask(sched.seed, t0 + s - 1, fi, n)
             for s in range(s_ticks) for fi in range(f)]
    return np.array([as_i32(v) for v in scalars + deg + masks], np.int32)


def grid_launch_input(cfg: SimConfig, sched: OverlaySchedule,
                      plane: torch.Tensor, t0: int, s_ticks: int,
                      join_live: bool = True):
    """The ``(boot, sp)`` of a K5 launch of ``s_ticks`` at tick ``t0`` on
    a packed plane: the plain boot block (:func:`_boot_rows`, whose row 1
    K5's carry and pre-pass are held against) and the ``sp`` row."""
    return (_boot_rows(cfg, sched, plane, t0, join_live),
            _sp_vector(sched, t0, s_ticks, cfg.n, resolved_dims(cfg)[1]))


def _metrics(met: torch.Tensor) -> OverlayMetrics:
    """OverlayMetrics of (..., T, 128) metric rows (-1 ``live_uncovered``)."""
    return OverlayMetrics(
        in_group=met[..., MET_IN_GROUP], view_slots=met[..., MET_VIEW],
        adds=met[..., MET_ADDS], removals=met[..., MET_REMOVALS],
        false_removals=met[..., MET_FALSE_REMOVALS],
        victim_slots=met[..., MET_VICTIM],
        live_uncovered=torch.full(met.shape[:-1], -1, dtype=torch.int32,
                                  device=met.device),
        sent=met[..., MET_SENT], recv=met[..., MET_RECV])


def _launches(plan):
    """(s_ticks, flags) of every launch of a plan, in order."""
    for seg in plan:
        n_chunks, rem = divmod(seg.ticks, GRID_TICKS)
        for s_ticks in [GRID_TICKS] * n_chunks + ([rem] if rem else []):
            yield s_ticks, seg.flags


def make_grid_run(cfg: SimConfig, length: int,
                  start_tick: int | None = None):
    """``run(state, sched) -> (final, OverlayMetrics[length])`` through
    whole-``GRID_TICKS`` K5 launches per segment of the plan, then a
    remainder.

    ``start_tick`` pins the run's absolute start tick and unlocks the
    segmented plan (each launch elides the phases its ticks provably do
    not need; bit-identical to the all-live kernel); the returned run
    raises if called with a state at another clock.  ``start_tick=None``
    runs the single all-live segment, valid at any clock.

    ``run.stage`` packs the plane and ``run.enqueue`` launches
    (:func:`~.overlay.make_overlay_run`).  While spans record
    (utils/spans.py), each call adds its K5 calls (``GRID_TICKS`` ticks
    each, one kernel a tick) to the counter ``solo.k5_launches`` and its
    boot pre-pass (one where the first launch is join-live at a tick >
    0, which no carried aggregate feeds) to ``solo.boot_prepass``.
    """
    if not grid_supported(cfg):
        raise ValueError("config outside the K5 envelope (grid_supported)")
    f = resolved_dims(cfg)[1]
    kern_kw = grid_kernel_kwargs(cfg, *resolved_dims(cfg))
    launches = list(_launches(plan_segments(cfg, length, start_tick,
                                            GRID_TICKS)))

    def stage(state: OverlayState, sched: OverlaySchedule):
        _clock_guard(start_tick, state.tick, "grid run")
        return [pack_grid_plane(cfg, state), state.tick, sched]

    def enqueue(staged):
        plane, t, sched = staged
        staged.clear()
        spans.count("solo.k5_launches", len(launches))
        spans.count("solo.boot_prepass", int(
            bool(launches) and launches[0][1].join_live and t > 0))
        parts = []
        agg = None      # the boot aggregate carried between launches
        for s_ticks, flags in launches:
            plane2, met, agg = grid_overlay_ticks(
                plane, _sp_vector(sched, t, s_ticks, cfg.n, f),
                s_ticks=s_ticks, agg=agg, **kern_kw,
                **flags.as_kernel_kwargs())
            plane = plane2[s_ticks % 2]
            t += s_ticks
            parts.append(met)
        met = torch.cat(parts) if parts else torch.zeros(
            (0, 128), dtype=torch.int32, device=plane.device)
        return unpack_grid_plane(cfg, plane, t), _metrics(met)

    def run(state: OverlayState, sched: OverlaySchedule):
        return enqueue(stage(state, sched))

    run.stage, run.enqueue = stage, enqueue
    return run


def stack_states(states: Sequence[OverlayState]) -> OverlayState:
    """Stack same-shape lane states at one clock into a fleet state."""
    ticks = {s.tick for s in states}
    if len(ticks) != 1:
        raise ValueError(f"fleet lanes must share one clock, got {ticks}")
    return OverlayState(tick=states[0].tick, **{
        f: torch.stack([getattr(s, f) for s in states]) for f in _FIELDS})


def lane_state(states: OverlayState, b: int) -> OverlayState:
    """Lane ``b`` of a stacked fleet state."""
    return OverlayState(tick=states.tick, **{
        f: getattr(states, f)[b] for f in _FIELDS})


def make_grid_fleet_run(cfg: SimConfig, length: int, batch: int,
                        start_tick: int | None = 0):
    """Fleet grid run: ONE K5 call per launch steps ``batch``
    independent simulations (distinct seeds, one config shape) through
    the kernel's leading lane axis.

    ``run(states, scheds) -> (finals, OverlayMetrics[batch, length])``
    where ``states`` is a stacked :class:`OverlayState` (one host clock,
    every tensor with a leading (B,) axis; :func:`stack_states`) and
    ``scheds`` a sequence of B schedules.  The segment plan is derived
    from the config alone, never the seed, so one plan serves every
    lane.  Each lane equals :func:`make_grid_run` of its schedule.
    """
    if not grid_supported(cfg):
        raise ValueError("config outside the K5 envelope (grid_supported)")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    f = resolved_dims(cfg)[1]
    kern_kw = grid_kernel_kwargs(cfg, *resolved_dims(cfg))
    plan = plan_segments(cfg, length, start_tick, GRID_TICKS)

    def run(states: OverlayState, scheds: Sequence[OverlaySchedule]):
        _clock_guard(start_tick, states.tick, "grid fleet run")
        if len(scheds) != batch or states.ids.shape[0] != batch:
            raise ValueError(f"expected {batch} lanes, got "
                             f"{states.ids.shape[0]} states and "
                             f"{len(scheds)} schedules")
        planes = pack_grid_plane(cfg, states)
        t = states.tick
        parts = []
        agg = None      # the lanes' boot aggregates carried between launches
        for s_ticks, flags in _launches(plan):
            plane2, met, agg = grid_overlay_ticks(
                planes, np.stack([_sp_vector(sc, t, s_ticks, cfg.n, f)
                          for sc in scheds]), s_ticks=s_ticks,
                batch=batch, agg=agg, **kern_kw,
                **flags.as_kernel_kwargs())
            planes = plane2[:, s_ticks % 2]
            t += s_ticks
            parts.append(met)
        met = torch.cat(parts, 1) if parts else torch.zeros(
            (batch, 0, 128), dtype=torch.int32, device=planes.device)
        return unpack_grid_plane(cfg, planes, t), _metrics(met)

    return run

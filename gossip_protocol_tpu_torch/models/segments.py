"""Schedule-segmented planning for the grid-scale overlay kernel (port
of ``gossip_protocol_tpu/models/segments.py``).

The protocol's epochs are closed-form counter functions of the config
(``ops/overlay_rules.py OverlaySchedule``): the join ramp ends at
``start(N-1)``, churn and scripted failures and rejoins live in a
bounded tick window, and the drop window is ``(drop_open, drop_close]``.
This module derives, on the host, the tick at which each phase goes
*provably dead* and splits a run into launch-aligned segments tagged
with four liveness flags; K5 (``ops/cuda/overlay_grid.py``) elides the
dead phases of a launch from its per-row work.

Flag semantics (each one OFF is a *guarantee* over every tick the
launch computes):

* ``ramp_live`` off: every peer's start tick precedes every tick of the
  launch.  Dead from ``last_start + 1``.
* ``churn_live`` off: no row is inside its fail window and no row
  rejoins at any tick of the launch (the introducer too).  Dead outside
  ``[first_fail, last_rejoin]``; a no-rejoin scripted failure keeps it
  live from ``fail_tick`` onward (victims stay failed forever).
* ``join_live`` off: the joinreq/joinrep in-flight bits are zero at the
  launch's start and no join or rejoin event can set them during it.
  Flags drain within 3 ticks of the last possible ``starting`` event,
  so dead from ``max(last_start, last_rejoin) + 3``.
* ``drop_live`` off: the drop window does not intersect the launch.

Every bound comes from the config alone (never from the seed), so every
lane of a fleet shares one plan.  The adversarial worlds fold their
windows in (:func:`phase_windows`): the wave's radius ramp replaces the
scripted fail tick, flapping widens the churn and join windows, and the
partition window unions into the drop window.
:func:`quantized_plan_signature` is the serving layer's canonical key.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

from ..config import SimConfig

#: sentinel for "never happens within any representable run"
_INF = 1 << 30


@dataclasses.dataclass(frozen=True)
class PhaseFlags:
    """Per-launch phase liveness (K5's specialization key)."""

    ramp_live: bool
    churn_live: bool
    join_live: bool
    drop_live: bool

    def as_kernel_kwargs(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def tag(self) -> str:
        """Compact label, e.g. ``"ramp+join"`` or ``"steady"``."""
        parts = [name for name, on in (
            ("ramp", self.ramp_live), ("churn", self.churn_live),
            ("join", self.join_live), ("drop", self.drop_live)) if on]
        return "+".join(parts) if parts else "steady"


ALL_LIVE = PhaseFlags(True, True, True, True)


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of consecutive same-flag launches: ``start`` is the absolute
    tick of its first tick and ``ticks`` its length; every segment is a
    whole number of ``grid_ticks`` launches except possibly the last."""

    start: int
    ticks: int
    flags: PhaseFlags


@dataclasses.dataclass(frozen=True)
class PhaseWindows:
    """Inclusive tick windows in which each phase can be live."""

    last_start: int       # last tick with a scheduled nodeStart
    fail_lo: int          # first tick any fail window can open
    rejoin_hi: int        # last tick any row can be failed/rejoining
    #                       (_INF: no rejoin — failures are permanent)
    join_dead_from: int   # first tick with provably-zero join flags
    drop_lo: int          # first tick the drop window covers
    drop_hi: int          # last tick the drop window covers (-1: off)


def step_fraction(step_rate: float) -> tuple[int, int]:
    """(num, den) of the start-ramp rate: node ``i`` starts at tick
    ``i * num // den`` (shared by the schedule, the planner and K5's
    division-free ramp, which must agree on ``last_start``)."""
    frac = Fraction(step_rate).limit_denominator(1 << 15)
    return frac.numerator, max(frac.denominator, 1)


def phase_windows(cfg: SimConfig) -> PhaseWindows:
    """Seed-independent closed-form liveness windows of a config.

    The adversarial worlds (worlds.py) fold in: the correlated failure
    wave replaces the scripted fail tick with its radius-ramp window,
    flapping members widen the churn and join windows to the flap window
    (every up-edge is a rejoin through the JOINREQ path), and the
    partition window unions into the drop window (it rides the drop
    plane).  The byz and latency planes are windowless; they enter plan
    identity through ``worlds_key`` in :func:`plan_signature`.
    """
    from .. import worlds
    n, total = cfg.n, cfg.total_ticks
    num, den = step_fraction(cfg.step_rate)
    last_start = (n - 1) * num // den
    if cfg.churn_rate > 0:
        # churn fail ticks are hashed into [lo, lo + span); rejoin
        # follows ``churn_after`` ticks later (make_overlay_schedule)
        fail_lo = total // 4
        fail_hi = fail_lo + max(total // 2, 1) - 1
        after = cfg.rejoin_after if cfg.rejoin_after is not None else 40
        rejoin_hi = fail_hi + after
    elif cfg.wave_size > 0:
        # the wave's radius ramp: first victim at wave_start, last at
        # wave_last_fail (config-only: the seed moves which nodes)
        fail_lo = worlds.wave_start(cfg)
        fail_hi = worlds.wave_last_fail(cfg)
        rejoin_hi = fail_hi + cfg.rejoin_after \
            if cfg.rejoin_after is not None else _INF
    else:
        fail_lo = cfg.fail_tick
        rejoin_hi = cfg.fail_tick + cfg.rejoin_after \
            if cfg.rejoin_after is not None else _INF
    join_events = [last_start]
    if rejoin_hi < _INF:
        join_events.append(rejoin_hi)
    if cfg.flap_rate > 0:
        # flappers fail/rejoin inside [flap_open, flap_close]; the first
        # possible down tick is anchor + 1 >= flap_open + 1
        flap_lo, flap_hi = worlds.flap_window(cfg)
        fail_lo = min(fail_lo, flap_lo + 1)
        rejoin_hi = max(rejoin_hi, flap_hi)
        join_events.append(flap_hi)
    drop_lo = cfg.drop_open_tick + 1 if cfg.drop_msg else 0
    drop_hi = cfg.drop_close_tick if cfg.drop_msg else -1
    if cfg.partition_groups >= 2:
        # the partition rides the drop plane: union the two send-
        # blocking windows (one conservative interval)
        p_lo, p_hi = cfg.partition_open_tick + 1, cfg.partition_close_tick
        drop_lo, drop_hi = ((min(drop_lo, p_lo), max(drop_hi, p_hi))
                            if cfg.drop_msg else (p_lo, p_hi))
    return PhaseWindows(
        last_start=last_start,
        fail_lo=fail_lo,
        rejoin_hi=rejoin_hi,
        join_dead_from=max(join_events) + 3,
        drop_lo=drop_lo,
        drop_hi=drop_hi,
    )


def flags_at(win: PhaseWindows, t: int) -> PhaseFlags:
    """Phase liveness at one absolute tick (conservative)."""
    return PhaseFlags(
        ramp_live=t <= win.last_start,
        churn_live=win.fail_lo <= t <= win.rejoin_hi,
        join_live=t < win.join_dead_from,
        drop_live=win.drop_lo <= t <= win.drop_hi,
    )


def _launch_flags(win: PhaseWindows, t0: int, ticks: int) -> PhaseFlags:
    """OR of per-tick liveness over a launch window [t0, t0+ticks)."""
    f = [flags_at(win, t) for t in range(t0, t0 + ticks)]
    return PhaseFlags(*(any(getattr(x, name) for x in f)
                        for name in ("ramp_live", "churn_live", "join_live",
                                     "drop_live")))


def plan_segments(cfg: SimConfig, length: int, start_tick: int | None,
                  grid_ticks: int) -> list[Segment]:
    """Launch-aligned segment plan for ticks
    ``[start_tick, start_tick + length)``.

    ``start_tick=None`` (the caller cannot pin the absolute start tick)
    gives one all-live segment, exact at any clock.  Launch boundaries
    are the unsegmented ones: whole ``grid_ticks`` chunks from the
    start, the remainder last.
    """
    if length <= 0:
        return []
    if start_tick is None:
        return [Segment(start=-1, ticks=length, flags=ALL_LIVE)]
    win = phase_windows(cfg)
    segs: list[Segment] = []
    t = start_tick
    remaining = length
    while remaining > 0:
        s_ticks = min(grid_ticks, remaining)
        flags = _launch_flags(win, t, s_ticks)
        if segs and segs[-1].flags == flags \
                and segs[-1].ticks % grid_ticks == 0:
            segs[-1] = dataclasses.replace(
                segs[-1], ticks=segs[-1].ticks + s_ticks)
        else:
            segs.append(Segment(start=t, ticks=s_ticks, flags=flags))
        t += s_ticks
        remaining -= s_ticks
    # the invariant K5 relies on: a join-dead launch has no starting
    # events — the ramp is over and, when rejoin is enabled at all
    # (finite rejoin_hi), the rejoin window is too
    for seg in segs:
        assert seg.flags.join_live or not (
            seg.flags.ramp_live
            or (seg.flags.churn_live and win.rejoin_hi < _INF)), seg
    return segs


def describe_plan(plan: list[Segment]) -> str:
    """Compact plan, e.g. ``"ramp+join:48 + churn+join:144 + steady:96"``."""
    return " + ".join(f"{s.flags.tag}:{s.ticks}" for s in plan)


#: launch quantum the checkpoint planner aligns to; equals K5's
#: ``ops/cuda/overlay_grid.GRID_TICKS`` (tests/test_torch_segments.py)
CHECKPOINT_GRID_TICKS = 16


def checkpoint_ticks(cfg: SimConfig,
                     grid_ticks: int = CHECKPOINT_GRID_TICKS
                     ) -> tuple[int, ...]:
    """The interior segment cuts of a config's tick-0 plan: the snapshot
    points at which a resumed run's plan is the original plan's tail."""
    segs = plan_segments(cfg, cfg.total_ticks, 0, grid_ticks)
    return tuple(s.start for s in segs[1:])


def cut_for_budget(cfg: SimConfig, start: int, budget: int,
                   grid_ticks: int = CHECKPOINT_GRID_TICKS) -> int:
    """End tick of a resumable leg starting at ``start`` under a
    ``budget`` of ticks: the whole run when it fits, else the largest
    legal cut within ``start + budget``, else the smallest cut after
    ``start`` (one oversized leg), else ``total_ticks``."""
    total = cfg.total_ticks
    if not 0 <= start < total:
        raise ValueError(f"leg start {start} outside [0, {total})")
    if total - start <= budget:
        return total
    cuts = [c for c in checkpoint_ticks(cfg, grid_ticks) if c > start]
    within = [c for c in cuts if c - start <= budget]
    if within:
        return within[-1]
    return cuts[0] if cuts else total


def plan_signature(cfg: SimConfig) -> tuple:
    """Hashable seed-independent digest of a config's segment plan: the
    closed-form phase windows plus the horizon (everything
    :func:`plan_segments` reads) and the worlds key."""
    win = phase_windows(cfg)
    return ("segplan", cfg.total_ticks, win.last_start, win.fail_lo,
            win.rejoin_hi, win.join_dead_from, win.drop_lo, win.drop_hi,
            cfg.worlds_key())


def quantize_tick(t: int, grid: int = CHECKPOINT_GRID_TICKS,
                  up: bool = False) -> int:
    """Snap a phase-window edge to the checkpoint grid: lo edges round
    down, hi edges (``up=True``) round up, so a window of quantized
    edges contains the exact one.  Sentinels (``_INF``, negative "no
    window" edges) pass through."""
    if t >= _INF or t < 0:
        return t
    return ((t + grid - 1) // grid) * grid if up else (t // grid) * grid


def quantized_plan_signature(cfg: SimConfig,
                             grid: int = CHECKPOINT_GRID_TICKS) -> tuple:
    """:func:`plan_signature` over the grid-quantized plan (JAX
    ``models/segments.py:352``): the only window it carries is the drop
    draw's, its edges snapped to the ``grid`` (open down, close up), and
    the worlds tail is the operand-vs-static split
    (``worlds.canonical_world_key``), so near-identical schedules share
    one key."""
    from .. import worlds
    drop_q = ((quantize_tick(cfg.drop_open_tick, grid),
               quantize_tick(cfg.drop_close_tick, grid, up=True))
              if cfg.drop_msg else None)
    return ("segplan-q", grid, cfg.total_ticks, drop_q,
            worlds.canonical_world_key(cfg, grid))

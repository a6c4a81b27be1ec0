"""Closed-form adversarial failure worlds (copy of ``gossip_protocol_tpu/worlds.py``).

The port keeps its own copy so it never imports the JAX package: the
same salts, host draws and composition grammar, on the port's
``utils/hash32.py``.  :func:`link_latency_of` takes int64 tensors
holding uint32 ids (``mix32_t``).  The text below is the reference
module's.

Shared by both models.

The course's scenario vocabulary is three worlds — single fail, multi
fail, 10% uniform drop — plus the churn extension, while the protocol
family this framework reproduces (SWIM-style membership, accrual
failure detectors) is evaluated in the literature under partitions,
correlated failures, message-loss asymmetry, and flapping members.
This module is the single source of truth for those richer worlds:
every draw is a pure counter-hash function of ``(seed, tick, node)``
(utils/hash32.mix32), exactly like the existing churn/drop machinery,
so

* the dense model (state.make_schedule_host) precomputes them into
  Schedule arrays,
* the overlay model (models/overlay.OverlaySchedule) evaluates them
  in traced code with zero lookup tables,
* the numpy oracle (testing/overlay_oracle.py) replays them
  bit-exactly,
* fleet lanes stay bit-replayable: seeds move *which* nodes are hit,
  never the windows — the windows are seed-independent config
  functions, which is what lets them ride the segment planner
  (models/segments.phase_windows) and the service bucket keys
  unchanged.

The five worlds (config knobs on :class:`~.config.SimConfig`):

* **partition** (``partition_groups >= 2``) — every node is hashed
  into one of G groups; during ``(partition_open_tick,
  partition_close_tick]`` cross-group sends are blocked (gossip,
  JOINREQ, JOINREP alike — the gate rides the drop plane, applied at
  send time like a drop decision).  Healing is the window closing.
* **asymmetric per-link drop** (``asym_drop``) — the single uniform
  ``msg_drop_prob`` becomes a direction- and pair-dependent matrix:
  link (i -> j) drops with probability ``U(seed, i*N+j) * 2p`` (mean
  ``p``), so some links are near-clean and some lose ~2p of traffic.
  Active during the ordinary drop window.
* **correlated failure wave** (``wave_size > 0``) — a seeded
  epicenter plus a radius-per-tick ramp: the ``wave_size`` nodes in
  the contiguous ring block starting at the epicenter fail at
  ``wave_start + offset // wave_speed`` — k failures within a short
  window instead of independent draws.  Replaces the scripted
  single/multi failure (like churn does); composes with
  ``rejoin_after``.
* **zombie / stale-table peers** (``zombie``) — a window-failed peer
  keeps gossiping its frozen table and frozen heartbeat after its
  fail tick.  Receivers treat the frozen heartbeat as what it is —
  an old observation (its liveness claim is timestamped at the fail
  tick, not the send tick) — so detection still completes, and the
  stale table must not resurrect removed members (the false-positive
  stress the world exists for).
* **flapping members** (``flap_rate > 0``) — a hashed subset of nodes
  fail and rejoin periodically inside ``[flap_open, flap_close]``
  with a closed-form duty cycle: each flapper's cycle anchor is
  ``flap_open + H(seed, i) % flap_period``, it is down for
  ``flap_down`` ticks of every period (only cycles that complete
  before ``flap_close`` run), and every up-edge re-enters through the
  normal JOINREQ path.

Round 2 adds the two planes the first five could not express — no
world FORGED information and no link had LATENCY — plus the
composition grammar (:func:`composition`) that makes the planes
multiply instead of add:

* **Byzantine forgery** (``byz_rate > 0``) — a hashed subset of liars
  inflate their own heartbeat counter, relay their tables at forged
  freshness with heartbeats boosted by ``byz_boost``, and ghost-
  advertise a hashed quarter of the id space (fake members, removed
  victims — the resurrection-pressure attack).  The defense compiles
  in with the plane: liveness evidence is DIRECT-ONLY — a relayed
  heartbeat updates the counter but never refreshes the staleness
  timestamp, and a relayed new entry starts its staleness clock on
  arrival — so honest detection completes on the unchanged horizon
  and every forged entry is purged within ``t_remove + 1`` of its
  last advertisement (the closed-form false-positive bound).
* **per-link latency** (``link_latency > 0``) — link (i -> j)
  delivers gossip after ``1 + H(seed, i*n+j, SALT_LAT) %
  (link_latency + 1)`` ticks (the asym-drop construction with a delay
  codomain).  Needs a message-age dimension in the tick: the dense
  model ages its in-flight gossip plane (``WorldState.gossip_age``,
  at most one message in flight per link), the overlay keeps a
  send-history bitmask (``OverlayState.send_hist``).  Latency delays
  the DELIVERY event; the payload rides the sender's current table
  (the zero-copy discipline both models share), and the join path
  stays one-tick so the segment planner's join windows are untouched.
"""

from __future__ import annotations

import numpy as np

from .config import INTRODUCER, SimConfig
from .utils.hash32 import MASK32, mix32, mix32_t, threshold32

#: counter-hash salts for the world streams (1-8 are taken by the
#: overlay's mask/drop/churn/slot/degree streams, models/overlay.py)
SALT_LINK = 9         # per-link drop threshold (asym_drop)
SALT_PART = 10        # partition group assignment
SALT_FLAP = 11        # flapping-member selection
SALT_FLAP_PHASE = 12  # per-flapper cycle anchor
SALT_WAVE = 13        # wave epicenter
SALT_BYZ = 14         # Byzantine liar selection (round 2)
SALT_BYZ_TARGET = 15  # per-liar ghost-advertisement targets
SALT_LAT = 16         # per-link delivery delay (round 2)

_U = np.uint32


# ---- resolved windows (seed-independent config functions) ----------

def wave_start(cfg: SimConfig) -> int:
    """Absolute tick the wave's epicenter fails (-1 knob = fail_tick)."""
    return cfg.fail_tick if cfg.wave_tick < 0 else cfg.wave_tick


def wave_last_fail(cfg: SimConfig) -> int:
    """Last tick any wave victim fails (the radius ramp's end)."""
    return wave_start(cfg) + (cfg.wave_size - 1) // max(cfg.wave_speed, 1)


def flap_window(cfg: SimConfig) -> tuple[int, int]:
    """Resolved ``[flap_open, flap_close]`` (the -1 knobs default to
    the churn machinery's quarter points)."""
    lo = cfg.total_ticks // 4 if cfg.flap_open_tick < 0 \
        else cfg.flap_open_tick
    hi = (3 * cfg.total_ticks) // 4 if cfg.flap_close_tick < 0 \
        else cfg.flap_close_tick
    return lo, hi


def partition_window(cfg: SimConfig) -> tuple[int, int]:
    """Droppable cross-group sends: ``open < t <= close`` (the same
    half-open convention as the drop window)."""
    return cfg.partition_open_tick, cfg.partition_close_tick


# ---- host-side draws (numpy; the dense Schedule arrays) ------------

def wave_center(cfg: SimConfig) -> int:
    """Seeded epicenter of the correlated failure wave."""
    return int(mix32(_U(cfg.seed & 0xFFFFFFFF), _U(0), _U(SALT_WAVE))) \
        % cfg.n


def wave_fail_ticks(cfg: SimConfig) -> np.ndarray:
    """i32[N] wave fail tick per node (NEVER outside the victim
    block).  Victims are the ``wave_size`` ids in the contiguous ring
    block from the epicenter (introducer excluded — its failure would
    suspend the join path, which is the churn rule too); the node at
    ring offset ``d`` fails at ``wave_start + d // wave_speed``."""
    from .state import NEVER
    n = cfg.n
    off = (np.arange(n) - wave_center(cfg)) % n
    victim = (off < cfg.wave_size) & (np.arange(n) != INTRODUCER)
    t0 = wave_start(cfg)
    return np.where(victim, t0 + off // max(cfg.wave_speed, 1),
                    NEVER).astype(np.int32)


def partition_groups_host(cfg: SimConfig) -> np.ndarray:
    """i32[N] hashed group id per node (zeros when the world is off)."""
    n = cfg.n
    if cfg.partition_groups < 2:
        return np.zeros(n, np.int32)
    g = mix32(_U(cfg.seed & 0xFFFFFFFF),
              np.arange(n, dtype=np.uint32), _U(SALT_PART))
    return (g % _U(cfg.partition_groups)).astype(np.int32)


def link_prob_host(cfg: SimConfig) -> np.ndarray:
    """f32[N, N] per-link drop probability (sender-major), mean
    ``msg_drop_prob``; a f32[0, 0] placeholder when asym_drop is off
    (the tick branches statically, so the field is never read)."""
    if not cfg.asym_drop:
        return np.zeros((0, 0), np.float32)
    n = cfg.n
    i = np.arange(n, dtype=np.uint32)
    # i*N+j wraps in uint32 at very large N — deliberate: it is a hash
    # input, and both backends wrap identically
    h = mix32(_U(cfg.seed & 0xFFFFFFFF),
              i[:, None] * _U(n) + i[None, :], _U(SALT_LINK))
    return (h.astype(np.float64) / 4294967296.0
            * 2.0 * cfg.msg_drop_prob).astype(np.float32)


def flap_threshold(cfg: SimConfig) -> int:
    return threshold32(cfg.flap_rate) if cfg.flap_rate > 0 else 0


def flap_mask_host(cfg: SimConfig) -> np.ndarray:
    """bool[N]: which nodes flap (introducer never — its down phases
    would drop every rejoin's JOINREQ)."""
    n = cfg.n
    if cfg.flap_rate <= 0:
        return np.zeros(n, bool)
    sel = mix32(_U(cfg.seed & 0xFFFFFFFF),
                np.arange(n, dtype=np.uint32), _U(SALT_FLAP)) \
        < _U(flap_threshold(cfg))
    sel = np.asarray(sel, bool).copy()
    sel[INTRODUCER] = False
    return sel


def flap_anchor_host(cfg: SimConfig) -> np.ndarray:
    """i32[N] absolute cycle anchor per node: ``flap_open +
    H(seed, i) % flap_period`` (meaningless where flap_mask is off)."""
    n = cfg.n
    lo, _ = flap_window(cfg)
    ph = mix32(_U(cfg.seed & 0xFFFFFFFF),
               np.arange(n, dtype=np.uint32), _U(SALT_FLAP_PHASE)) \
        % _U(max(cfg.flap_period, 1))
    return (lo + ph.astype(np.int64)).astype(np.int32)


def make_flap_state(cfg: SimConfig):
    """``(i, t) -> (failed, rejoining)`` closure over precomputed
    flap_mask/flap_anchor arrays — the scalar-oracle twin of
    ``Schedule``/``OverlaySchedule`` flap math.  A flapper is down for
    positions [1, flap_down] of each cycle and rejoins at position
    flap_down, cycles running only when they complete before
    flap_close.  Hashes are drawn once here; per-(node, tick) queries
    are O(1), which the message-level oracle relies on (it queries
    every destination every tick)."""
    if cfg.flap_rate <= 0:
        return lambda i, t: (False, False)
    mask = flap_mask_host(cfg)
    anchors = flap_anchor_host(cfg)
    _, hi = flap_window(cfg)
    per = max(cfg.flap_period, 1)
    down = cfg.flap_down

    def state(i: int, t: int) -> tuple[bool, bool]:
        if not bool(mask[i]):
            return False, False
        anchor = int(anchors[i])
        pos = t - anchor
        if pos < 1:
            return False, False
        c = pos // per
        off = pos - c * per
        if anchor + c * per + down > hi:
            return False, False
        return (1 <= off <= down), off == down

    return state


def flap_state_host(cfg: SimConfig, i: int, t: int) -> tuple[bool, bool]:
    """One-shot ``make_flap_state`` query (re-draws the hash arrays;
    use the closure for per-tick loops)."""
    return make_flap_state(cfg)(i, t)


# ---- round-2 planes: Byzantine forgery + per-link latency ----------

#: fraction of ids each liar ghost-advertises (fixed — the knob that
#: matters is byz_rate; a quarter of the id space keeps every receiver
#: under sustained forged-add pressure without drowning the run)
BYZ_TARGET_FRACTION = 0.25


def byz_threshold(cfg: SimConfig) -> int:
    """uint32 threshold for the liar-selection draw."""
    return threshold32(cfg.byz_rate) if cfg.byz_rate > 0 else 0


def byz_mask_host(cfg: SimConfig) -> np.ndarray:
    """bool[N]: which nodes lie (introducer never — a lying join
    authority would forge the membership ground truth itself, which is
    a different protocol's problem; the flap/wave worlds exempt it for
    the same reason)."""
    n = cfg.n
    if cfg.byz_rate <= 0:
        return np.zeros(n, bool)
    sel = mix32(_U(cfg.seed & 0xFFFFFFFF),
                np.arange(n, dtype=np.uint32), _U(SALT_BYZ)) \
        < _U(byz_threshold(cfg))
    sel = np.asarray(sel, bool).copy()
    sel[INTRODUCER] = False
    return sel


def byz_target_host(cfg: SimConfig) -> np.ndarray:
    """bool[N, N] ghost-advertisement targets: liar row i forges
    fresh, boosted entries for the hashed quarter of ids in row i —
    members it may never have heard from, including removed victims
    (the resurrection-pressure attack).  Rows of honest nodes are
    zeroed; a bool[0, 0] placeholder when the plane is off (the tick
    branches statically)."""
    if cfg.byz_rate <= 0:
        return np.zeros((0, 0), bool)
    n = cfg.n
    i = np.arange(n, dtype=np.uint32)
    tgt = mix32(_U(cfg.seed & 0xFFFFFFFF),
                i[:, None] * _U(n) + i[None, :], _U(SALT_BYZ_TARGET)) \
        < _U(threshold32(BYZ_TARGET_FRACTION))
    tgt = np.asarray(tgt, bool) & byz_mask_host(cfg)[:, None]
    np.fill_diagonal(tgt, False)
    return tgt


def link_latency_host(cfg: SimConfig) -> np.ndarray:
    """i32[N, N] per-link delivery delay in ticks (sender-major):
    ``1 + H(seed, i*N+j, SALT_LAT) % (link_latency + 1)``, so every
    link delays in [1, link_latency + 1] and the plane off means the
    reference's uniform one-tick delivery.  An i32[0, 0] placeholder
    when off (the tick branches statically)."""
    if cfg.link_latency <= 0:
        return np.zeros((0, 0), np.int32)
    n = cfg.n
    i = np.arange(n, dtype=np.uint32)
    h = mix32(_U(cfg.seed & 0xFFFFFFFF),
              i[:, None] * _U(n) + i[None, :], _U(SALT_LAT))
    return (1 + h % _U(cfg.link_latency + 1)).astype(np.int32)


def link_latency_of(seed: int, iu, ju, n: int, link_latency: int):
    """Tensor twin of :func:`link_latency_host` for the overlay's
    per-(partner, row) lookups: ``iu``/``ju`` are int64 tensors of
    uint32 ids (sender, receiver); returns the i32 delay of each link
    (``i*N+j`` wraps in uint32 as in the host draw)."""
    import torch
    h = mix32_t(seed & MASK32, (iu * n + ju) & MASK32, SALT_LAT)
    return (1 + h % (link_latency + 1)).to(torch.int32)


# ---- the composition grammar ---------------------------------------

#: overlay planes (any subset composes; the failure SCRIPT is chosen
#: exactly-one-of scripted | wave | churn — wave and churn both
#: replace the scripted failure, which config validation enforces)
PLANES = ("partition", "asym", "zombie", "flapping", "byz", "latency")


def composition(cfg: SimConfig) -> tuple[str, tuple[str, ...]]:
    """``(failure_script, active_planes)`` of a config — the world-
    composition grammar in one place.  A composed world is exactly one
    failure script (scripted single/multi fail, a correlated wave, or
    continuous churn) with any subset of the orthogonal planes layered
    on top; "partition opens DURING a failure wave WHILE flappers
    flap" is one SimConfig.  Every plane's window is a seed-
    independent config function, so compositions fold through
    ``segments.phase_windows`` (∪ of the windows), ``worlds_key``
    (tuple of active planes), plan signatures, bucket keys, and
    checkpoint cuts with no per-plane special cases."""
    script = "churn" if cfg.churn_rate > 0 \
        else "wave" if cfg.wave_size > 0 else "scripted"
    active = []
    if cfg.partition_groups >= 2:
        active.append("partition")
    if cfg.asym_drop:
        active.append("asym")
    if cfg.zombie:
        active.append("zombie")
    if cfg.flap_rate > 0:
        active.append("flapping")
    if cfg.byz_rate > 0:
        active.append("byz")
    if cfg.link_latency > 0:
        active.append("latency")
    return script, tuple(active)


#: world parameters that ride as RUNTIME OPERANDS on the canonical
#: fleet path (service/canonical.py): each maps a plane tag to the
#: SimConfig fields whose values flow through Schedule arrays/scalars
#: instead of being baked into the compiled program.  The plane TAG
#: itself stays static (the tick branches on plane on/off booleans,
#: core/tick.make_tick), so "one program per family" means one program
#: per active-plane SET — probabilities, boosts, radii, per-link
#: matrices all become data.  analysis/cache_keys.py audits that every
#: field named here is read by a DATA_FUNCS builder.
OPERAND_WORLD_FIELDS = {
    "drop": ("msg_drop_prob", "drop_open_tick", "drop_close_tick"),
    "part": ("partition_groups", "partition_open_tick",
             "partition_close_tick"),
    "asym": (),                   # per-link matrix is Schedule data
    "wave": ("wave_size", "wave_tick", "wave_speed"),
    "flap": ("flap_rate", "flap_period", "flap_down",
             "flap_open_tick", "flap_close_tick"),
    "byz": ("byz_rate", "byz_boost"),
    "lat": ("link_latency",),
}


def canonical_world_key(cfg: SimConfig, grid: int) -> tuple:
    """The STATIC half of the operand-vs-static world split: the
    active plane tags — exactly the booleans ``core/tick.make_tick``
    bakes — and nothing else.  Every parameter in
    :data:`OPERAND_WORLD_FIELDS` is omitted: it reaches the compiled
    program as a traced operand via the Schedule (``drop_prob``,
    ``byz_boost``, the flap scalars, the ``fail_tick`` wave script,
    the link matrices), so two configs that differ only in those
    values share one canonical program.  The partition and flap
    WINDOWS are operands too (``part_open``/``part_close`` scalars
    and the flap cycle anchors ride per-lane in SCHED_AXES_CANON —
    both planes are deterministic masks computed OUTSIDE the drop
    cond, state.py ``part_active_at``/``_flap_state``), so no window
    appears here at all; the one window that must be class-shared is
    the drop-draw cond's, carried as the quantized ``drop_q`` pair by
    ``quantized_plan_signature`` itself.  ``grid`` is kept in the
    signature so a future plane that does bake a window has its
    quantization step on hand."""
    del grid  # no window rides this key anymore; see docstring
    ws = []
    if cfg.partition_groups >= 2:
        ws.append(("part",))
    if cfg.asym_drop:
        ws.append(("asym",))
    if cfg.wave_size > 0:
        ws.append(("wave",))
    if cfg.zombie:
        ws.append(("zombie",))
    if cfg.flap_rate > 0:
        ws.append(("flap",))
    if cfg.byz_rate > 0:
        ws.append(("byz",))
    if cfg.link_latency > 0:
        ws.append(("lat",))
    return tuple(ws)

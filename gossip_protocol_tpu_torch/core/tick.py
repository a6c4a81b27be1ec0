"""One dense simulation tick, and the whole-run routing.

Counterpart of ``gossip_protocol_tpu/core/tick.py`` (single device; the
sharded ``RingComm`` path is not ported yet).  The tick's semantics,
and why it can be computed as order-free tensor algebra over the peer
axis, are documented there; this module keeps its order and formulas:
the per-peer vector decisions (start, JOINREQ/JOINREP, in_group, ops,
own_hb, the join accounting) in plain torch (``ops/vector.py``, shared
with K2's plain version), then the two matrix phases, each through a
kernel wrapper.

The adversarial worlds (worlds.py) take the JAX package's two routes:

* **the K1 route** (course worlds, partition, asym drop, wave, flap):
  partition and asym ride the drop draw (``ops/drop.py drop_masks``:
  per-link thresholds, the cross-group gate), flap and wave only the
  schedule, so the tick is the TPU's fused path: ``masked_max3``
  (ops/merge.py), then ``tick_epilogue`` (ops/cuda/tickfused.py, K1) —
  membership update, detection, dissemination, per-row counters;
* **the composable route** (zombie, byz, latency; JAX
  ``core/tick.py:293-471``): ``masked_max3`` on the forged planes (byz)
  and the delivery plane (latency), then the direct credit, the byz
  timestamp defense, detection, zombie sends, the latency hold and the
  accounting as torch elementwise operations, which are XLA, outside
  any Pallas kernel, in the JAX package.

On a CUDA device the wrappers launch the hand-written kernels at every
N (the TPU's (8, 128) tiling gate of ``core/tick.py:138-141`` does not
apply); on the CPU their plain versions.  Nothing else forks on the
device.

:func:`make_run` keeps the JAX routing precedence, corner -> mega ->
per-tick (``core/tick.py:529-573``).

:func:`make_fleet_tick` is the same tick over B lanes of a fleet at one
shared clock (core/fleet.py), where the JAX package runs the XLA tick
under ``jax.vmap``: every state and schedule tensor carries a leading
lane axis, and the K1 route makes three launches a tick for the whole
fleet (``drop_masks_lanes``, ``masked_max3``, ``tick_epilogue``, each
with a lane axis).  The composable worlds run their lanes one at a time
through :func:`_composable_phases` (:func:`composable_lanes`, counted).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import INTRODUCER, SimConfig
from ..ops.cuda.tickfused import tick_epilogue
from ..ops.detect import staleness_mask
from ..ops.drop import drop_masks_lanes, tick_drop_masks
from ..ops.merge import masked_max3
from ..ops.vector import VectorStep, vector_step
from ..state import Schedule, WorldState


#: whole-run builds so far (see :func:`run_build_count`)
_BUILD_COUNT = 0


def run_build_count() -> int:
    """Number of whole-run functions built so far: the misses of the
    fleet program caches (core/fleet.py, models/overlay.py
    ``make_overlay_fleet_run``), each recorded by :func:`note_build`.
    The JAX package's ``make_run`` counts its own cache misses too; the
    port's ``make_run`` keeps no cache (its closure costs nothing to
    build), so it adds nothing here."""
    return _BUILD_COUNT


def note_build() -> None:
    """Record a whole-run build (a fleet program cache miss)."""
    global _BUILD_COUNT
    _BUILD_COUNT += 1


@dataclass
class TickEvents:
    """Grader-visible events of one tick (or stacked over a run)."""

    added: torch.Tensor    # bool[rows, N] — observer i added subject j
    removed: torch.Tensor  # bool[rows, N] — observer i removed subject j
    sent: torch.Tensor     # i32[rows] — successful sends (EmulNet.cpp:111)
    recv: torch.Tensor     # i32[rows] — messages consumed (EmulNet.cpp:172)


def make_tick(cfg: SimConfig, with_events: bool = True,
              n_active: int | None = None):
    """Build ``tick(state, sched) -> (state', TickEvents)`` for a config.

    ``n_active`` pins the drop-stream width: the Bernoulli lattice is
    drawn at ``n_active`` peers and embedded into the (N, N) masks, so a
    full-width tick can consume the active corner's stream
    (core/dense_corner.py) or a canonical rung its lanes' real-width
    stream (service/canonical.py).  Default: N.
    """
    n = cfg.n
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    t_remove = cfg.t_remove
    # flap up-edges are rejoin events (fresh-nodeStart wipes), so the
    # flap world compiles the churn path in (JAX core/tick.py:115)
    flap = cfg.flap_rate > 0
    churn = cfg.rejoin_after is not None or flap
    partition = cfg.partition_groups >= 2
    asym = cfg.asym_drop
    # the worlds the fused K1 path does not compile (JAX core/tick.py:141)
    composable = cfg.zombie or cfg.byz_rate > 0 or cfg.link_latency > 0

    def tick(state: WorldState, sched: Schedule):
        t = state.tick
        dev = state.device

        # ENsend drop injection (EmulNet.cpp:90-94): one drop_masks
        # kernel launch on a card, the width-na draw embedded in it; the
        # asym world's per-link thresholds and the partition's
        # cross-group gate ride the same launch
        gdrop, qdrop, pdrop = tick_drop_masks(
            state.rng, t, n, sched.drop_on(t), sched.drop_prob, dev,
            link_prob=sched.link_prob if asym else None, n_active=na,
            group=sched.part_group if partition else None,
            part_active=sched.part_active_at(t))

        v = vector_step(t, sched.start_tick, sched.fail_tick,
                        sched.rejoin_tick, state.in_group, state.own_hb,
                        state.joinreq, state.joinrep, qdrop, pdrop,
                        churn=churn,
                        flap=sched.flap_state(t) if flap else None)
        known, hb, ts = state.known, state.hb, state.ts
        if churn:   # a rejoining peer's row is wiped before the merge
            keep = ~v.rejoining[:, None]
            known, hb, ts = known & keep, hb * keep, ts * keep

        if composable:
            known, hb, ts, gossip_next, gossip_age, gsent_row, grecv_row, \
                added, removed = _composable_phases(
                    cfg, state, sched, v, known, hb, ts, gdrop, t,
                    with_events)
        else:
            # the two matrix phases (kernels on CUDA, plain on CPU);
            # gossip delivery is read inside them as gossip & proc
            m_all, m_fresh, t_fresh = masked_max3(
                state.gossip, v.proc, known, hb, ts, t, t_remove=t_remove)
            known, hb, ts, gossip_next, gsent_row, grecv_row, added, \
                removed = tick_epilogue(
                    m_all, m_fresh, t_fresh, state.gossip, v.proc, known,
                    hb, ts, gdrop, v.ops, v.jrep, v.jreq, v.hold, t,
                    t_remove=t_remove, with_events=with_events)
            gossip_age = state.gossip_age

        # accounting (EmulNet.cpp:111,172)
        events = TickEvents(added=added, removed=removed,
                            sent=(gsent_row + v.sent).to(torch.int32),
                            recv=(grecv_row + v.recv).to(torch.int32))
        new_state = WorldState(
            tick=t + 1, in_group=v.in_group, own_hb=v.own_hb, known=known,
            hb=hb, ts=ts, gossip=gossip_next, gossip_age=gossip_age,
            joinreq=v.joinreq, joinrep=v.joinrep, rng=state.rng)
        return new_state, events

    return tick


def _composable_phases(cfg: SimConfig, state: WorldState, sched: Schedule,
                       v, known, hb, ts, gdrop, t: int, with_events: bool):
    """The matrix phases of the zombie / byz / latency worlds (JAX
    ``core/tick.py:180-196, 293-471``): ``masked_max3`` on what enters
    the merge (the forged planes, the delivered messages), the rest in
    torch.  ``known``/``hb``/``ts`` are the post-wipe tables.  Returns
    ``(known', hb', ts', gossip', gossip_age', gsent_row, grecv_row,
    added, removed)``."""
    n = cfg.n
    dev = known.device
    t_remove = cfg.t_remove
    zombie, byz = cfg.zombie, cfg.byz_rate > 0
    latency = cfg.link_latency > 0
    idx = torch.arange(n, device=dev)
    self_mask = idx[:, None] == idx[None, :]
    is_intro = idx == INTRODUCER

    # ---- phase A: the messages consumed this tick ([s, r]) -----------
    if latency:
        # a message sent at t0 carries age t - t0 - 1; it delivers once
        # it has been in flight lat(s, r) ticks; undelivered ones keep
        # aging, one in flight a link; traffic to failed receivers rots
        age1 = state.gossip_age + 1
        deliver = state.gossip & (age1 >= sched.link_lat) & v.proc[None, :]
        held = state.gossip & ~deliver & ~v.failed[None, :]
    else:
        deliver = state.gossip & v.proc[None, :]
    dcred = deliver.t()                                  # recv_from [r, s]

    # ---- the merge, on what liar senders present (byz) ---------------
    if byz:
        liar = sched.byz_mask[:, None]
        f_known = known | sched.byz_target
        f_hb = torch.where(liar, hb + sched.byz_boost, hb)
        f_ts = torch.where(liar, torch.full_like(ts, t - 1), ts)
    else:
        f_known, f_hb, f_ts = known, hb, ts
    # the delivery plane goes in whole (proc all true): the merge reads
    # delivery as gossip & proc
    m_all, m_fresh, t_fresh = masked_max3(
        deliver.contiguous(), torch.ones(n, dtype=torch.bool, device=dev),
        f_known.contiguous(), f_hb.contiguous(), f_ts.contiguous(), t,
        t_remove=t_remove)
    any_fresh = t_fresh >= 0

    exists = known
    inc = exists & (m_all > hb)
    hb1 = torch.where(inc, m_all, hb)
    # byz defense: a relayed counter earns no timestamp refresh
    ts1 = ts if byz else torch.where(inc, t, ts)
    padd = ~exists & any_fresh & ~self_mask
    hb1 = torch.where(padd, m_all, hb1)
    if byz:     # forged adds start their staleness clock at arrival
        ts1 = torch.where(padd, t, ts1)
    else:
        ts1 = torch.where(padd, torch.where(m_all > m_fresh, t, t_fresh),
                          ts1)

    # ---- direct-sender credit (MP1Node.cpp:236-242, 265-280) ---------
    known_pb = exists | padd
    if zombie and latency:
        # the liveness claim is dated at the message's true send tick
        # t - age1, per (sender, receiver) cell
        sent_t = t - age1
        zbad = (sent_t > sched.fail_tick[:, None]) \
            & (sent_t <= sched.rejoin_tick[:, None])
        dcred = dcred & ~zbad.t()
    elif zombie:
        dcred = dcred & ~sched.window_failed_at(t - 1)[None, :]
    dinc = dcred & known_pb
    hb1 = torch.where(dinc, hb1 + 1, hb1)
    ts1 = torch.where(dinc, t, ts1)
    dadd = dcred & ~known_pb & ~self_mask
    hb1 = torch.where(dadd, 1, hb1)
    ts1 = torch.where(dadd, t, ts1)
    known1 = exists | padd | dadd

    # ---- JOINREQ at the introducer, JOINREP at the joiner ------------
    qadd = v.jreq & ~known1[INTRODUCER] & ~is_intro
    q_cell = is_intro[:, None] & qadd[None, :]
    known1 = known1 | q_cell
    hb1 = torch.where(q_cell, 1, hb1)
    ts1 = torch.where(q_cell, t, ts1)
    r_cell = (v.jrep & ~known1[:, INTRODUCER])[:, None] & is_intro[None, :]
    known1 = known1 | r_cell
    hb1 = torch.where(r_cell, 1, hb1).to(torch.int32)
    ts1 = torch.where(r_cell, t, ts1).to(torch.int32)

    # ---- detection and dissemination ---------------------------------
    stale = staleness_mask(v.ops, known1, ts1, t, t_remove)
    known2 = known1 & ~stale
    send_rows = v.ops
    if zombie:
        # window-failed peers that were in the group keep gossiping
        # their frozen tables
        send_rows = send_rows | (sched.window_failed_at(t) & v.in_group)
    gossip_sent = send_rows[:, None] & known2 & ~gdrop
    if latency:
        # one message in flight a link: a busy link skips this send
        gossip_sent = gossip_sent & ~held
        gossip_next = gossip_sent | held
        gossip_age = torch.where(held, age1, 0).to(torch.int32)
    else:
        gossip_next = gossip_sent | (state.gossip & v.hold[None, :])
        gossip_age = state.gossip_age
    sent_row = gossip_sent.sum(1, dtype=torch.int32)
    recv_row = deliver.sum(0, dtype=torch.int32)
    added = known1 & ~exists if with_events else None
    return (known2, hb1, ts1, gossip_next, gossip_age, sent_row, recv_row,
            added, stale if with_events else None)


def composable_lanes(cfg: SimConfig, state: WorldState, lane_scheds, v,
                     known, hb, ts, gdrop, t: int, with_events: bool):
    """The composable worlds' matrix phases of a fleet tick, one lane at a
    time through :func:`_composable_phases` (the lane axis of the K1
    route does not reach these worlds' torch phases yet).  Adds one to
    ``composable_lanes.calls`` a lane.  Returns the stacked outputs of
    :func:`_composable_phases`."""
    outs = []
    for b, sched_b in enumerate(lane_scheds):
        lane = WorldState(
            tick=t, in_group=state.in_group[b], own_hb=state.own_hb[b],
            known=state.known[b], hb=state.hb[b], ts=state.ts[b],
            gossip=state.gossip[b], gossip_age=state.gossip_age[b],
            joinreq=state.joinreq[b], joinrep=state.joinrep[b],
            rng=state.rng[b])
        v_b = VectorStep(**{f: getattr(v, f)[b]
                            for f in VectorStep.__dataclass_fields__})
        outs.append(_composable_phases(cfg, lane, sched_b, v_b, known[b],
                                       hb[b], ts[b], gdrop[b], t,
                                       with_events))
        composable_lanes.calls += 1
    return tuple(None if col[0] is None else torch.stack(col)
                 for col in zip(*outs))


composable_lanes.calls = 0


def make_fleet_tick(cfg: SimConfig, with_events: bool = True,
                    n_active: int | None = None):
    """Build ``tick(states, sched, drop, lane_scheds=None) -> (states',
    TickEvents)`` over B lanes at one shared clock.

    ``states`` is a stacked :class:`WorldState` (one host clock, tensors
    [B, ...], ``rng`` uint32[B, 2]); ``sched`` a stacked
    :class:`Schedule` (columns [B, N], planes [B, N, N]; its scalars are
    config values every lane shares); ``drop`` the fleet's
    :class:`~..ops.drop.LaneDrop` (each lane's key, probability and
    windows); ``lane_scheds`` the B per-lane schedules, which only the
    composable worlds read.  Events come back as [B, N, N] masks and
    [B, N] counters.  Each lane equals :func:`make_tick` of its own
    state and schedule, bit for bit.
    """
    n = cfg.n
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    t_remove = cfg.t_remove
    flap = cfg.flap_rate > 0
    churn = cfg.rejoin_after is not None or flap
    partition = cfg.partition_groups >= 2
    asym = cfg.asym_drop
    composable = cfg.zombie or cfg.byz_rate > 0 or cfg.link_latency > 0

    def tick(state: WorldState, sched: Schedule, drop, lane_scheds=None):
        t = state.tick
        dev = state.device
        # one launch for every lane's draw
        gdrop, qdrop, pdrop = drop_masks_lanes(
            drop, t, n, na, dev, link_prob=sched.link_prob if asym else None,
            group=sched.part_group if partition else None)
        v = vector_step(t, sched.start_tick, sched.fail_tick,
                        sched.rejoin_tick, state.in_group, state.own_hb,
                        state.joinreq, state.joinrep, qdrop, pdrop,
                        churn=churn,
                        flap=sched.flap_state(t) if flap else None)
        known, hb, ts = state.known, state.hb, state.ts
        if churn:
            keep = ~v.rejoining[..., None]
            known, hb, ts = known & keep, hb * keep, ts * keep
        if composable:
            if lane_scheds is None:
                raise ValueError("the composable worlds need the lanes' "
                                 "own schedules (lane_scheds)")
            known, hb, ts, gossip_next, gossip_age, gsent_row, grecv_row, \
                added, removed = composable_lanes(
                    cfg, state, lane_scheds, v, known, hb, ts, gdrop, t,
                    with_events)
        else:
            m_all, m_fresh, t_fresh = masked_max3(
                state.gossip, v.proc, known, hb, ts, t, t_remove=t_remove)
            known, hb, ts, gossip_next, gsent_row, grecv_row, added, \
                removed = tick_epilogue(
                    m_all, m_fresh, t_fresh, state.gossip, v.proc, known,
                    hb, ts, gdrop, v.ops, v.jrep, v.jreq, v.hold, t,
                    t_remove=t_remove, with_events=with_events)
            gossip_age = state.gossip_age
        events = TickEvents(added=added, removed=removed,
                            sent=(gsent_row + v.sent).to(torch.int32),
                            recv=(grecv_row + v.recv).to(torch.int32))
        new_state = WorldState(
            tick=t + 1, in_group=v.in_group, own_hb=v.own_hb, known=known,
            hb=hb, ts=ts, gossip=gossip_next, gossip_age=gossip_age,
            joinreq=v.joinreq, joinrep=v.joinrep, rng=state.rng)
        return new_state, events

    return tick


def stack_events(events: list, with_events: bool, n: int,
                 device) -> TickEvents:
    """Stack per-tick events over a run (bench mode: (T,) placeholders
    for the masks, as every JAX ``make_run`` path returns)."""
    t_len = len(events)
    if events:
        sent = torch.stack([e.sent for e in events])
        recv = torch.stack([e.recv for e in events])
    else:
        sent = torch.zeros((0, n), dtype=torch.int32, device=device)
        recv = torch.zeros((0, n), dtype=torch.int32, device=device)
    if with_events:
        if events:
            added = torch.stack([e.added for e in events])
            removed = torch.stack([e.removed for e in events])
        else:
            added = torch.zeros((0, n, n), dtype=torch.bool, device=device)
            removed = torch.zeros((0, n, n), dtype=torch.bool, device=device)
    else:
        added = removed = torch.zeros((t_len,), dtype=torch.bool,
                                      device=device)
    return TickEvents(added=added, removed=removed, sent=sent, recv=recv)


def make_tick_run(cfg: SimConfig, with_events: bool = True,
                  n_active: int | None = None):
    """``run(state, sched)``: ``cfg.total_ticks`` per-tick steps from the
    state's clock (the per-tick ``lax.scan`` of the JAX ``make_run``)."""
    tick = make_tick(cfg, with_events=with_events, n_active=n_active)

    def run(state: WorldState, sched: Schedule):
        events = []
        for _ in range(cfg.total_ticks):
            state, ev = tick(state, sched)
            events.append(ev)
        return state, stack_events(events, with_events, cfg.n, state.device)

    return run


def make_run(cfg: SimConfig, with_events: bool = True):
    """Whole-run function ``run(state, sched) -> (final, stacked events)``
    over ``cfg.total_ticks`` ticks, routed as the JAX ``make_run``:

    * bench mode on a config whose schedule never starts the peers
      ``>= A`` runs on the active ``A x A`` corner (core/dense_corner.py);
    * else, inside the megakernel envelope, ``DENSE_MEGA_TICKS`` ticks
      per K2 call (core/dense_mega.py);
    * else the per-tick path (:func:`make_tick_run`).

    The mega and corner routes are taken on the CPU too (with the plain
    kernel versions), so the CPU and the card run the same path.
    """
    from .dense_corner import active_bound, make_corner_run
    from .dense_mega import dense_mega_supported, make_dense_mega_run
    a = active_bound(cfg)
    if not with_events and 0 < a < cfg.n:
        return make_corner_run(cfg, a)
    if dense_mega_supported(cfg, with_events):
        return make_dense_mega_run(cfg, with_events=with_events)
    return make_tick_run(cfg, with_events=with_events)

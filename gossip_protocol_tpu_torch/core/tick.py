"""One dense simulation tick, and the whole-run routing.

Counterpart of ``gossip_protocol_tpu/core/tick.py``.  The tick's semantics,
and why it can be computed as order-free tensor algebra over the peer
axis, are documented there; this module keeps its order and formulas:
the per-peer vector decisions (start, JOINREQ/JOINREP, in_group, ops,
own_hb, the join accounting; ``ops/vector.py``), then the two matrix
phases, each through a kernel wrapper.  On the K1 route the vector step
is a kernel wrapper too (``fused_vector_step``, one launch on a card);
the composable route keeps it in plain torch (``vector_step``, shared
with K2's plain version), since its torch phases read it.

The adversarial worlds (worlds.py) take the JAX package's two routes:

* **the K1 route** (course worlds, partition, asym drop, wave, flap):
  partition and asym ride the drop draw (``ops/drop.py drop_masks``:
  per-link thresholds, the cross-group gate), flap and wave only the
  schedule, so the tick is the TPU's fused path: ``masked_max3``
  (ops/merge.py), then ``tick_epilogue`` (ops/cuda/tickfused.py, K1) —
  membership update, detection, dissemination, per-row counters —, or,
  where the merge builds its witness ladder (N > 1024), the two as one
  op, ``merge_epilogue`` (ops/merge.py), whose kernel applies the cell
  rules inside the merge's tiles;
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
lane axis, and the K1 route makes five launches a tick for the whole
fleet (``drop_masks_lanes``, ``fused_vector_step``, ``masked_max3``'s
prep and descent, ``tick_epilogue``, each with a lane axis), four where
``merge_epilogue`` takes the last three; the vector step seeds the
tick's sent / recv rows with the join traffic and the epilogue adds the
gossip counts onto them.  The composable worlds
run their lanes one at a time through :func:`_composable_phases`
(:func:`composable_lanes`, counted).  The two builders differ only in
their draw: the route (:func:`_route`) and everything after the draw
are one body, :func:`_make_body`.

``comm=`` (parallel/comm.py) makes either tick one shard of a
peer-sharded run: under a ``RingComm`` the tick takes the composable
route, as the JAX tick leaves its fused path for any comm but
``LocalComm`` (``core/tick.py:139-141``), so K1 never runs sharded.  The
tables hold the shard's rows; each shard draws the whole drop plane and
takes its rows (``core/tick.py:248``), the per-peer vectors stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import INTRODUCER, SimConfig
from ..ops.cuda._build import count_launch
from ..ops.cuda.tickfused import tick_epilogue
from ..ops.drop import drop_masks_lanes, tick_drop_masks
from ..ops.merge import masked_max3, merge_epilogue, uses_ladder
from ..ops.vector import VectorStep, fused_vector_step, vector_step
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


def _sharded(comm) -> bool:
    from ..parallel.comm import LocalComm
    return comm is not None and not isinstance(comm, LocalComm)


def _route(cfg: SimConfig, comm) -> str:
    """The dense tick's route, for the solo tick and the fleet tick alike:
    ``"sharded"`` under any comm but one device (JAX
    ``core/tick.py:139-141``), else ``"composable"`` for the worlds the
    fused K1 path does not compile (zombie, byz, latency), else
    ``"k1"``."""
    if _sharded(comm):
        return "sharded"
    if cfg.zombie or cfg.byz_rate > 0 or cfg.link_latency > 0:
        return "composable"
    return "k1"


def _stream_width(n: int, n_active: int | None) -> int:
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    return na


def _make_body(cfg: SimConfig, with_events: bool, comm):
    """The tick after its draw, shared by :func:`make_tick` and
    :func:`make_fleet_tick`: ``body(state, sched, gdrop, qdrop, pdrop,
    phases, counts=None) -> (state', TickEvents)``, with or without a
    lane axis.  ``phases`` is how the composable route runs its matrix
    phases, ``(fn, scheds)``: a solo tick's ``(_composable_phases,
    sched)``, a fleet's ``(composable_lanes, lane_scheds)``.  ``counts``
    goes to the K1 route's merge (``masked_max3`` or
    ``merge_epilogue``)."""
    t_remove = cfg.t_remove
    # flap up-edges are rejoin events (fresh-nodeStart wipes), so the
    # flap world compiles the churn path in (JAX core/tick.py:115)
    flap = cfg.flap_rate > 0
    churn = cfg.rejoin_after is not None or flap
    route = _route(cfg, comm)
    if route == "sharded" and cfg.n % comm.n_shards:
        raise ValueError("peer count must divide the mesh axis")
    rows = comm.rows_of if route == "sharded" else (lambda x: x)
    # the per-peer decisions: one launch on the K1 route's card
    step = fused_vector_step if route == "k1" else vector_step
    # where the merge builds a witness ladder, its tiles apply the cell
    # rules themselves (one op); a smaller tick keeps the pair
    fused = route == "k1" and uses_ladder(cfg.n, cfg.n)

    def body(state: WorldState, sched: Schedule, gdrop, qdrop, pdrop,
             phases, counts=None):
        t = state.tick
        v = step(t, sched.start_tick, sched.fail_tick, sched.rejoin_tick,
                 state.in_group, state.own_hb, state.joinreq, state.joinrep,
                 qdrop, pdrop, churn=churn,
                 flap=sched.flap_state(t) if flap else None)
        known, hb, ts = state.known, state.hb, state.ts
        if churn:   # a rejoining peer's row is wiped before the merge
            keep = ~rows(v.rejoining)[..., None]
            known, hb, ts = known & keep, hb * keep, ts * keep

        if fused:
            known, hb, ts, gossip_next, sent, recv, added, \
                removed = merge_epilogue(
                    state.gossip, v.proc, known, hb, ts, gdrop, v.ops,
                    v.jrep, v.jreq, v.hold, t, rows=(v.sent, v.recv),
                    t_remove=t_remove, with_events=with_events,
                    counts=counts)
            gossip_age = state.gossip_age
        elif route == "k1":
            # the two matrix phases (kernels on CUDA, plain on CPU);
            # gossip delivery is read inside them as gossip & proc, and
            # the epilogue adds the gossip counts onto the join rows
            m_all, m_fresh, t_fresh = masked_max3(
                state.gossip, v.proc, known, hb, ts, t, t_remove=t_remove,
                counts=counts)
            known, hb, ts, gossip_next, sent, recv, added, \
                removed = tick_epilogue(
                    m_all, m_fresh, t_fresh, state.gossip, v.proc, known,
                    hb, ts, gdrop, v.ops, v.jrep, v.jreq, v.hold, t,
                    t_remove=t_remove, with_events=with_events,
                    rows=(v.sent, v.recv))
            gossip_age = state.gossip_age
        else:
            if route == "sharded":
                out = _composable_phases(cfg, state, sched, v, known, hb, ts,
                                         gdrop, t, with_events, comm=comm)
            else:
                fn, scheds = phases
                if scheds is None:
                    raise ValueError("the composable worlds need the lanes' "
                                     "own schedules (lane_scheds)")
                out = fn(cfg, state, scheds, v, known, hb, ts, gdrop, t,
                         with_events)
            known, hb, ts, gossip_next, gossip_age, gsent_row, grecv_row, \
                added, removed = out
            # accounting (EmulNet.cpp:111,172)
            sent = (gsent_row + rows(v.sent)).to(torch.int32)
            recv = (grecv_row + rows(v.recv)).to(torch.int32)

        events = TickEvents(added=added, removed=removed, sent=sent,
                            recv=recv)
        new_state = WorldState(
            tick=t + 1, in_group=v.in_group, own_hb=v.own_hb, known=known,
            hb=hb, ts=ts, gossip=gossip_next, gossip_age=gossip_age,
            joinreq=v.joinreq, joinrep=v.joinrep, rng=state.rng)
        return new_state, events

    return body


def make_tick(cfg: SimConfig, with_events: bool = True,
              n_active: int | None = None, comm=None):
    """Build ``tick(state, sched) -> (state', TickEvents)`` for a config.

    ``n_active`` pins the drop-stream width: the Bernoulli lattice is
    drawn at ``n_active`` peers and embedded into the (N, N) masks, so a
    full-width tick can consume the active corner's stream
    (core/dense_corner.py) or a canonical rung its lanes' real-width
    stream (service/canonical.py).  Default: N.  ``comm`` makes the tick
    one shard of a peer-sharded run (module docstring); its tables,
    events and counters then hold the shard's rows.
    """
    n = cfg.n
    na = _stream_width(n, n_active)
    partition = cfg.partition_groups >= 2
    asym = cfg.asym_drop
    body = _make_body(cfg, with_events, comm)

    def tick(state: WorldState, sched: Schedule):
        t = state.tick
        # ENsend drop injection (EmulNet.cpp:90-94): one drop_masks
        # kernel launch on a card, the width-na draw embedded in it; the
        # asym world's per-link thresholds and the partition's
        # cross-group gate ride the same launch
        gdrop, qdrop, pdrop = tick_drop_masks(
            state.rng, t, n, sched.drop_on(t), sched.drop_prob, state.device,
            link_prob=sched.link_prob if asym else None, n_active=na,
            group=sched.part_group if partition else None,
            part_active=sched.part_active_at(t))
        return body(state, sched, gdrop, qdrop, pdrop,
                    (_composable_phases, sched))

    return tick


def _composable_phases(cfg: SimConfig, state: WorldState, sched: Schedule,
                       v, known, hb, ts, gdrop, t: int, with_events: bool,
                       comm=None):
    """The matrix phases of the composable route (JAX
    ``core/tick.py:180-196, 293-471``): ``masked_max3`` on what enters
    the merge (the forged planes, the delivered messages), the rest in
    torch.  ``known``/``hb``/``ts`` are the post-wipe tables.  Returns
    ``(known', hb', ts', gossip', gossip_age', gsent_row, grecv_row,
    added, removed)``.

    ``comm`` (parallel/comm.py; default one device) places the tables:
    under a ``RingComm`` they hold the shard's rows, which carry their
    global ids (``comm.row_ids``) for the self diagonal and the
    introducer row, delivery crosses the shards through
    ``comm.transpose``, the merge is the ring of ``comm.merge_reduce``
    and the introducer's row goes through ``comm.or_across``.  ``gdrop``
    and every per-peer vector are the whole-width ones.  Every tensor
    may carry a leading lane axis (a fleet, with the schedule stacked).
    """
    from ..parallel.comm import LocalComm
    comm = comm or LocalComm()
    n = cfg.n
    dev = known.device
    t_remove = cfg.t_remove
    zombie, byz = cfg.zombie, cfg.byz_rate > 0
    latency = cfg.link_latency > 0
    idx = torch.arange(n, device=dev)
    row_ids = comm.row_ids(n, dev)                       # global ids
    self_mask = row_ids[:, None] == idx[None, :]
    is_intro = idx == INTRODUCER
    is_intro_row = row_ids == INTRODUCER
    rows = comm.rows_of

    # ---- phase A: the messages consumed this tick ([s, r]) -----------
    if latency:
        # a message sent at t0 carries age t - t0 - 1; it delivers once
        # it has been in flight lat(s, r) ticks; undelivered ones keep
        # aging, one in flight a link; traffic to failed receivers rots
        age1 = state.gossip_age + 1
        deliver = state.gossip & (age1 >= comm.slice_rows(sched.link_lat)) \
            & v.proc[..., None, :]
        held = state.gossip & ~deliver & ~v.failed[..., None, :]
    else:
        deliver = state.gossip & v.proc[..., None, :]
    recv_from = comm.transpose(deliver)                  # [r, s]
    dcred = recv_from

    # ---- the merge, on what liar senders present (byz) ---------------
    if byz:
        liar = rows(sched.byz_mask)[..., :, None]
        f_known = known | comm.slice_rows(sched.byz_target)
        f_hb = torch.where(liar, hb + sched.byz_boost, hb)
        f_ts = torch.where(liar, torch.full_like(ts, t - 1), ts)
    else:
        f_known, f_hb, f_ts = known, hb, ts
    m_all, m_fresh, t_fresh = comm.merge_reduce(
        recv_from, f_known, f_hb, f_ts, t, t_remove=t_remove)
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
        # t - age1, per (sender, receiver) cell of the sender-major rows
        sent_t = t - age1
        zbad = (sent_t > rows(sched.fail_tick)[..., :, None]) \
            & (sent_t <= rows(sched.rejoin_tick)[..., :, None])
        dcred = dcred & ~comm.transpose(zbad)
    elif zombie:
        dcred = dcred & ~sched.window_failed_at(t - 1)[..., None, :]
    dinc = dcred & known_pb
    hb1 = torch.where(dinc, hb1 + 1, hb1)
    ts1 = torch.where(dinc, t, ts1)
    dadd = dcred & ~known_pb & ~self_mask
    hb1 = torch.where(dadd, 1, hb1)
    ts1 = torch.where(dadd, t, ts1)
    known1 = exists | padd | dadd

    # ---- JOINREQ at the introducer, JOINREP at the joiner ------------
    intro_row = comm.or_across((known1 & is_intro_row[:, None]).any(-2))
    qadd = v.jreq & ~intro_row & ~is_intro
    q_cell = is_intro_row[:, None] & qadd[..., None, :]
    known1 = known1 | q_cell
    hb1 = torch.where(q_cell, 1, hb1)
    ts1 = torch.where(q_cell, t, ts1)
    r_cell = (rows(v.jrep) & ~known1[..., :, INTRODUCER])[..., :, None] \
        & is_intro
    known1 = known1 | r_cell
    hb1 = torch.where(r_cell, 1, hb1).to(torch.int32)
    ts1 = torch.where(r_cell, t, ts1).to(torch.int32)

    # ---- detection and dissemination ---------------------------------
    ops_rows = rows(v.ops)
    stale = ops_rows[..., :, None] & known1 & (t - ts1 >= t_remove)
    known2 = known1 & ~stale
    send_rows = ops_rows
    if zombie:
        # window-failed peers that were in the group keep gossiping
        # their frozen tables
        send_rows = send_rows | rows(sched.window_failed_at(t) & v.in_group)
    gossip_sent = send_rows[..., :, None] & known2 & ~comm.slice_rows(gdrop)
    if latency:
        # one message in flight a link: a busy link skips this send
        gossip_sent = gossip_sent & ~held
        gossip_next = gossip_sent | held
        gossip_age = torch.where(held, age1, 0).to(torch.int32)
    else:
        gossip_next = gossip_sent | (state.gossip & v.hold[..., None, :])
        gossip_age = state.gossip_age
    sent_row = gossip_sent.sum(-1, dtype=torch.int32)
    recv_row = recv_from.sum(-1, dtype=torch.int32)
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
        count_launch(composable_lanes, "calls")
    return tuple(None if col[0] is None else torch.stack(col)
                 for col in zip(*outs))


composable_lanes.calls = 0


def make_fleet_tick(cfg: SimConfig, with_events: bool = True,
                    n_active: int | None = None, comm=None):
    """Build ``tick(states, sched, drop, lane_scheds=None, counts=None)
    -> (states', TickEvents)`` over B lanes at one shared clock.

    ``states`` is a stacked :class:`WorldState` (one host clock, tensors
    [B, ...], ``rng`` uint32[B, 2]); ``sched`` a stacked
    :class:`Schedule` (columns [B, N], planes [B, N, N]; its scalars are
    config values every lane shares); ``drop`` the fleet's
    :class:`~..ops.drop.LaneDrop` (each lane's key, probability and
    windows); ``lane_scheds`` the B per-lane schedules, which only the
    composable worlds read.  Events come back as [B, N, N] masks and
    [B, N] counters.  Each lane equals :func:`make_tick` of its own
    state and schedule, bit for bit.  ``comm`` makes it one peer shard
    of each lane (a fleet on a 2-D lanes x peers mesh): the composable
    route over the stacked schedule, every lane at once, with the lane
    axis of the rectangular ``masked_max3``.  ``counts`` (CUDA i64[B,
    2]) goes to the K1 route's merge, which adds each lane's
    plane descents and fallbacks onto it; the other routes ignore it.
    """
    n = cfg.n
    na = _stream_width(n, n_active)
    partition = cfg.partition_groups >= 2
    asym = cfg.asym_drop
    body = _make_body(cfg, with_events, comm)

    def tick(state: WorldState, sched: Schedule, drop, lane_scheds=None,
             counts=None):
        # one launch for every lane's draw
        gdrop, qdrop, pdrop = drop_masks_lanes(
            drop, state.tick, n, na, device=state.device,
            link_prob=sched.link_prob if asym else None,
            group=sched.part_group if partition else None)
        return body(state, sched, gdrop, qdrop, pdrop,
                    (composable_lanes, lane_scheds), counts)

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

"""One dense simulation tick, and the whole-run routing.

Counterpart of ``gossip_protocol_tpu/core/tick.py`` (single device; the
sharded ``RingComm`` path is not ported yet).  The tick's semantics,
and why it can be computed as order-free tensor algebra over the peer
axis, are documented there; this module keeps its order and formulas:
the per-peer vector decisions (start, JOINREQ/JOINREP, in_group, ops,
own_hb, the join accounting) in plain torch (``ops/vector.py``, shared
with K2's plain version), then the two matrix phases of the TPU's
fused path, each through a kernel wrapper:

* ``masked_max3`` (ops/merge.py) — the three gossip merge maxima;
* ``tick_epilogue`` (ops/cuda/tickfused.py, K1) — membership update,
  detection, dissemination and the per-row counters.

On a CUDA device those are the hand-written kernels, at every N (the
TPU's (8, 128) tiling gate of ``core/tick.py:138-141`` does not apply);
on the CPU their plain versions.  Nothing else forks on the device.

:func:`make_run` keeps the JAX routing precedence, corner -> mega ->
per-tick (``core/tick.py:529-573``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import SimConfig
from ..ops.cuda.tickfused import tick_epilogue
from ..ops.drop import tick_drop_masks
from ..ops.merge import masked_max3
from ..ops.vector import vector_step
from ..state import Schedule, WorldState


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
    (core/dense_corner.py).  Default: N.
    """
    n = cfg.n
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    t_remove = cfg.t_remove
    churn = cfg.rejoin_after is not None

    def tick(state: WorldState, sched: Schedule):
        t = state.tick
        dev = state.device

        # ENsend drop injection (EmulNet.cpp:90-94): one drop_masks
        # kernel launch on a card, the width-na draw embedded in it
        gdrop, qdrop, pdrop = tick_drop_masks(
            state.rng, t, n, sched.drop_on(t), sched.drop_prob, dev,
            n_active=na)

        v = vector_step(t, sched.start_tick, sched.fail_tick,
                        sched.rejoin_tick, state.in_group, state.own_hb,
                        state.joinreq, state.joinrep, qdrop, pdrop,
                        churn=churn)
        known, hb, ts = state.known, state.hb, state.ts
        if churn:   # a rejoining peer's row is wiped before the merge
            keep = ~v.rejoining[:, None]
            known, hb, ts = known & keep, hb * keep, ts * keep

        # the two matrix phases (kernels on CUDA, plain on CPU); gossip
        # delivery is read inside them as gossip & proc
        m_all, m_fresh, t_fresh = masked_max3(
            state.gossip, v.proc, known, hb, ts, t, t_remove=t_remove)
        known, hb, ts, gossip_next, gsent_row, grecv_row, added, removed = \
            tick_epilogue(m_all, m_fresh, t_fresh, state.gossip, v.proc,
                          known, hb, ts, gdrop, v.ops, v.jrep,
                          v.jreq, v.hold, t, t_remove=t_remove,
                          with_events=with_events)

        # accounting (EmulNet.cpp:111,172)
        events = TickEvents(added=added, removed=removed,
                            sent=(gsent_row + v.sent).to(torch.int32),
                            recv=(grecv_row + v.recv).to(torch.int32))
        new_state = WorldState(
            tick=t + 1, in_group=v.in_group, own_hb=v.own_hb, known=known,
            hb=hb, ts=ts, gossip=gossip_next, gossip_age=state.gossip_age,
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

"""Host harness for the dense megakernel K2 (ops/cuda/dense_mega.py).

Counterpart of ``gossip_protocol_tpu/core/dense_mega.py``: packs the
state and the schedule columns into K2's planes (``aux`` i32[N, 8]),
draws each launch's drop stack from the shared threefry stream in one
``drop_masks`` call, runs whole ``dense_mega_ticks_for(N)``-tick
launches plus a remainder launch, and returns the ``make_run``
contract ``(final_state, TickEvents)``.
Bit-identical to the per-tick path (tests/test_torch_dense_mega.py).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops.cuda.dense_mega import (DENSE_MEGA_N_LIMIT,
                                   DENSE_MEGA_N_LIMIT_BENCH,
                                   dense_mega_ticks, dense_mega_ticks_for)
from ..ops.drop import drop_masks
from ..state import Schedule, WorldState
from .tick import TickEvents


def dense_mega_supported(cfg: SimConfig, with_events: bool = False) -> bool:
    """The megakernel envelope, kept from the TPU (``core/dense_mega.py:32``)
    so both packages route the same configs through K2.  The port's
    config refuses every adversarial world, so no world gate is needed."""
    limit = DENSE_MEGA_N_LIMIT if with_events else DENSE_MEGA_N_LIMIT_BENCH
    return 16 <= cfg.n <= limit and cfg.n % 8 == 0


def drop_stack(rng, t0: int, s_ticks: int, n: int, sched: Schedule, device):
    """The launch's drop decisions: gossip bool[S, N, N] (sender-major),
    JOINREQ / JOINREP bool[S, N] — one ops/drop.py ``drop_masks`` call
    (one kernel launch on a card) for all S ticks."""
    return drop_masks(rng, t0, [sched.drop_on(t0 + s) for s in
                                range(s_ticks)], sched.drop_prob, n,
                      device=device)


def pack_aux(state: WorldState, sched: Schedule):
    """K2's per-peer lanes, i32[N, 8]: in_group, own_hb, joinreq,
    joinrep, start, fail, rejoin, and a zero pad lane."""
    i32 = torch.int32
    return torch.stack([
        state.in_group.to(i32), state.own_hb.to(i32),
        state.joinreq.to(i32), state.joinrep.to(i32),
        sched.start_tick.to(i32), sched.fail_tick.to(i32),
        sched.rejoin_tick.to(i32),
        torch.zeros(state.n, dtype=i32, device=state.device)],
        dim=1).contiguous()


def make_dense_mega_run(cfg: SimConfig, with_events: bool = False):
    """``run(state, sched) -> (final, TickEvents)`` over ``cfg.total_ticks``
    ticks from the state's clock, in K2 launches."""
    if not dense_mega_supported(cfg, with_events):
        raise ValueError(f"n={cfg.n} is outside the megakernel envelope")
    n = cfg.n
    s_full = dense_mega_ticks_for(n)
    n_chunks, rem = divmod(cfg.total_ticks, s_full)
    kern_kw = dict(n=n, t_remove=cfg.t_remove,
                   can_rejoin=cfg.rejoin_after is not None,
                   with_events=with_events)

    def run(state: WorldState, sched: Schedule):
        i32 = torch.int32
        dev = state.device
        aux = pack_aux(state, sched)
        known, hb, ts = state.known.to(i32), state.hb, state.ts
        gossip = state.gossip.to(i32)
        t = state.tick
        sents, recvs, addeds, removeds = [], [], [], []
        for s_ticks in [s_full] * n_chunks + ([rem] if rem else []):
            g, q, p = drop_stack(state.rng, t, s_ticks, n, sched, dev)
            out = dense_mega_ticks(known, hb, ts, gossip, aux, g, q, p, t,
                                   s_ticks=s_ticks, **kern_kw)
            known, hb, ts, gossip, aux, sent, recv = out[:7]
            sents.append(sent)
            recvs.append(recv)
            if with_events:
                addeds.append(out[7] > 0)
                removeds.append(out[8] > 0)
            t += s_ticks

        def cat(xs, shape, dtype):
            return torch.cat(xs) if xs else torch.zeros(
                shape, dtype=dtype, device=dev)

        sent = cat(sents, (0, n), i32)
        recv = cat(recvs, (0, n), i32)
        if with_events:
            added = cat(addeds, (0, n, n), torch.bool)
            removed = cat(removeds, (0, n, n), torch.bool)
        else:
            added = removed = torch.zeros((sent.shape[0],), dtype=torch.bool,
                                          device=dev)
        final = WorldState(
            tick=t, in_group=aux[:, 0] > 0, own_hb=aux[:, 1].contiguous(),
            known=known > 0, hb=hb, ts=ts, gossip=gossip > 0,
            gossip_age=state.gossip_age, joinreq=aux[:, 2] > 0,
            joinrep=aux[:, 3] > 0, rng=state.rng)
        return final, TickEvents(added=added, removed=removed, sent=sent,
                                 recv=recv)

    return run

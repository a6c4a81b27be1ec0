"""Static active-corner reduction for the dense model (bench mode).

Counterpart of ``gossip_protocol_tpu/core/dense_corner.py``, whose
docstring gives the argument: start ticks are nondecreasing in the peer
index, so the peers that can act within a run are the prefix ``[0, A)``
with ``A`` derived from the config alone, and every state row/column
``>= A`` stays zero for the whole run.  A bench run therefore executes
on the leading ``A x A`` corner and embeds the result back.

The corner draws its drop stream at width ``A`` — a different, equally
seeded realization of the drop process than a full-width run of the
same seed whenever ``A < N`` (``bench_stream_width`` says which).
Inside the corner the megakernel route applies when ``A`` fits its
bench envelope (A = 896 for N=4096 / 200 ticks); otherwise the
per-tick path runs at width ``A`` (A = 2816 for N=4096 / 700 ticks).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import Schedule, WorldState, slice_schedule


def active_bound(cfg: SimConfig) -> int:
    """Smallest peer count covering every peer that can ever act, padded
    to a multiple of 128 and capped at N (``dense_corner.py:51``)."""
    n, total = cfg.n, cfg.total_ticks
    if cfg.has_worlds or cfg.step_rate < 0:
        return n
    if (cfg.rejoin_after is not None
            and cfg.fail_tick + cfg.rejoin_after < total):
        return n
    if total > 0 and cfg.start_tick(n - 1) < total:
        return n
    lo, hi = 0, n - 1          # invariant: start_tick(hi) >= total
    while lo < hi:
        mid = (lo + hi) // 2
        if cfg.start_tick(mid) >= total:
            hi = mid
        else:
            lo = mid + 1
    return min(n, -(-lo // 128) * 128)


def bench_stream_width(cfg: SimConfig) -> int:
    """Width at which a bench-mode run draws its drop stream."""
    a = active_bound(cfg)
    return a if 0 < a < cfg.n else cfg.n


def _slice_state(state: WorldState, a: int) -> WorldState:
    return state.replace(
        in_group=state.in_group[:a], own_hb=state.own_hb[:a],
        known=state.known[:a, :a].contiguous(),
        hb=state.hb[:a, :a].contiguous(), ts=state.ts[:a, :a].contiguous(),
        gossip=state.gossip[:a, :a].contiguous(),
        gossip_age=state.gossip_age[:a, :a].contiguous(),
        joinreq=state.joinreq[:a], joinrep=state.joinrep[:a])


def _embed_state(state_a: WorldState, n: int) -> WorldState:
    a = state_a.n

    def vec(v):
        out = torch.zeros((n,), dtype=v.dtype, device=v.device)
        out[:a] = v
        return out

    def plane(p):
        out = torch.zeros((n, n), dtype=p.dtype, device=p.device)
        out[:a, :a] = p
        return out

    return state_a.replace(
        in_group=vec(state_a.in_group), own_hb=vec(state_a.own_hb),
        known=plane(state_a.known), hb=plane(state_a.hb),
        ts=plane(state_a.ts), gossip=plane(state_a.gossip),
        gossip_age=plane(state_a.gossip_age),
        joinreq=vec(state_a.joinreq), joinrep=vec(state_a.joinrep))


def make_corner_run(cfg: SimConfig, a: int):
    """Bench-mode ``run(state, sched) -> (final, TickEvents)`` over
    full-width arrays, executed on the ``a x a`` corner.  Valid only
    from tick 0 (the bound spans the whole horizon); raises otherwise."""
    from .dense_mega import dense_mega_supported, make_dense_mega_run
    from .tick import TickEvents, make_tick_run

    n = cfg.n
    if not (0 < a < n and a % 8 == 0):
        raise ValueError(f"corner width {a} invalid for n={n}")
    cfg_a = cfg.replace(max_nnb=a)
    if dense_mega_supported(cfg_a):
        inner = make_dense_mega_run(cfg_a, with_events=False)
    else:
        inner = make_tick_run(cfg_a, with_events=False)

    def run(state: WorldState, sched: Schedule):
        if state.tick != 0:
            raise ValueError(
                f"active-corner run requires a tick-0 start (the bound "
                f"spans the whole {cfg.total_ticks}-tick horizon), got "
                f"tick {state.tick}")
        final_a, ev = inner(_slice_state(state, a), slice_schedule(sched, a))
        pad = (0, n - a)
        ev = TickEvents(added=ev.added, removed=ev.removed,
                        sent=torch.nn.functional.pad(ev.sent, pad),
                        recv=torch.nn.functional.pad(ev.recv, pad))
        return _embed_state(final_a, n), ev

    return run

"""The per-peer decisions of one dense tick, in one place.

Everything a tick decides per peer around its two matrix phases: who
processes this tick (``proc``), the churn restart, the JOINREQ/JOINREP
traffic consumed and sent, group membership, who runs its periodic ops,
the own heartbeat, the JOINREQ/JOINREP left in flight, and the join
share of the tick's send/receive counters (EmulNet.cpp:111,172).

Counterpart of the vector part of ``gossip_protocol_tpu/core/tick.py``
``make_tick`` and of ``ops/pallas/dense_mega.py:146-207, 271-280``.
The per-tick path (core/tick.py) and K2's plain version
(ops/cuda/dense_mega.py) both call :func:`vector_step`; K2's CUDA
``mega_vec_kernel`` (csrc/dense_tick.cu) computes the same per peer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import INTRODUCER


@dataclass
class VectorStep:
    """Per-peer results of :func:`vector_step`, bool[N] unless noted."""

    proc: torch.Tensor          # consumes and acts this tick
    failed: torch.Tensor        # failed while processing this tick
    rejoining: torch.Tensor     # wiped and re-introduced this tick
    jreq: torch.Tensor          # JOINREQ consumed by the introducer
    jrep: torch.Tensor          # JOINREP consumed
    hold: torch.Tensor          # not processing, not failed: in-flight held
    ops: torch.Tensor           # runs its periodic ops (proc & in_group)
    in_group: torch.Tensor      # next in_group
    own_hb: torch.Tensor        # i32[N] next own heartbeat
    joinreq: torch.Tensor       # next JOINREQ in flight
    joinrep: torch.Tensor       # next JOINREP in flight
    sent: torch.Tensor          # i32[N] join messages sent
    recv: torch.Tensor          # i32[N] join messages received


def vector_step(t: int, start, fail, rejoin, in_group, own_hb, joinreq,
                joinrep, qdrop, pdrop, *, churn: bool,
                flap=None) -> VectorStep:
    """The per-peer decisions of tick ``t``.

    ``start``/``fail``/``rejoin`` are the schedule's i32[N] columns;
    ``in_group``/``own_hb``/``joinreq``/``joinrep`` the state's; ``qdrop``
    / ``pdrop`` bool[N] the tick's JOINREQ / JOINREP drop decisions.
    Without ``churn`` no peer rejoins.  ``flap`` is the flap world's
    ``(down, up_edge)`` bool[N] at ``t`` (``Schedule.flap_state``): its
    down phases add to ``failed`` and its up-edges rejoin (JAX
    ``state.py`` ``failed_at`` / ``rejoining_at``); the flap world sets
    ``churn``.
    """
    i32 = torch.int32
    n = start.shape[0]
    is_intro = torch.arange(n, device=start.device) == INTRODUCER
    failed = (t > fail) & (t <= rejoin)
    if flap is not None:
        failed = failed | flap[0]
    # recvLoop/nodeLoop gate (Application.cpp:130,153)
    proc = (t > start) & ~failed
    # churn: a rejoining peer restarts from a fresh nodeStart
    rejoining = (rejoin == t) if churn else torch.zeros_like(proc)
    if flap is not None:
        rejoining = rejoining | flap[1]
    in_group0 = in_group & ~rejoining
    own_hb0 = own_hb * ~rejoining
    proc0, failed0 = proc[INTRODUCER], failed[INTRODUCER]

    # the join traffic consumed this tick
    jreq = joinreq & proc0
    jrep = joinrep & proc

    # nodeStart + per-tick vector decisions
    starting = (t == start) | rejoining
    joinreq_new = starting & ~is_intro
    in_group_next = in_group0 | jrep | (starting & is_intro)
    ops = proc & in_group_next
    own_hb_next = (own_hb0 + ops.to(i32)).to(i32)

    # ENsend drop injection (EmulNet.cpp:90-94); undelivered messages
    # stay in flight while their receiver is not processing
    joinreq_sent = joinreq_new & ~qdrop
    joinrep_sent = jreq & ~pdrop
    hold = ~proc & ~failed
    joinreq_next = joinreq_sent | (joinreq & ~proc0 & ~failed0)
    joinrep_next = joinrep_sent | (joinrep & hold)

    sent = (joinreq_sent.to(i32)
            + torch.where(is_intro, joinrep_sent.sum(dtype=i32), 0)).to(i32)
    recv = (jrep.to(i32)
            + torch.where(is_intro, jreq.sum(dtype=i32), 0)).to(i32)
    return VectorStep(proc=proc, failed=failed, rejoining=rejoining,
                      jreq=jreq, jrep=jrep,
                      hold=hold, ops=ops, in_group=in_group_next,
                      own_hb=own_hb_next, joinreq=joinreq_next,
                      joinrep=joinrep_next, sent=sent, recv=recv)

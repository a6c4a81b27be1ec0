"""The per-peer decisions of one dense tick, in one place.

Everything a tick decides per peer around its two matrix phases: who
processes this tick (``proc``), the churn restart, the JOINREQ/JOINREP
traffic consumed and sent, group membership, who runs its periodic ops,
the own heartbeat, the JOINREQ/JOINREP left in flight, and the join
share of the tick's send/receive counters (EmulNet.cpp:111,172).

Counterpart of the vector part of ``gossip_protocol_tpu/core/tick.py``
``make_tick`` and of ``ops/pallas/dense_mega.py:146-207, 271-280``.
:func:`vector_step` is the plain version: the composable worlds, the
peer-sharded tick and K2's plain version (ops/cuda/dense_mega.py) call
it.  The K1 route (solo and fleet ticks) calls :func:`fused_vector_step`,
which on a card is one launch of ``vector_step_kernel``
(csrc/dense_tick.cu) for every lane; K2's CUDA vector step applies the
same per-peer rule (``peer_step``).
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

    Every per-peer argument may carry a leading lane axis ([B, N], a
    fleet at the shared clock ``t``): the decisions broadcast over it,
    lane for lane the same bits as the solo step.
    """
    i32 = torch.int32
    n = start.shape[-1]
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
    # the introducer's gates, [..., 1] so they broadcast over each lane
    proc0 = proc[..., INTRODUCER, None]
    failed0 = failed[..., INTRODUCER, None]

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
            + torch.where(is_intro, joinrep_sent.sum(-1, keepdim=True,
                                                     dtype=i32), 0)).to(i32)
    recv = (jrep.to(i32)
            + torch.where(is_intro, jreq.sum(-1, keepdim=True, dtype=i32),
                          0)).to(i32)
    return VectorStep(proc=proc, failed=failed, rejoining=rejoining,
                      jreq=jreq, jrep=jrep,
                      hold=hold, ops=ops, in_group=in_group_next,
                      own_hb=own_hb_next, joinreq=joinreq_next,
                      joinrep=joinrep_next, sent=sent, recv=recv)


#: the kernel's output lanes, in the order of csrc/dense_tick.cu's S_*
#: (bytes) and I_* (words) enums
BYTE_LANES = ("proc", "failed", "rejoining", "jreq", "jrep", "hold", "ops",
              "in_group", "joinreq", "joinrep")
WORD_LANES = ("own_hb", "sent", "recv")


def fused_vector_step(t: int, start, fail, rejoin, in_group, own_hb, joinreq,
                      joinrep, qdrop, pdrop, *, churn: bool,
                      flap=None) -> VectorStep:
    """:func:`vector_step` as one kernel launch on a card, for B lanes
    ([B, N] arguments) or one ([N]).

    It replaces no TPU kernel (the JAX package's vector step is XLA); it
    exists for the host's launch budget: the plain step is ~50 elementwise
    launches and two sums a tick, which pace a dense fleet's host.  The
    results are :func:`vector_step`'s bit for bit; ``sent`` / ``recv``
    are the join share of the tick's rows, which ``tick_epilogue(rows=)``
    completes.  ``churn`` and ``flap`` select the kernel's template flags.
    CPU tensors take :func:`vector_step`; CUDA tensors launch the kernel
    (or raise).  Counts every call on ``fused_vector_step.calls`` and
    every launch on ``.launches``.
    """
    from .cuda._build import (check, check_args, count_launch, library,
                              ptr, stream_ptr)
    count_launch(fused_vector_step, "calls")
    if in_group.device.type == "cpu":
        return vector_step(t, start, fail, rejoin, in_group, own_hb, joinreq,
                           joinrep, qdrop, pdrop, churn=churn, flap=flap)
    shape = tuple(in_group.shape)
    n = shape[-1]
    b = shape[0] if len(shape) == 2 else 1
    i32, b8 = torch.int32, torch.bool
    down, up = (None, None) if flap is None else flap
    ins = (start, fail, rejoin, in_group, own_hb, joinreq, joinrep, qdrop,
           pdrop) + (() if flap is None else flap)
    check_args("fused_vector_step", *zip(
        ins, (i32, i32, i32, b8, i32) + (b8,) * 6, (shape,) * len(ins)))
    dev = in_group.device
    out = torch.empty((len(BYTE_LANES),) + shape, dtype=b8, device=dev)
    iout = torch.empty((len(WORD_LANES),) + shape, dtype=i32, device=dev)
    code = library().gp_vector_step(
        ptr(start), ptr(fail), ptr(rejoin), ptr(in_group), ptr(own_hb),
        ptr(joinreq), ptr(joinrep), ptr(qdrop), ptr(pdrop), ptr(down),
        ptr(up), ptr(out), ptr(iout), n, b, int(t), int(churn),
        stream_ptr(dev))
    count_launch(fused_vector_step)
    check(code, "fused_vector_step")
    return VectorStep(**dict(zip(BYTE_LANES, out)),
                      **dict(zip(WORD_LANES, iout)))


fused_vector_step.launches = 0
fused_vector_step.calls = 0

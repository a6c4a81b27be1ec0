"""K2: S whole dense ticks per call (CUDA ``dense_mega_ticks``).

Replaces the TPU kernel ``gossip_protocol_tpu/ops/pallas/dense_mega.py``
``dense_mega_ticks`` (:302), with its contract: the four (N, N) state
planes and ``aux`` i32[N, 8] in, the same planes out, per-tick
``sent``/``recv`` i32[S, N], and in trace mode per-tick ``added``/
``removed`` int8[S, N, N] written to slot ``s``.  The launch's drop
decisions arrive precomputed (``gdrop`` bool[S, N, N], ``qdrop``/
``pdrop`` bool[S, N]) from the shared threefry stream.

The TPU kept the whole state in 110 MB of VMEM for the S ticks.  An
H100 SM has 227 KB of shared memory, so here the state stays in HBM
(the N=896 planes, about 9 MB, sit in the 50 MB L2) and a call is one
cooperative launch of a persistent grid (csrc/dense_tick.cu
``dense_mega_kernel``: as many blocks as fit on the card, capped by the
work) that runs the S ticks with grid barriers between their phases: a
one-block vector step (proc, JOINREQ/JOINREP, in_group, ops, own_hb,
the join accounting: the rules of ``ops/vector.py``, which the plain
version calls), the churn wipe of rejoining rows with the merge prep,
the ``masked_max3`` descent tiles and the ``tick_epilogue`` tiles — the
same ``__device__`` tile functions as the per-tick kernels, so the cell
rules cannot drift apart.
"""

from __future__ import annotations

import torch

from ..merge import masked_max3_plain
from ..vector import vector_step
from ._build import (check, check_args, count_launch, library, ptr,
                     stream_ptr)
from .tickfused import tick_epilogue_plain

#: dense ticks per launch (halved above 512 peers, as on the TPU, whose
#: VMEM bounded the (S, N, N) drop stack; kept so both packages launch
#: the same shapes)
DENSE_MEGA_TICKS = 16

#: envelope of the megakernel path (trace / bench mode), kept from the
#: TPU so that both packages route the same configs through K2
DENSE_MEGA_N_LIMIT = 512
DENSE_MEGA_N_LIMIT_BENCH = 1024

#: aux lane offsets
_IN_GROUP, _OWN_HB, _JOINREQ, _JOINREP, _START, _FAIL, _REJOIN = range(7)
DENSE_AUX_LANES = 8
_VEC_LANES = 6   # proc, ops, jrep, jreq, hold, rejoining (csrc)


def dense_mega_ticks_for(n: int) -> int:
    """Ticks per launch for a peer count."""
    return DENSE_MEGA_TICKS if n <= DENSE_MEGA_N_LIMIT \
        else DENSE_MEGA_TICKS // 2


def dense_mega_ticks_plain(known, hb, ts, gossip, aux, gdrop, qdrop, pdrop,
                           sp, *, n: int, s_ticks: int, t_remove: int,
                           can_rejoin: bool, with_events: bool = False):
    """Plain PyTorch version of :func:`dense_mega_ticks`: per tick the
    shared ``vector_step`` on the aux lanes, the churn wipe,
    ``masked_max3_plain`` and ``tick_epilogue_plain``."""
    i32 = torch.int32
    t0 = int(sp)
    known_b, gossip_b = known > 0, gossip > 0
    dev = known.device
    sent = torch.empty((s_ticks, n), dtype=i32, device=dev)
    recv = torch.empty((s_ticks, n), dtype=i32, device=dev)
    added, removed = [], []
    for s in range(s_ticks):
        t = t0 + s
        v = vector_step(t, aux[:, _START], aux[:, _FAIL], aux[:, _REJOIN],
                        aux[:, _IN_GROUP] > 0, aux[:, _OWN_HB],
                        aux[:, _JOINREQ] > 0, aux[:, _JOINREP] > 0,
                        qdrop[s], pdrop[s], churn=can_rejoin)
        aux = torch.stack([v.in_group.to(i32), v.own_hb,
                           v.joinreq.to(i32), v.joinrep.to(i32),
                           aux[:, _START], aux[:, _FAIL], aux[:, _REJOIN],
                           aux[:, 7]], dim=1)
        if can_rejoin:
            keep = ~v.rejoining[:, None]
            known_b = known_b & keep
            hb = hb * keep
            ts = ts * keep
        m_a, m_f, m_t = masked_max3_plain(gossip_b, v.proc, known_b, hb,
                                          ts, t, t_remove=t_remove)
        known_b, hb, ts, gossip_b, srow, rrow, add, rem = tick_epilogue_plain(
            m_a, m_f, m_t, gossip_b, v.proc, known_b, hb, ts, gdrop[s],
            v.ops, v.jrep, v.jreq, v.hold, t, t_remove=t_remove,
            with_events=with_events)
        sent[s] = v.sent + srow
        recv[s] = v.recv + rrow
        if with_events:
            added.append(add.to(torch.int8))
            removed.append(rem.to(torch.int8))
    out = (known_b.to(torch.int32), hb.to(torch.int32), ts.to(torch.int32),
           gossip_b.to(torch.int32), aux, sent, recv)
    if with_events:
        out += (torch.stack(added), torch.stack(removed))
    return out


def dense_mega_ticks(known, hb, ts, gossip, aux, gdrop, qdrop, pdrop, sp, *,
                     n: int, s_ticks: int, t_remove: int, can_rejoin: bool,
                     with_events: bool = False,
                     grid_blocks: int | None = None):
    """Run ``s_ticks`` whole dense ticks from clock ``sp`` (an int: the
    TPU kernel's i32[1] scalar-prefetch array becomes a launch argument).

    Args and returns as ``gossip_protocol_tpu.ops.pallas.dense_mega.
    dense_mega_ticks``: ``(known', hb', ts', gossip', aux', sent, recv)``
    plus ``(added, removed)`` int8[S, N, N] with ``with_events``.  The
    inputs are not modified.  CPU tensors take
    :func:`dense_mega_ticks_plain`; CUDA tensors launch the kernel once
    (or raise).  ``grid_blocks`` sets the persistent grid's size, for
    tests (default: as many blocks as fit on the card, capped by the
    work); a grid that cannot be co-resident raises.
    """
    if known.shape != (n, n):
        raise ValueError(f"state planes must be ({n}, {n}), got "
                         f"{tuple(known.shape)}")
    if known.device.type == "cpu":
        return dense_mega_ticks_plain(
            known, hb, ts, gossip, aux, gdrop, qdrop, pdrop, sp, n=n,
            s_ticks=s_ticks, t_remove=t_remove, can_rejoin=can_rejoin,
            with_events=with_events)
    t0 = int(sp)
    i32, plane = torch.int32, (n, n)
    check_args("dense_mega_ticks", (known, i32, plane), (hb, i32, plane),
               (ts, i32, plane), (gossip, i32, plane),
               (aux, i32, (n, DENSE_AUX_LANES)),
               (gdrop, torch.bool, (s_ticks, n, n)),
               (qdrop, torch.bool, (s_ticks, n)),
               (pdrop, torch.bool, (s_ticks, n)))
    dev = known.device
    known_b = (known != 0).contiguous()       # fresh buffers: updated in place
    gossip_b = (gossip != 0).contiguous()
    hb_w, ts_w, aux_w = hb.clone(), ts.clone(), aux.clone()
    gossip_tmp = torch.empty_like(gossip_b)
    sent = torch.empty((s_ticks, n), dtype=torch.int32, device=dev)
    recv = torch.empty((s_ticks, n), dtype=torch.int32, device=dev)
    if with_events:
        added = torch.empty((s_ticks, n, n), dtype=torch.int8, device=dev)
        removed = torch.empty((s_ticks, n, n), dtype=torch.int8, device=dev)
    else:
        added = removed = None
    lib = library()
    m_scratch = torch.empty(3 * n * n + lib.gp_merge_scratch_words(n, n),
                            dtype=torch.int32, device=dev)
    # the vector lanes of two tick parities
    vec_scratch = torch.empty(2 * _VEC_LANES * n, dtype=torch.uint8,
                              device=dev)
    code = lib.gp_dense_mega_ticks(
        ptr(known_b), ptr(hb_w), ptr(ts_w), ptr(gossip_b), ptr(gossip_tmp),
        ptr(aux_w), ptr(gdrop), ptr(qdrop), ptr(pdrop), ptr(sent), ptr(recv),
        ptr(added), ptr(removed), ptr(m_scratch), ptr(vec_scratch), n,
        s_ticks, t0, int(t_remove), int(can_rejoin), int(grid_blocks or 0),
        stream_ptr(dev))
    count_launch(dense_mega_ticks)
    check(code, "dense_mega_ticks")
    out = (known_b.to(torch.int32), hb_w, ts_w, gossip_b.to(torch.int32),
           aux_w, sent, recv)
    if with_events:
        out += (added, removed)
    return out


dense_mega_ticks.launches = 0

"""K1: the dense tick's post-merge epilogue (CUDA ``tick_epilogue`` kernel).

Replaces the TPU kernel ``gossip_protocol_tpu/ops/pallas/tickfused.py``
``fused_tick_update`` (:137).  Per (receiver r, column j) cell, from the
three merge maxima (ops/merge.py ``masked_max3``) it applies, in order:
merge-into-existing, piggyback add, direct-sender increment/add,
JOINREQ at row 0, JOINREP at column 0, TREMOVE staleness, and
dissemination under the drop mask with the in-flight hold; per row it
counts gossip sent and received; in trace mode it also emits the
added/removed masks.

Contract differences from the TPU kernel, both about data movement:
the delivery is passed as ``gossip`` + ``proc`` (recv_from[r, s] is
``gossip[s, r] & proc[r]``, read transposed through shared memory in
the kernel) instead of a materialized ``recv_from``, the row's gossip
receive count comes back beside the sent count, and both are added onto
the rows the caller passes (the tick's join traffic, from the K1 route's
vector step).

On the H100 the kernel is bound by bytes (~36 per cell, see
csrc/dense_tick.cu): a 2-D grid of 32 x 128 tiles, 4 columns a thread
(16-byte / 4-byte accesses where N % 4 == 0), the row sums added with
one atomic per row and block onto the rows passed in.  Where the merge
builds its witness ladder (N > 1024) the tick runs the same cell rules
inside the merge's tiles instead (ops/merge.py ``merge_epilogue``).
"""

from __future__ import annotations

import torch

from ..detect import staleness_mask
from ._build import (check, check_args, count_launch, library, ptr,
                     stream_ptr)


def tick_epilogue_plain(m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts,
                        gdrop, ops, jrep, jreq, live_hold, t: int, *,
                        t_remove: int, with_events: bool = True):
    """Plain PyTorch version of the ``tick_epilogue`` kernel (the TPU
    kernel's body, ops/pallas/tickfused.py:67-132, on whole planes)."""
    n = known.shape[0]
    idx = torch.arange(n, device=known.device)
    self_mask = idx[:, None] == idx[None, :]
    is_row0 = (idx == 0)[:, None]
    is_col0 = (idx == 0)[None, :]
    dfull = gossip.t() & proc[:, None]                 # recv_from [r, s]
    exists = known
    anyf = t_fresh >= 0
    inc = exists & (m_all > hb)
    hb1 = torch.where(inc, m_all, hb)
    ts1 = torch.where(inc, t, ts)
    padd = ~exists & anyf & ~self_mask
    hb1 = torch.where(padd, m_all, hb1)
    ts1 = torch.where(padd, torch.where(m_all > m_fresh, t, t_fresh), ts1)
    known_pb = exists | padd
    dinc = dfull & known_pb
    hb1 = torch.where(dinc, hb1 + 1, hb1)
    ts1 = torch.where(dinc, t, ts1)
    dadd = dfull & ~known_pb & ~self_mask
    hb1 = torch.where(dadd, 1, hb1)
    ts1 = torch.where(dadd, t, ts1)
    known2 = exists | padd | dadd
    q_cell = is_row0 & jreq[None, :] & ~known2 & ~is_col0
    known3 = known2 | q_cell
    hb1 = torch.where(q_cell, 1, hb1)
    ts1 = torch.where(q_cell, t, ts1)
    r_cell = is_col0 & jrep[:, None] & ~known3
    known4 = known3 | r_cell
    hb1 = torch.where(r_cell, 1, hb1).to(torch.int32)
    ts1 = torch.where(r_cell, t, ts1).to(torch.int32)
    stale = staleness_mask(ops, known4, ts1, t, t_remove)
    known5 = known4 & ~stale
    gsent = ops[:, None] & known5 & ~gdrop
    gossip_next = gsent | (gossip & live_hold[None, :])
    sent_row = gsent.sum(1, dtype=torch.int32)
    recv_row = dfull.sum(1, dtype=torch.int32)
    if not with_events:
        return known5, hb1, ts1, gossip_next, sent_row, recv_row, None, None
    return (known5, hb1, ts1, gossip_next, sent_row, recv_row,
            known4 & ~exists, stale)


def tick_epilogue_lanes_plain(m_all, m_fresh, t_fresh, gossip, proc, known,
                              hb, ts, gdrop, ops, jrep, jreq, live_hold,
                              t: int, *, t_remove: int,
                              with_events: bool = True):
    """Plain version of the lane-axis ``tick_epilogue``: every input with
    a leading lane axis B, :func:`tick_epilogue_plain` applied lane by
    lane and each output stacked (None stays None)."""
    ins = (m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop, ops,
           jrep, jreq, live_hold)
    outs = [tick_epilogue_plain(*(x[b] for x in ins), t, t_remove=t_remove,
                                with_events=with_events)
            for b in range(known.shape[0])]
    return tuple(None if col[0] is None else torch.stack(col)
                 for col in zip(*outs))


def tick_epilogue(m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts,
                  gdrop, ops, jrep, jreq, live_hold, t: int, *,
                  rows, t_remove: int, with_events: bool = True):
    """One tick's post-merge update.

    Inputs: the merge maxima i32[N, N] (FILL=-1), ``gossip`` bool[N, N]
    in flight (sender, receiver), ``proc`` bool[N] receivers consuming
    this tick, the post-wipe ``known`` bool / ``hb``, ``ts`` i32 tables,
    this tick's gossip drop mask ``gdrop`` (sender-major), the row
    vectors ``ops``/``jrep`` and the column vectors ``jreq``/
    ``live_hold`` (bool[N]), and the clock ``t``.  With a leading lane
    axis on every input ([B, N, N] planes, [B, N] vectors) it updates B
    lanes of a fleet at the shared clock, in one launch on a card.

    ``rows`` is ``(sent, recv)`` i32 of the ``ops`` shape: the tick's
    rows so far (its join traffic, ``ops/vector.py fused_vector_step``),
    onto which the gossip counts are added; on a card the kernel adds in
    place, so the tensors passed come back as the rows.

    Returns ``(known', hb', ts', gossip', sent_row, recv_row, added,
    removed)``; the event masks are None without ``with_events``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    lanes = known.dim() == 3
    if known.device.type == "cpu":
        fn = tick_epilogue_lanes_plain if lanes else tick_epilogue_plain
        out = fn(m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop,
                 ops, jrep, jreq, live_hold, t, t_remove=t_remove,
                 with_events=with_events)
        return out[:4] + tuple((r + s).to(torch.int32)
                               for r, s in zip(out[4:6], rows)) + out[6:]
    n = known.shape[-1]
    b = known.shape[0] if lanes else 1
    dev = known.device
    ins = (m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop, ops,
           jrep, jreq, live_hold)
    sent_row, recv_row = rows
    lead = (b,) if lanes else ()
    i32, b8, plane, vec = torch.int32, torch.bool, lead + (n, n), lead + (n,)
    check_args("tick_epilogue", *zip(
        ins + (sent_row, recv_row),
        (i32, i32, i32, b8, b8, b8, i32, i32, b8, b8, b8, b8, b8, i32, i32),
        (plane,) * 4 + (vec,) + (plane,) * 4 + (vec,) * 6))

    def out(shape, dt):
        return torch.empty(shape, dtype=dt, device=dev)

    known_o, gossip_o = out(plane, torch.bool), out(plane, torch.bool)
    hb_o, ts_o = out(plane, torch.int32), out(plane, torch.int32)
    added = out(plane, torch.bool) if with_events else None
    removed = out(plane, torch.bool) if with_events else None
    code = library().gp_tick_epilogue(
        *(ptr(x) for x in ins), ptr(known_o), ptr(hb_o), ptr(ts_o),
        ptr(gossip_o), ptr(sent_row), ptr(recv_row), ptr(added),
        ptr(removed), n, b, int(t), int(t_remove), stream_ptr(dev))
    count_launch(tick_epilogue)
    check(code, "tick_epilogue")
    return known_o, hb_o, ts_o, gossip_o, sent_row, recv_row, added, removed


tick_epilogue.launches = 0

"""K3: one overlay tick's whole (N, K) phase (CUDA ``fused_overlay_tick``).

Replaces the TPU kernel ``gossip_protocol_tpu/ops/pallas/overlay_exchange.py``
``fused_overlay_tick`` (:267), with its single-device contract: the
accumulator init from the receiver's own (post-wipe) view, ``proc``
gating, F XOR-partner rounds (each a lane-aligned lexicographic
(key, payload) max over the partner's view plus its self-entry), the
JOINREP broadcast merge, the JOINREQ row-0 aggregate merge, winner
extraction, TREMOVE detection with the subjects' fail/rejoin computed
in-kernel, and the per-row counters [recv, removals, false_removals,
victim_slots, adds, view_slots].  The sharded arguments of the TPU
kernel (``masks_local``, ``row_start``, ``aux_rounds``, ``pw_rounds``)
wait for the multi-device slice.

The TPU kernel folded the high mask bits into its block index map and
ran a butterfly in VMEM for the low ones.  On the H100 a partner row
``r ^ m`` is a direct global load: one warp owns a row, its lanes the K
slots.  A row waits on two dependent round trips: its own words beside
the F partners' round flags (one lane a partner), then the views of
every flagged partner, four at a time, before it merges them
(csrc/overlay_tick.cu).  Every value is an integer, so the kernel and
:func:`fused_overlay_tick_plain` agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.hash32 import MASK32
from ..overlay_rules import (ID_MASK, SLOT_EPOCH, OverlaySchedule, lex_max,
                             merge_entry, merge_view, pack_key)
from ._build import check, check_args, library, ptr, stream_ptr

#: per-row counters: recv, removals, false_removals, victim_slots, adds,
#: view_slots
N_COUNTERS = 6
#: kernel limits (csrc/overlay_tick.cu MAX_K, MAX_F)
MAX_K = 128
MAX_F = 16


def fused_overlay_tick_plain(idsaux, pw, intro, masks, scalars, *, k: int,
                             t_remove: int, churn_lo: int, churn_span: int):
    """Plain PyTorch version of :func:`fused_overlay_tick` (the TPU
    kernel's body, ops/pallas/overlay_exchange.py:122-259, on whole
    planes; ``x[r ^ m]`` is an index)."""
    n = idsaux.shape[0]
    dev = idsaux.device
    t, seed, vlo, vhi, ftick, rafter, cthr, cafter = (int(x) for x in scalars)
    seed &= MASK32
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    ep = t // SLOT_EPOCH
    my_ids = idsaux[:, :k]
    bits = idsaux[:, k + 1]
    proc, ops, jrep = (bits & 1) > 0, (bits & 2) > 0, (bits & 4) > 0
    my_p = torch.where(my_ids >= 0, pw, 0)
    kmax = torch.where(my_ids >= 0, pack_key(my_ids, (my_p >> 12) - 1), 0)
    pacc = my_p
    recv = torch.zeros(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for fi, m in enumerate(masks):
        partner = rows ^ int(m)
        wa, wp = idsaux[partner], pw[partner]
        ok = (wa[:, k + 2 + fi] > 0) & proc
        in_ids = wa[:, :k]
        in_ts = (wp >> 12) - 1
        valid = ok[:, None] & (in_ids >= 0) & (t - in_ts < t_remove) \
            & (in_ids != rows[:, None])
        kmax, pacc = merge_view(kmax, pacc, in_ids, in_ts, wp, valid)
        if t_remove > 1:                 # partner self-entry (age 1)
            kmax, pacc = merge_entry(kmax, pacc, seed, ep, partner, t - 1,
                                     wa[:, k], ok)
        recv += ok.to(torch.int32)

    # JOINREP: the introducer's broadcast view and self-entry
    bc_ids, bc_p = intro[0][None, :], intro[1][None, :]
    bc_ts = (bc_p >> 12) - 1
    j_valid = jrep[:, None] & (bc_ids >= 0) & (t - bc_ts < t_remove) \
        & (bc_ids != rows[:, None])
    kmax, pacc = merge_view(kmax, pacc, bc_ids, bc_ts, bc_p, j_valid)
    if t_remove > 1:
        kmax, pacc = merge_entry(kmax, pacc, seed, ep, 0, t - 1,
                                 intro[2, 0].expand(n), jrep & (rows != 0))

    # JOINREQ aggregate into the introducer's row
    is_r0 = (rows == 0)[:, None]
    q_kf = intro[3].to(torch.int64) & MASK32
    kmax, pacc = lex_max(kmax, pacc, torch.where(is_r0, q_kf[None, :], 0),
                         torch.where(is_r0, intro[4][None, :], zero))

    # winner extraction + staleness detection
    occ = kmax > 0
    ids1 = torch.where(occ, kmax & ID_MASK, -1).to(torch.int32)
    ts1 = torch.where(occ, (pacc >> 12) - 1, zero)
    hb1 = torch.where(occ, (pacc & 0xFFF) - 1, zero)
    stale = (ids1 >= 0) & (t - ts1 >= t_remove) & ops[:, None]
    ids2 = torch.where(stale, -1, ids1).to(torch.int32)
    hb2 = torch.where(stale, zero, hb1)
    ts2 = torch.where(stale, zero, ts1)

    # subject fail/rejoin: the closed-form schedule of the scalars
    sched = OverlaySchedule(seed=seed, victim_lo=vlo, victim_hi=vhi,
                            fail_tick=ftick, rejoin_after=rafter,
                            churn_thr=cthr & MASK32, churn_lo=churn_lo,
                            churn_span=churn_span, churn_after=cafter)
    subj_failed = sched.failed_at(ids1.clamp(min=0), t)

    def per_row(x):
        return x.sum(1, dtype=torch.int32)

    ctr = torch.stack([
        recv, per_row(stale), per_row(stale & ~subj_failed),
        per_row((ids2 >= 0) & subj_failed & ~stale),
        per_row((ids1 != my_ids) & (ids1 >= 0)), per_row(ids2 >= 0)], 1)
    return ids2, hb2.to(torch.int32), ts2.to(torch.int32), ctr


def fused_overlay_tick(idsaux, pw, intro, masks, scalars, *, k: int,
                       t_remove: int, churn_lo: int, churn_span: int):
    """The overlay tick's whole (N, K) phase.

    Args (the TPU kernel's single-device contract):
      idsaux: i32[N, K+2+F] — lanes [0, K) the post-wipe view ids, lane
        K own_hb, lane K+1 the packed proc|ops<<1|jrep<<2 bits, lanes
        [K+2, K+2+F) the per-round send flags.
      pw: i32[N, K] — packed (ts, hb) payload words.
      intro: i32[8, K] — row 0 the introducer's ids, row 1 its packed
        words, row 2 lane 0 its own_hb, row 3 the JOINREQ per-slot key
        aggregate (uint32 bits), row 4 the matching payloads.
      masks: F host ints — this tick's XOR masks.
      scalars: 8 host ints — [t, seed, victim_lo, victim_hi, fail_tick,
        rejoin_after, churn_thr (uint32 bits), churn_after].

    Returns ``(ids2, hb2, ts2 i32[N, K], counters i32[N, 6])``.  CPU
    tensors take :func:`fused_overlay_tick_plain`; CUDA tensors launch
    the kernel (or raise).
    """
    if idsaux.device.type == "cpu":
        return fused_overlay_tick_plain(
            idsaux, pw, intro, masks, scalars, k=k, t_remove=t_remove,
            churn_lo=churn_lo, churn_span=churn_span)
    n, w = idsaux.shape
    f = len(masks)
    if w != k + 2 + f or not 1 <= k <= MAX_K or f > MAX_F:
        raise ValueError(f"fused_overlay_tick: idsaux width {w} with "
                         f"K={k}, F={f} (K <= {MAX_K}, F <= {MAX_F})")
    if n < 2 or n & (n - 1):
        raise ValueError(f"fused_overlay_tick: N={n} is not a power of two")
    i32 = torch.int32
    check_args("fused_overlay_tick", (idsaux, i32, (n, w)),
               (pw, i32, (n, k)), (intro, i32, (8, k)))
    host = np.array([int(x) for x in scalars] + [int(m) for m in masks],
                    np.int64)
    if len(scalars) != 8 or ((host[8:] < 1) | (host[8:] >= n)).any():
        raise ValueError("fused_overlay_tick: 8 scalars and masks in "
                         "[1, N) expected")
    host = np.ascontiguousarray((host & 0xFFFFFFFF).astype(np.uint32)
                                .view(np.int32))
    dev = idsaux.device
    ids2 = torch.empty((n, k), dtype=i32, device=dev)
    hb2 = torch.empty((n, k), dtype=i32, device=dev)
    ts2 = torch.empty((n, k), dtype=i32, device=dev)
    ctr = torch.empty((n, N_COUNTERS), dtype=i32, device=dev)
    code = library("overlay_tick.cu").gp_fused_overlay_tick(
        ptr(idsaux), ptr(pw), ptr(intro), host.ctypes.data, ptr(ids2),
        ptr(hb2), ptr(ts2), ptr(ctr), n, k, f, int(t_remove), int(churn_lo),
        int(churn_span), stream_ptr(dev))
    fused_overlay_tick.launches += 1
    check(code, "fused_overlay_tick")
    return ids2, hb2, ts2, ctr


fused_overlay_tick.launches = 0

"""K4: S whole overlay ticks per call (CUDA ``mega_overlay_ticks``).

Replaces the TPU kernel ``gossip_protocol_tpu/ops/pallas/overlay_mega.py``
``mega_overlay_ticks`` (:456), with its contract: one i32[N, 2K+16]
state plane (the lane map below) and the scalar vector ``sp``
(``_SP_*`` scalars, then S·F XOR masks) in; the plane after S ticks and
one metric row per tick (``MET_*`` columns of i32[S, 128]) out.

The TPU kept the whole plane in VMEM for the S ticks.  At N=4096 it is
1.8 MB, more than one SM's 227 KB of shared memory, so on the H100 it
stays in HBM/L2 and a call is one cooperative launch of a persistent
grid (csrc/overlay_tick.cu ``mega_overlay_kernel``), one warp a row, with
one grid barrier a tick.  The tick's frozen send payload is a second
plane, kept twice by tick parity: the warp that runs a row's tick s
(partners and the introducer's broadcast row read from plane s % 2, the
row routine shared with K3 — merges, JOINREP, JOINREQ, extraction,
detection —, the drop-masked send flags with in-kernel ``mix32``, the
power-law degree gate, the re-slot on the last tick of a slot epoch)
writes the row with tick s + 1's churn wipe into the other plane and
adds its JOINREQ to tick s + 1's per-slot ``atomicMax`` aggregate.  The
metric sums are kept per block, then added by integer ``atomicAdd``
(exact); the metric rows and aggregates are zeroed in the launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..overlay_rules import (METRIC_FIELDS, OverlaySchedule, OverlayState,
                             RowColumns, as_i32, overlay_step)
from ._build import (check, check_args, count_launch, library, ptr,
                     stream_ptr)
from .overlay_exchange import fused_overlay_tick_plain

#: protocol ticks per launch (one slot epoch)
MEGA_TICKS = 16

#: aux lane offsets, relative to lane 2K
_IN_GROUP = 0
_OWN_HB = 1
_JOINREQ = 2
_JOINREP = 3
_SF = 4          # send flags, lanes [_SF, _SF + F), F <= 8
_START = 12
_FAIL = 13
_REJOIN = 14
_DEG = 15
AUX_LANES = 16

#: scalar layout of ``sp`` (masks follow, F per tick)
_SP_T0 = 0
_SP_SEED = 1
_SP_VLO = 2
_SP_VHI = 3
_SP_FTICK = 4
_SP_RAFTER = 5
_SP_CTHR = 6
_SP_CAFTER = 7
_SP_DROP_ON = 8
_SP_DROP_OPEN = 9
_SP_DROP_CLOSE = 10
_SP_DROP_THR = 11
_SP_FAIL0 = 12
_SP_REJOIN0 = 13
_SP_NSCALARS = 14

#: metric columns of the (S, 128) output
MET_IN_GROUP = 0
MET_VIEW = 1
MET_ADDS = 2
MET_REMOVALS = 3
MET_FALSE_REMOVALS = 4
MET_VICTIM = 5
MET_SENT = 6
MET_RECV = 7
MET_COLS = 128


def pack_plane(ids, hb, ts, in_group, own_hb, joinreq, joinrep, send_flags,
               start, fail, rejoin, deg):
    """The (N, 2K+16) plane of a state and its schedule columns."""
    n, f = send_flags.shape
    i32 = torch.int32
    pw = torch.where(ids >= 0, ((ts + 1) << 12) | (hb + 1), 0)
    cols = [ids, pw, in_group.to(i32)[:, None], own_hb[:, None],
            joinreq.to(i32)[:, None], joinrep.to(i32)[:, None],
            send_flags.to(i32),
            torch.zeros((n, 8 - f), dtype=i32, device=ids.device),
            start[:, None], fail[:, None], rejoin[:, None], deg[:, None]]
    return torch.cat([c.to(i32) for c in cols], 1).contiguous()


def unpack_plane(plane, k: int, f: int) -> dict:
    """State fields of a plane: ids, hb, ts, in_group, own_hb, joinreq,
    joinrep, send_flags (tensors)."""
    a = 2 * k
    ids = plane[:, :k]
    pw = plane[:, k:a]
    occ = ids >= 0
    return dict(ids=ids.contiguous(),
                hb=torch.where(occ, (pw & 0xFFF) - 1, 0).to(torch.int32),
                ts=torch.where(occ, (pw >> 12) - 1, 0).to(torch.int32),
                in_group=plane[:, a + _IN_GROUP] > 0,
                own_hb=plane[:, a + _OWN_HB].contiguous(),
                joinreq=plane[:, a + _JOINREQ] > 0,
                joinrep=plane[:, a + _JOINREP] > 0,
                send_flags=(plane[:, a + _SF:a + _SF + f] > 0).contiguous())


def _host_sp(sp) -> np.ndarray:
    if torch.is_tensor(sp):
        sp = sp.cpu().numpy()
    return np.ascontiguousarray(np.asarray(sp).astype(np.int64) & 0xFFFFFFFF,
                                dtype=np.int64)


def mega_overlay_ticks_plain(st, sp, *, n: int, k: int, f_rounds: int,
                             s_ticks: int, t_remove: int, churn_lo: int,
                             churn_span: int, can_rejoin: bool,
                             powerlaw: bool):
    """Plain PyTorch version of :func:`mega_overlay_ticks`: S calls of
    the overlay tick (``ops/overlay_rules.py overlay_step``, with K3's
    plain version) on the plane's state, schedule columns and ``sp``'s
    scalars and masks."""
    u = _host_sp(sp)
    s32 = [as_i32(int(x)) for x in u]
    a = 2 * k
    dev = st.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    cols = RowColumns(rows=rows, is_intro=rows == 0,
                      start=st[:, a + _START], fail=st[:, a + _FAIL],
                      rejoin=st[:, a + _REJOIN], deg=st[:, a + _DEG])
    sched = OverlaySchedule(
        seed=int(u[_SP_SEED]), victim_lo=s32[_SP_VLO],
        victim_hi=s32[_SP_VHI], fail_tick=s32[_SP_FTICK],
        rejoin_after=s32[_SP_RAFTER], churn_thr=int(u[_SP_CTHR]),
        churn_lo=churn_lo, churn_span=churn_span,
        churn_after=s32[_SP_CAFTER], drop_on=s32[_SP_DROP_ON] > 0,
        drop_open=s32[_SP_DROP_OPEN], drop_close=s32[_SP_DROP_CLOSE],
        drop_thr=int(u[_SP_DROP_THR]))
    state = OverlayState(
        tick=s32[_SP_T0],
        send_hist=torch.zeros((n, f_rounds), dtype=torch.int32, device=dev),
        **unpack_plane(st, k, f_rounds))
    met = torch.zeros((s_ticks, MET_COLS), dtype=torch.int32, device=dev)
    order = [METRIC_FIELDS.index(x) for x in (
        "in_group", "view_slots", "adds", "removals", "false_removals",
        "victim_slots", "sent", "recv")]
    for s in range(s_ticks):
        off = _SP_NSCALARS + s * f_rounds
        state, m = overlay_step(
            state, sched, cols, s32[off:off + f_rounds], k=k, f=f_rounds,
            t_remove=t_remove, can_rejoin=can_rejoin, powerlaw=powerlaw,
            fail0=s32[_SP_FAIL0], rejoin0=s32[_SP_REJOIN0],
            exchange=fused_overlay_tick_plain)
        met[s, :8] = m[order]
    out = pack_plane(state.ids, state.hb, state.ts, state.in_group,
                     state.own_hb, state.joinreq, state.joinrep,
                     state.send_flags, cols.start, cols.fail, cols.rejoin,
                     cols.deg)
    return out, met


def mega_overlay_ticks(st, sp, *, n: int, k: int, f_rounds: int,
                       s_ticks: int, t_remove: int, churn_lo: int,
                       churn_span: int, can_rejoin: bool, powerlaw: bool,
                       grid_blocks: int | None = None):
    """Run ``s_ticks`` whole overlay ticks on the state plane ``st``.

    Args as the TPU kernel's: ``st`` i32[N, 2K+16] (not modified), ``sp``
    the scalars and per-tick masks (host ints: a sequence, numpy array
    or tensor).  Returns ``(st', metrics i32[S, 128])``.  CPU tensors
    take :func:`mega_overlay_ticks_plain`; CUDA tensors launch the kernel
    once (or raise).  ``grid_blocks`` sets the persistent grid's size,
    for tests (default: as many blocks as fit on the card, capped by the
    rows); a grid that cannot be co-resident raises.
    """
    w = 2 * k + AUX_LANES
    if st.device.type == "cpu":
        return mega_overlay_ticks_plain(
            st, sp, n=n, k=k, f_rounds=f_rounds, s_ticks=s_ticks,
            t_remove=t_remove, churn_lo=churn_lo, churn_span=churn_span,
            can_rejoin=can_rejoin, powerlaw=powerlaw)
    if (w > 128 or not 1 <= f_rounds <= 8 or n < 8 or n & (n - 1)
            or not 1 <= s_ticks <= MEGA_TICKS):
        raise ValueError(f"mega_overlay_ticks: N={n}, K={k}, F={f_rounds}, "
                         f"S={s_ticks} outside the envelope (power-of-two "
                         f"N >= 8, 2K+16 <= 128, F <= 8, S <= {MEGA_TICKS})")
    check_args("mega_overlay_ticks", (st, torch.int32, (n, w)))
    host = _host_sp(sp)
    if host.shape != (_SP_NSCALARS + s_ticks * f_rounds,):
        raise ValueError(f"mega_overlay_ticks: sp has {host.shape[0]} "
                         f"entries, expected {_SP_NSCALARS} + S*F")
    host = np.ascontiguousarray(host.astype(np.uint32).view(np.int32))
    dev = st.device
    out = st.clone()
    wiped = torch.empty((2, n, w), dtype=torch.int32, device=dev)
    met = torch.empty((s_ticks, MET_COLS), dtype=torch.int32, device=dev)
    qbuf = torch.empty(s_ticks * k, dtype=torch.int32, device=dev)
    code = library("overlay_tick.cu").gp_mega_overlay_ticks(
        ptr(out), ptr(wiped), ptr(met), ptr(qbuf), host.ctypes.data, n, k,
        f_rounds, s_ticks, int(t_remove), int(churn_lo), int(churn_span),
        int(can_rejoin), int(powerlaw), int(grid_blocks or 0),
        stream_ptr(dev))
    count_launch(mega_overlay_ticks)
    check(code, "mega_overlay_ticks")
    return out, met


mega_overlay_ticks.launches = 0

"""K5: S whole overlay ticks per call at grid scale (CUDA
``grid_overlay_ticks``).

Replaces the TPU kernel ``gossip_protocol_tpu/ops/pallas/overlay_grid.py``
``grid_overlay_ticks`` (:710), with its contract: per fleet lane the
packed state ``plane`` i32[N, PLANE_W] and an ``sp`` row (the ``_GSP_*``
scalars, the F-1 power-law degree thresholds, then S·F XOR masks) in;
``plane2`` i32[2, N, PLANE_W]
(the end state in phase ``S % 2``) and one metric row per tick
(``MET_*`` columns of i32[S, 128]) out, with a leading B on every array
for a fleet.  The four ``*_live`` flags elide phases a launch provably
does not need (``models/segments.py``).  The TPU kernel also took the
launch's boot block (row 0 the introducer's row, row 1 lanes [0, K) the
boot JOINREQ aggregate) as rows N..N+8 of its ``init``.  Here K5 reads
the introducer's row from the plane, and the aggregate is carried: the
last tick of a join-live launch leaves the next launch's aggregate in
its scratch, the call returns it, and the run loop hands it to the next
call.  Only a run's first launch at a tick > 0 builds it from the plane,
with the boot pre-pass (:func:`grid_boot_rows`, whose plain version is
:func:`boot_block`).

The plane row of a peer: lanes [0, K) ids, [K, 2K) the 24-bit payload
words ``(ts+1) << 12 | hb+1``, with the aux state in the high byte of
payload lanes 0-2 (own_hb bits 0-7; own_hb bits 8-11 | in_group << 4 |
joinreq << 5 | joinrep << 6; the F send-flag bits), the rest zero.

The TPU kernel ran tick after tick over row blocks in its sequential
grid order, carrying the next tick's JOINREQ aggregate and the
introducer's row in scratch.  On the H100 one C call launches one kernel
a tick on one stream (the stream order is the barrier between ticks),
each reading one phase of the plane and writing the other, with tick
s+1's aggregate an ``atomicMax`` into a per-lane (S+1, K) buffer
(csrc/overlay_tick.cu) whose slot S is the carry.  Each tick is a
persistent grid whose warps run a three-stage ``cp.async`` pipeline over
their rows (own row and the partners' send flags, then the flagged
partners' rows, then the merge from shared memory), with the metric sums
added once a block.  The TPU's row-block height is a detail of its
blocking and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import INTRODUCER
from ...utils.hash32 import MASK32, mix32_t
from ..overlay_rules import (_SALT_DEGREE, METRIC_FIELDS, SLOT_EPOCH,
                             OverlaySchedule, OverlayState, RowColumns, as_i32,
                             overlay_step, pack_key, slot_of, u32_to_i32)
from ._build import (check, check_args, count_launch, library, ptr,
                     stream_ptr)
from .overlay_exchange import fused_overlay_tick_plain
from .overlay_mega import (MET_ADDS, MET_COLS,  # noqa: F401
                           MET_FALSE_REMOVALS, MET_IN_GROUP, MET_RECV,
                           MET_REMOVALS, MET_SENT, MET_VICTIM, MET_VIEW,
                           _host_sp)

#: protocol ticks per launch
GRID_TICKS = 16

#: stored plane width (K <= 64: ids and payload words in one 512-byte row)
PLANE_W = 128

#: scalar layout of an ``sp`` row (degree thresholds and masks follow)
_GSP_T0 = 0
_GSP_SEED = 1
_GSP_VLO = 2
_GSP_VHI = 3
_GSP_FTICK = 4
_GSP_RAFTER = 5
_GSP_CTHR = 6
_GSP_CAFTER = 7
_GSP_DROP_ON = 8
_GSP_DROP_OPEN = 9
_GSP_DROP_CLOSE = 10
_GSP_DROP_THR = 11
_GSP_FAIL0 = 12
_GSP_REJOIN0 = 13
_GSP_STEP_NUM = 14
_GSP_STEP_DEN = 15
_GSP_NSCALARS = 16

#: payload bits of a pw lane (the aux byte rides above)
_PW_MASK = 0x00FFFFFF

#: the flags argument of the C entry (csrc/overlay_tick.cu FL_*)
_FLAG_BITS = (("ramp_live", 1), ("churn_live", 2), ("join_live", 4),
              ("drop_live", 8))


def sp_len(f_rounds: int, s_ticks: int) -> int:
    """Entries of one ``sp`` row."""
    return _GSP_NSCALARS + max(f_rounds - 1, 0) + s_ticks * f_rounds


def pack_aux_lanes(pw, own_hb, in_group, joinreq, joinrep, sf_bits):
    """Attach the aux bytes to pw lanes 0-2 (int32; aux as (rows, 1)).
    ``<< 24`` wraps in int32, which is the bit pattern wanted."""
    a0 = own_hb & 0xFF
    a1 = ((own_hb >> 8) & 0xF) | (in_group << 4) | (joinreq << 5) \
        | (joinrep << 6)
    return torch.cat([pw[:, 0:1] | (a0 << 24), pw[:, 1:2] | (a1 << 24),
                      pw[:, 2:3] | (sf_bits << 24), pw[:, 3:]], 1)


def unpack_aux_lanes(pwr):
    """(pw_clean, own_hb, a1, sf_bits) from raw pw lanes (inverse of
    :func:`pack_aux_lanes`; a1 carries the three flag bits).  ``>>`` is
    arithmetic on int32, so each byte is masked after the shift."""
    a0 = (pwr[:, 0:1] >> 24) & 0xFF
    a1 = (pwr[:, 1:2] >> 24) & 0xFF
    sf = (pwr[:, 2:3] >> 24) & 0xFF
    return pwr & _PW_MASK, a0 | ((a1 & 0xF) << 8), a1, sf


def pack_plane(ids, hb, ts, in_group, own_hb, joinreq, joinrep,
               send_flags) -> torch.Tensor:
    """The (N, PLANE_W) plane of a state's fields."""
    n, k = ids.shape
    f = send_flags.shape[1]
    i32 = torch.int32
    pw = torch.where(ids >= 0, ((ts + 1) << 12) | (hb + 1), 0).to(i32)
    fis = torch.arange(f, dtype=i32, device=ids.device)
    sf_bits = (send_flags.to(i32) << fis).sum(1, keepdim=True).to(i32)
    pw = pack_aux_lanes(pw, own_hb.to(i32)[:, None],
                        in_group.to(i32)[:, None], joinreq.to(i32)[:, None],
                        joinrep.to(i32)[:, None], sf_bits)
    cols = [ids.to(i32), pw]
    if 2 * k < PLANE_W:
        cols.append(torch.zeros((n, PLANE_W - 2 * k), dtype=i32,
                                device=ids.device))
    return torch.cat(cols, 1).contiguous()


def unpack_plane(plane, k: int, f: int) -> dict:
    """State fields of a plane: ids, hb, ts, in_group, own_hb,
    send_flags, joinreq, joinrep (tensors)."""
    ids = plane[:, :k]
    pw, own_hb, a1, sf = unpack_aux_lanes(plane[:, k:2 * k])
    occ = ids >= 0
    fis = torch.arange(f, dtype=torch.int32, device=plane.device)
    return dict(ids=ids.contiguous(),
                hb=torch.where(occ, (pw & 0xFFF) - 1, 0).to(torch.int32),
                ts=torch.where(occ, (pw >> 12) - 1, 0).to(torch.int32),
                in_group=(a1[:, 0] & 0x10) > 0,
                own_hb=own_hb[:, 0].contiguous(),
                send_flags=(((sf >> fis) & 1) > 0).contiguous(),
                joinreq=(a1[:, 0] & 0x20) > 0,
                joinrep=(a1[:, 0] & 0x40) > 0)


def boot_block(plane, *, k: int, t0: int, seed: int, fail0: int,
               rejoin0: int, join_live: bool = True) -> torch.Tensor:
    """The (8, PLANE_W) boot block of a launch at tick ``t0`` (plain):
    row 0 the introducer's plane row, row 1 lanes [0, K) the tick's
    JOINREQ per-slot aggregate (later ticks' aggregates accumulate in
    K5), one ``scatter_reduce`` over the slot index.  The aggregate is
    zero where the introducer does not process at ``t0`` (``fail0 < t0
    <= rejoin0``, or ``t0`` = 0) and on a join-dead launch, whose
    joinreq bits are all zero (models/segments.py)."""
    n = plane.shape[0]
    boot = torch.zeros((8, PLANE_W), dtype=torch.int32, device=plane.device)
    boot[0] = plane[INTRODUCER]
    if join_live and t0 > 0 and not fail0 < t0 <= rejoin0:
        rows = torch.arange(n, dtype=torch.int64, device=plane.device)
        joinreq = ((plane[:, k + 1] >> 24) & 0x20) > 0
        q_key = torch.where(joinreq & (rows != INTRODUCER),
                            pack_key(rows, t0), 0)
        q_kf = torch.zeros(k, dtype=torch.int64, device=plane.device) \
            .scatter_reduce_(0, slot_of(seed, t0 // SLOT_EPOCH, rows, k),
                             q_key, "amax")
        boot[1, :k] = u32_to_i32(q_kf)
    return boot


def _lane_aggs(planes, host, t0s, k: int, join_live: bool = True):
    """Row 1 lanes [0, K) of each lane's :func:`boot_block` at tick
    ``t0s[b]``, with the ``sp`` row's seed and introducer window:
    i32[B, K]."""
    return torch.stack([boot_block(
        planes[b], k=k, t0=t0, seed=int(h[_GSP_SEED]) & MASK32,
        fail0=as_i32(int(h[_GSP_FAIL0])),
        rejoin0=as_i32(int(h[_GSP_REJOIN0])), join_live=join_live)[1, :k]
        for b, (h, t0) in enumerate(zip(host, t0s))])


def grid_boot_rows_plain(plane, sp, *, n: int, k: int, batch: int = 1):
    """Plain PyTorch version of :func:`grid_boot_rows`: per lane row 1
    of :func:`boot_block` at the ``sp`` row's tick."""
    squeeze = plane.dim() == 2
    host = _host_sp(sp)
    if squeeze:
        plane, host = plane[None], host[None]
    assert plane.shape == (batch, n, PLANE_W), (plane.shape, batch)
    out = _lane_aggs(plane, host, [as_i32(int(h[_GSP_T0])) for h in host], k)
    return out[0] if squeeze else out


def grid_boot_rows(plane, sp, *, n: int, k: int, batch: int = 1):
    """The boot JOINREQ aggregate i32[K] (i32[B, K] for a fleet) of a K5
    launch on ``plane`` at the ``sp`` row's tick: K5's boot pre-pass.
    :func:`grid_overlay_ticks` runs it only for a join-live launch at a
    tick > 0 that has no aggregate carried from the launch before it.
    ``csrc/overlay_tick.cu grid_boot_kernel`` reads one word of every row
    (one thread a row, the aggregate by ``atomicMax``).  CPU tensors take
    :func:`grid_boot_rows_plain`; CUDA tensors launch the kernel (or
    raise).  Each call counts in ``grid_boot_rows.calls`` on any device,
    each launch in ``grid_boot_rows.launches``."""
    count_launch(grid_boot_rows, "calls")
    if plane.device.type == "cpu":
        return grid_boot_rows_plain(plane, sp, n=n, k=k, batch=batch)
    squeeze = plane.dim() == 2
    host = _host_sp(sp)
    if squeeze:
        plane, host = plane[None], host[None]
    if plane.shape[0] != batch or host.shape[0] != batch:
        raise ValueError(f"grid_boot_rows: expected {batch} lanes")
    check_args("grid_boot_rows", (plane[0], torch.int32, (n, PLANE_W)))
    agg = _boot_launch(plane, _sp_to_card(host, plane.device), host.shape[1],
                       n=n, k=k, batch=batch)
    return agg[0] if squeeze else agg


grid_boot_rows.launches = 0
grid_boot_rows.calls = 0


def _launch_agg(plane, host, agg, join_live: bool, sp_dev=None, *, n: int,
                k: int, batch: int):
    """A launch's boot aggregate on lanes i32[B, N, PLANE_W] with host
    ``sp`` rows: the carried ``agg`` where there is one; None (zero) at
    tick 0 and on a join-dead launch; else the boot pre-pass's, counted
    in ``grid_boot_rows.calls`` (the card's with ``sp_dev``, the ``sp``
    rows already there, else the plain version)."""
    if agg is not None or not join_live or not (host[:, _GSP_T0] > 0).any():
        return agg
    count_launch(grid_boot_rows, "calls")
    if sp_dev is None:
        return grid_boot_rows_plain(plane, host, n=n, k=k, batch=batch)
    return _boot_launch(plane, sp_dev, host.shape[1], n=n, k=k, batch=batch)


def _boot_launch(plane, sp_dev, length: int, *, n: int, k: int,
                 batch: int) -> torch.Tensor:
    """One launch of the boot pre-pass on checked lanes (i32[B, N,
    PLANE_W]) and ``sp`` rows already on the card: i32[B, K]."""
    if not 1 <= k <= PLANE_W // 2:
        raise ValueError(f"grid_boot_rows: K={k} outside 1..{PLANE_W // 2}")
    dev = plane.device
    agg = torch.empty((batch, k), dtype=torch.int32, device=dev)
    code = library("overlay_tick.cu").gp_grid_boot(
        ptr(plane), plane.stride(0), ptr(sp_dev), ptr(agg), n, k, batch,
        length, stream_ptr(dev))
    count_launch(grid_boot_rows)
    check(code, "grid_boot_rows")
    return agg


def _sp_to_card(host: np.ndarray, dev) -> torch.Tensor:
    """``sp`` rows (host ints) to the card through pinned memory, without
    a sync."""
    return torch.from_numpy(np.ascontiguousarray(
        host.astype(np.uint32).view(np.int32))).pin_memory() \
        .to(dev, non_blocking=True)


def _check_flags(ramp_live, churn_live, join_live, can_rejoin) -> None:
    # the join_live=False form assumes no start or rejoin event can fire
    # this launch (models/segments.py planner invariant; the TPU kernel
    # asserts the same)
    assert join_live or not (ramp_live or (can_rejoin and churn_live)), \
        (ramp_live, churn_live, join_live, can_rejoin)


def _lane_plain(plane, sp_row, *, n, k, f_rounds, s_ticks, t_remove,
                churn_lo, churn_span, can_rejoin, churn_mode, powerlaw):
    """One fleet lane of :func:`grid_overlay_ticks_plain`."""
    u = [int(x) & MASK32 for x in sp_row]
    s32 = [as_i32(x) for x in u]
    dev = plane.device
    sched = OverlaySchedule(
        seed=u[_GSP_SEED], step_num=s32[_GSP_STEP_NUM],
        step_den=s32[_GSP_STEP_DEN], victim_lo=s32[_GSP_VLO],
        victim_hi=s32[_GSP_VHI], fail_tick=s32[_GSP_FTICK],
        rejoin_after=s32[_GSP_RAFTER],
        churn_thr=u[_GSP_CTHR] if churn_mode else 0,
        churn_lo=churn_lo, churn_span=churn_span,
        churn_after=s32[_GSP_CAFTER], drop_on=s32[_GSP_DROP_ON] > 0,
        drop_open=s32[_GSP_DROP_OPEN], drop_close=s32[_GSP_DROP_CLOSE],
        drop_thr=u[_GSP_DROP_THR])
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    thr = torch.tensor(u[_GSP_NSCALARS:_GSP_NSCALARS + f_rounds - 1],
                       dtype=torch.int64, device=dev)
    du = mix32_t(sched.seed, rows, _SALT_DEGREE)
    cols = RowColumns(rows=rows, is_intro=rows == INTRODUCER,
                      start=sched.start_of(rows), fail=sched.fail_of(rows),
                      rejoin=sched.rejoin_of(rows),
                      deg=(1 + (du[:, None] < thr[None, :]).sum(1))
                      .to(torch.int32))
    state = OverlayState(
        tick=s32[_GSP_T0],
        send_hist=torch.zeros((n, f_rounds), dtype=torch.int32, device=dev),
        **unpack_plane(plane, k, f_rounds))
    plane2 = torch.zeros((2, n, PLANE_W), dtype=torch.int32, device=dev)
    met = torch.zeros((s_ticks, MET_COLS), dtype=torch.int32, device=dev)
    order = [METRIC_FIELDS.index(x) for x in (
        "in_group", "view_slots", "adds", "removals", "false_removals",
        "victim_slots", "sent", "recv")]
    moff = _GSP_NSCALARS + max(f_rounds - 1, 0)
    for s in range(s_ticks):
        off = moff + s * f_rounds
        state, m = overlay_step(
            state, sched, cols, s32[off:off + f_rounds], k=k, f=f_rounds,
            t_remove=t_remove, can_rejoin=can_rejoin, powerlaw=powerlaw,
            fail0=s32[_GSP_FAIL0], rejoin0=s32[_GSP_REJOIN0],
            exchange=fused_overlay_tick_plain)
        met[s, :8] = m[order]
        if s >= s_ticks - 2:       # the kernel's last two writes
            plane2[1 - s % 2] = pack_plane(
                state.ids, state.hb, state.ts, state.in_group, state.own_hb,
                state.joinreq, state.joinrep, state.send_flags)
    return plane2, met


def grid_overlay_ticks_plain(plane, sp, *, n: int, k: int, f_rounds: int,
                             s_ticks: int, t_remove: int, churn_lo: int,
                             churn_span: int, can_rejoin: bool,
                             churn_mode: bool, powerlaw: bool,
                             ramp_live: bool = True, churn_live: bool = True,
                             join_live: bool = True, drop_live: bool = True,
                             batch: int = 1, agg=None):
    """Plain PyTorch version of :func:`grid_overlay_ticks`: per lane, S
    calls of the overlay tick (``ops/overlay_rules.py overlay_step``,
    with K3's plain version) on the plane's state and the schedule
    rebuilt from ``sp`` (its churn threshold zeroed outside churn mode:
    every subject then takes the victim interval), packed back; the tick
    derives the introducer's row and each tick's JOINREQ aggregate from
    the state, so a carried ``agg`` is held equal to the one the plane
    gives (:func:`boot_block`), and the next launch's is row 1 of
    :func:`boot_block` of the end state at tick t0 + S.  Under the
    planner's invariant the all-live tick is exact, so the phase flags
    are checked, not used."""
    _check_flags(ramp_live, churn_live, join_live, can_rejoin)
    del drop_live
    squeeze = plane.dim() == 2
    host = _host_sp(sp)
    if squeeze:
        plane, host = plane[None], host[None]
    assert plane.shape == (batch, n, PLANE_W), (plane.shape, batch)
    assert host.shape == (batch, sp_len(f_rounds, s_ticks)), host.shape
    t0s = [as_i32(int(h[_GSP_T0])) for h in host]
    if agg is not None:
        want = _lane_aggs(plane, host, t0s, k, join_live)
        assert torch.equal(agg.reshape(want.shape).to(want.device), want), \
            "the carried boot aggregate is not the plane's"
    outs = [_lane_plain(plane[b], host[b], n=n, k=k, f_rounds=f_rounds,
                        s_ticks=s_ticks, t_remove=t_remove,
                        churn_lo=churn_lo, churn_span=churn_span,
                        can_rejoin=can_rejoin, churn_mode=churn_mode,
                        powerlaw=powerlaw)
            for b in range(batch)]
    plane2 = torch.stack([o[0] for o in outs])
    met = torch.stack([o[1] for o in outs])
    nxt = _lane_aggs(plane2[:, s_ticks % 2], host,
                     [t + s_ticks for t in t0s], k)
    if squeeze:
        return plane2[0], met[0], nxt[0]
    return plane2, met, nxt


def grid_overlay_ticks(plane, sp, *, n: int, k: int, f_rounds: int,
                       s_ticks: int, t_remove: int, churn_lo: int,
                       churn_span: int, can_rejoin: bool, churn_mode: bool,
                       powerlaw: bool, ramp_live: bool = True,
                       churn_live: bool = True, join_live: bool = True,
                       drop_live: bool = True, batch: int = 1, agg=None):
    """Run ``s_ticks`` whole overlay ticks on ``plane`` in one call.

    Args as the TPU kernel's, its ``init`` cut to the ``plane``
    i32[N, PLANE_W] (the row-block height left out), or i32[B, N,
    PLANE_W] with ``batch`` = B (not modified; each lane's plane
    contiguous, the lanes at any stride, so a fleet's phase of ``plane2``
    goes in as it is); ``sp`` the scalar row(s) (host ints: a numpy
    array, a sequence or a tensor).  The TPU's boot rows are gone: K5
    reads the introducer's row from the plane, and ``agg`` is the
    launch's boot JOINREQ aggregate i32[K] (i32[B, K]), the third output
    of the call that produced ``plane`` (the carry).  Without it the
    aggregate is zero at tick 0 and on a join-dead launch, and else comes
    from the boot pre-pass (:func:`grid_boot_rows`).  Returns
    ``(plane2 i32[2, N, PLANE_W], metrics i32[S, 128], agg i32[K])``
    (with a leading B for a fleet): the end state is ``plane2[S % 2]``,
    the other phase the state one tick before it (zero when S = 1), and
    ``agg`` the next launch's boot aggregate.  CPU tensors take
    :func:`grid_overlay_ticks_plain`; CUDA tensors launch the kernel (or
    raise).
    """
    kw = dict(n=n, k=k, f_rounds=f_rounds, s_ticks=s_ticks,
              t_remove=t_remove, churn_lo=churn_lo, churn_span=churn_span,
              can_rejoin=can_rejoin, churn_mode=churn_mode, powerlaw=powerlaw,
              ramp_live=ramp_live, churn_live=churn_live,
              join_live=join_live, drop_live=drop_live, batch=batch)
    if plane.device.type == "cpu":
        host = _host_sp(sp)
        planes = plane[None] if plane.dim() == 2 else plane
        agg = _launch_agg(planes, host.reshape(len(planes), -1), agg,
                          join_live, n=n, k=k, batch=batch)
        return grid_overlay_ticks_plain(plane, sp, agg=agg, **kw)
    _check_flags(ramp_live, churn_live, join_live, can_rejoin)
    if n < 8 or n & (n - 1) or not 1 <= k <= PLANE_W // 2 \
            or not 1 <= f_rounds <= 8 or s_ticks < 1 or batch < 1:
        raise ValueError(f"grid_overlay_ticks: N={n}, K={k}, F={f_rounds}, "
                         f"S={s_ticks}, B={batch} outside the envelope "
                         "(power-of-two N >= 8, 2K <= 128, F <= 8)")
    squeeze = plane.dim() == 2
    host = _host_sp(sp)
    if squeeze:
        plane, host = plane[None], host[None]
    if plane.shape[0] != batch:
        raise ValueError(f"grid_overlay_ticks: plane has {plane.shape[0]} "
                         f"lanes, expected {batch}")
    check_args("grid_overlay_ticks", (plane[0], torch.int32, (n, PLANE_W)))
    if plane.data_ptr() % 16 or plane.stride(0) % 4:
        raise ValueError("grid_overlay_ticks: the plane's rows must be "
                         "16-byte aligned (K5 copies them in 16-byte chunks)")
    length = sp_len(f_rounds, s_ticks)
    if host.shape != (batch, length):
        raise ValueError(f"grid_overlay_ticks: sp has shape {host.shape}, "
                         f"expected ({batch}, {length})")
    masks = host[:, length - s_ticks * f_rounds:]
    if ((masks < 1) | (masks >= n)).any():
        raise ValueError("grid_overlay_ticks: an XOR mask outside [1, N) "
                         "would read past the plane")
    dev = plane.device
    sp_dev = _sp_to_card(host, dev)
    if agg is not None:
        want = (k,) if squeeze else (batch, k)
        if agg.device != dev or agg.dtype != torch.int32 \
                or tuple(agg.shape) != want or agg.stride(-1) != 1:
            raise ValueError(f"grid_overlay_ticks: agg must be int32 "
                             f"{want} rows on {dev}, got {agg.dtype} "
                             f"{tuple(agg.shape)} on {agg.device}")
        agg = agg.reshape(batch, k)
    agg = _launch_agg(plane, host, agg, join_live, sp_dev, n=n, k=k,
                      batch=batch)
    plane2 = torch.empty((batch, 2, n, PLANE_W), dtype=torch.int32,
                         device=dev)
    if s_ticks == 1:
        plane2[:, 0].zero_()
    met = torch.empty((batch, s_ticks, MET_COLS), dtype=torch.int32,
                      device=dev)
    # the per-tick JOINREQ aggregates of each lane; slot S is the carry
    qbuf = torch.empty((batch, s_ticks + 1, k), dtype=torch.int32,
                       device=dev)
    flags = sum(bit for name, bit in _FLAG_BITS if kw[name])
    code = library("overlay_tick.cu").gp_grid_overlay_ticks(
        ptr(plane), plane.stride(0), ptr(agg),
        k if agg is None or batch == 1 else agg.stride(0), ptr(sp_dev),
        ptr(plane2), ptr(met), ptr(qbuf), n, k, f_rounds, s_ticks, batch,
        length, int(t_remove), int(churn_lo), int(churn_span),
        int(can_rejoin), int(churn_mode), int(powerlaw), flags,
        stream_ptr(dev))
    count_launch(grid_overlay_ticks)
    check(code, "grid_overlay_ticks")
    nxt = qbuf[:, s_ticks]
    if squeeze:
        return plane2[0], met[0], nxt[0]
    return plane2, met, nxt


grid_overlay_ticks.launches = 0

"""The overlay's per-tick rules, in one place.

What one overlay tick computes, below the model's routing: the packed
entry formats (priority key, winner payload), the epoch-slotted map,
the lexicographic merge, the closed-form schedule a subject's fail and
rejoin are read from, the SLOT_EPOCH re-slot, and the tick itself
(:func:`overlay_step`), and the adversarial worlds' exchange
(:func:`overlay_world_exchange`).  Counterpart of the rule parts of
``gossip_protocol_tpu/models/overlay.py`` (:116-307, :485-552,
:707-1220).

The model (``models/overlay.py``) and the kernels' plain versions
(``ops/cuda/overlay_exchange.py``, ``ops/cuda/overlay_mega.py``,
``ops/cuda/overlay_grid.py``) all call these; the CUDA kernels (``csrc/overlay_tick.cu``) compute the
same per row.  uint32 values (priority keys, hashes, thresholds) ride
int64 tensors masked to 32 bits: torch has no logical ``>>`` on uint32
on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import INTRODUCER
from ..state import NEVER
from ..utils.hash32 import MASK32, mix32_t
from ..worlds import (SALT_BYZ, SALT_FLAP, SALT_FLAP_PHASE, SALT_LINK,
                      SALT_PART, link_latency_of)

#: id field width of the packed priority key (ids < 2^20)
ID_BITS = 20
ID_MASK = (1 << ID_BITS) - 1

#: global slot-map re-roll period (ticks)
SLOT_EPOCH = 16

# salts of the independent counter-hash streams
_SALT_MASK = 1
_SALT_GOSSIP_DROP = 2
_SALT_JOINREQ_DROP = 3
_SALT_JOINREP_DROP = 4
_SALT_CHURN = 5
_SALT_CHURN_TICK = 6
_SALT_SLOT = 7
_SALT_DEGREE = 8

#: per-tick metrics, in the order of the (T, 9) metric rows
METRIC_FIELDS = ("in_group", "view_slots", "adds", "removals",
                 "false_removals", "victim_slots", "live_uncovered", "sent",
                 "recv")


def as_i32(v: int) -> int:
    """The int32 reading of a uint32 bit pattern (python ints)."""
    v &= MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# ------------------------------------------------------------------ types

@dataclass
class OverlayState:
    """World state: O(N·K) tables plus O(N·F) in-flight send flags."""

    tick: int                  # host clock
    ids: torch.Tensor          # i32[N, K] — entry subject id, -1 = empty
    hb: torch.Tensor           # i32[N, K]
    ts: torch.Tensor           # i32[N, K] — freshest observation time
    in_group: torch.Tensor     # bool[N]
    own_hb: torch.Tensor       # i32[N]
    send_flags: torch.Tensor   # bool[N, F] — gossiped on slot f last tick
    send_hist: torch.Tensor    # i32[N, F] — latency world: per-slot send
    #                            shift register (bit a = sent a+1 ticks
    #                            ago); all zero otherwise
    joinreq: torch.Tensor      # bool[N]
    joinrep: torch.Tensor      # bool[N]

    @property
    def device(self) -> torch.device:
        return self.ids.device

    def to(self, device) -> "OverlayState":
        return OverlayState(**{
            f.name: (v if f.name == "tick" else v.to(device))
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)})


@dataclass(frozen=True)
class OverlaySchedule:
    """Closed-form schedule: host scalars, evaluated per (id, tick).

    The fields of the JAX ``OverlaySchedule``; a world that is off keeps
    its "off" values.  Every world draw is a counter hash of
    (seed, id[, tick]), evaluated on id tensors.
    """

    seed: int = 0             # uint32
    step_num: int = 0         # start ramp: start(i) = i*num//den
    step_den: int = 1
    victim_lo: int = 0        # scripted failure interval [lo, hi)
    victim_hi: int = 0
    fail_tick: int = 0
    rejoin_after: int = int(NEVER)
    churn_thr: int = 0        # uint32 (0 = off)
    churn_lo: int = 0
    churn_span: int = 1
    churn_after: int = 40
    drop_on: bool = False
    drop_open: int = 0        # droppable sends: open < t <= close
    drop_close: int = 0
    drop_thr: int = 0         # uint32
    deg_thr: tuple = (0xFFFFFFFF,)   # uint32 power-law CDF thresholds
    part_groups: int = 0
    part_open: int = 0
    part_close: int = 0
    asym_on: bool = False
    wave_size: int = 0
    wave_tick: int = 0
    wave_speed: int = 1
    wave_center: int = 0
    wave_mod: int = 0
    zombie_on: bool = False
    flap_thr: int = 0
    flap_period: int = 1
    flap_down: int = 0
    flap_open: int = 0
    flap_close: int = -1
    byz_thr: int = 0
    byz_boost: int = 0
    link_lat: int = 0

    def start_of(self, i: torch.Tensor) -> torch.Tensor:
        """i32 start ticks; ``i*num`` wraps in int32 as in JAX."""
        prod = i.to(torch.int64) * self.step_num
        prod = ((prod + (1 << 31)) & MASK32) - (1 << 31)
        return torch.div(prod, self.step_den,
                         rounding_mode="floor").to(torch.int32)

    def _churned(self, i: torch.Tensor) -> torch.Tensor:
        iu = i.to(torch.int64) & MASK32
        return (mix32_t(self.seed, iu, _SALT_CHURN) < self.churn_thr) \
            & (i != INTRODUCER)

    def _iu(self, i) -> torch.Tensor:
        return i.to(torch.int64) & MASK32

    def fail_of(self, i: torch.Tensor) -> torch.Tensor:
        if self.churn_thr > 0:
            churn_fail = self.churn_lo + (
                mix32_t(self.seed, self._iu(i), _SALT_CHURN_TICK)
                % self.churn_span)
            out = torch.where(self._churned(i), churn_fail, int(NEVER))
        elif self.wave_size > 0:
            # the wave: the wave_size nodes of the ring block from the
            # epicenter fail one radius step per wave_speed ticks
            off = (i.to(torch.int64) - self.wave_center) \
                % max(self.wave_mod, 1)
            out = torch.where((off < self.wave_size) & (i != INTRODUCER),
                              self.wave_tick + off // max(self.wave_speed, 1),
                              int(NEVER))
        else:
            out = torch.where((i >= self.victim_lo) & (i < self.victim_hi),
                              self.fail_tick, int(NEVER))
        return out.to(torch.int32)

    def rejoin_of(self, i: torch.Tensor) -> torch.Tensor:
        fail = self.fail_of(i)
        after = self.churn_after if self.churn_thr > 0 else self.rejoin_after
        if after == NEVER:
            return torch.full_like(fail, int(NEVER))
        return torch.where(fail != NEVER, fail.to(torch.int64) + after,
                           int(NEVER)).to(torch.int32)

    def flap(self, i: torch.Tensor, t):
        """(failed, rejoining) under the flap world: down for positions
        [1, flap_down] of each period from the node's hashed anchor,
        rejoining at position flap_down, only for cycles completing by
        flap_close.  ``t`` an int or a tensor broadcasting with ``i``."""
        if self.flap_thr <= 0:
            z = torch.zeros(torch.broadcast_shapes(
                i.shape, t.shape if torch.is_tensor(t) else ()),
                dtype=torch.bool, device=i.device)
            return z, z
        iu = self._iu(i)
        sel = (mix32_t(self.seed, iu, SALT_FLAP) < self.flap_thr) \
            & (i != INTRODUCER)
        per = max(self.flap_period, 1)
        anchor = self.flap_open + mix32_t(self.seed, iu, SALT_FLAP_PHASE) % per
        pos = t - anchor
        c = torch.div(pos, per, rounding_mode="floor")
        off = pos - c * per
        ok = sel & (pos >= 1) \
            & (anchor + c * per + self.flap_down <= self.flap_close)
        return (ok & (off >= 1) & (off <= self.flap_down),
                ok & (off == self.flap_down))

    def byz_of(self, i: torch.Tensor) -> torch.Tensor:
        """bool: node ``i`` is a seeded liar (never the introducer)."""
        return (mix32_t(self.seed, self._iu(i), SALT_BYZ) < self.byz_thr) \
            & (i != INTRODUCER)

    def group_of(self, i: torch.Tensor) -> torch.Tensor:
        """i64 hashed partition group of node ``i`` (0 when off)."""
        return mix32_t(self.seed, self._iu(i), SALT_PART) \
            % max(self.part_groups, 1)

    def link_thr(self, iu, ju) -> torch.Tensor:
        """uint32 (int64) drop threshold of link i -> j (asym world):
        ``H(seed, i*N+j) % 2*drop_thr``, mean ``drop_thr``; ``i*N+j`` and
        ``2*drop_thr`` wrap in uint32 as in the JAX package."""
        two = max((self.drop_thr * 2) & MASK32, 1)
        return mix32_t(self.seed, (iu * self.wave_mod + ju) & MASK32,
                       SALT_LINK) % two

    def window_failed_at(self, i: torch.Tensor, t) -> torch.Tensor:
        """The scripted / churn / wave fail window alone (the failures
        the zombie world applies to)."""
        return (t > self.fail_of(i)) & (t <= self.rejoin_of(i))

    def failed_at(self, i: torch.Tensor, t) -> torch.Tensor:
        return self.window_failed_at(i, t) | self.flap(i, t)[0]

    def rejoining_at(self, i: torch.Tensor, t: int) -> torch.Tensor:
        return (self.rejoin_of(i) == t) | self.flap(i, t)[1]

    def drop_active(self, t: int) -> bool:
        return bool(self.drop_on) and self.drop_open < t <= self.drop_close

    def part_active(self, t: int) -> bool:
        """Cross-group sends blocked at tick ``t``?  (host)"""
        return self.part_groups > 0 and self.part_open < t <= self.part_close


@dataclass(frozen=True)
class WorldFlags:
    """The adversarial worlds a config turns on: the tick's static
    branches, read from the config (JAX ``make_overlay_tick``), not from
    the schedule's thresholds."""

    part: bool = False
    asym: bool = False
    zombie: bool = False
    flap: bool = False
    byz: bool = False
    latency: int = 0          # link_latency (0 = off)


@dataclass
class RowColumns:
    """Per-row schedule columns of a run (loop-invariant)."""

    rows: torch.Tensor       # i64[N]
    is_intro: torch.Tensor   # bool[N]
    start: torch.Tensor      # i32[N]
    fail: torch.Tensor
    rejoin: torch.Tensor
    deg: torch.Tensor        # i32[N]


# ---------------------------------------------------------------- helpers

def exchange_mask(seed: int, t: int, fi: int, n: int) -> int:
    """Nonzero XOR mask of exchange slot ``fi`` at tick ``t`` (host)."""
    m = mix32_t(seed & MASK32, t & MASK32, fi, _SALT_MASK)
    return m % (n - 1) + 1


def pack_th(ts, hb):
    """int32 winner payload ``(ts+1) << 12 | (hb+1)``."""
    return ((ts + 1) << 12) | (hb + 1)


def pack_key(ids, ts):
    """uint32 slot-priority key ``(ts+1) << ID_BITS | id`` (int64)."""
    if not torch.is_tensor(ts):
        hi = ((ts + 1) << ID_BITS) & MASK32
    else:
        hi = ((ts.to(torch.int64) + 1) << ID_BITS) & MASK32
    lo = ids.to(torch.int64) & MASK32 if torch.is_tensor(ids) \
        else ids & MASK32
    return hi | lo


def slot_of(seed: int, epoch: int, ids, k: int):
    """Global slot of subject ``ids`` during slot epoch ``epoch``."""
    iu = ids.to(torch.int64) & MASK32 if torch.is_tensor(ids) \
        else ids & MASK32
    return mix32_t(seed, epoch & MASK32, iu, _SALT_SLOT) % k


def lex_max(kmax, pacc, key, p):
    """Lexicographic (key, payload) max — associative and commutative."""
    better = (key > kmax) | ((key == kmax) & (p > pacc))
    return torch.where(better, key, kmax), torch.where(better, p, pacc)


def reslot(ids, hb, ts, seed: int, epoch: int):
    """Re-slot every row's entries into epoch ``epoch``'s map; slot
    contention resolved by the lexicographic (key, payload) max."""
    n, k = ids.shape
    occ = ids >= 0
    tgt = slot_of(seed, epoch, ids, k)
    key = torch.where(occ, pack_key(ids, ts), 0).reshape(-1)
    p = torch.where(occ, pack_th(ts, hb), 0).to(torch.int64).reshape(-1)
    flat = (torch.arange(n, device=ids.device)[:, None] * k + tgt).reshape(-1)
    kf = torch.zeros(n * k, dtype=torch.int64, device=ids.device) \
        .scatter_reduce_(0, flat, key, "amax")
    sel = (key == kf[flat]) & (key > 0)
    pf = torch.zeros(n * k, dtype=torch.int64, device=ids.device) \
        .scatter_reduce_(0, flat, torch.where(sel, p, 0), "amax")
    kf, pf = kf.view(n, k), pf.view(n, k)
    on = kf > 0
    return (torch.where(on, kf & ID_MASK, -1).to(torch.int32),
            torch.where(on, (pf & 0xFFF) - 1, 0).to(torch.int32),
            torch.where(on, (pf >> 12) - 1, 0).to(torch.int32))


def covered_histogram(ids: torch.Tensor, n: int) -> torch.Tensor:
    """bool[N]: which subject ids appear in at least one view slot."""
    flat = ids.reshape(-1).to(torch.int64)
    idx = torch.where(flat >= 0, flat, n)
    return torch.zeros(n + 1, dtype=torch.bool, device=ids.device) \
        .index_fill_(0, idx, True)[:n]


# ------------------------------------------------------------------- tick

def merge_view(kmax, pacc, c_ids, c_ts, c_p, valid):
    """Merge an identically-slotted (N, K) view: ``c_p`` is the packed
    (ts, hb) word, the wire format and the merge tiebreak at once."""
    zero = torch.zeros((), dtype=torch.int32, device=kmax.device)
    return lex_max(kmax, pacc, torch.where(valid, pack_key(c_ids, c_ts), 0),
                   torch.where(valid, c_p, zero))


def merge_entry(kmax, pacc, seed: int, epoch: int, subj, e_ts, e_hb, ok):
    """Merge one direct ``(subj, e_ts, e_hb)`` entry per row into its
    slot of epoch ``epoch``'s map; ``subj``/``e_ts``/``e_hb`` are (N,)
    tensors or scalars, ``ok`` bool[N]."""
    k = kmax.shape[1]
    kk = torch.arange(k, dtype=torch.int64, device=kmax.device)
    match = slot_of(seed, epoch, subj, k)
    match = (match[:, None] if torch.is_tensor(match) and match.ndim
             else match) == kk
    key = torch.where(ok, pack_key(subj, e_ts), 0)
    p = torch.where(ok, pack_th(e_ts, e_hb), 0)
    zero = torch.zeros((), dtype=torch.int32, device=kmax.device)
    return lex_max(kmax, pacc, torch.where(match, key[:, None], 0),
                   torch.where(match, p[:, None].to(torch.int32), zero))


def overlay_world_exchange(ids0, p0, own_hb0, flight, proc, ops, jrep,
                           q_kf, q_pf, masks, sched: OverlaySchedule, t: int,
                           *, t_remove: int, worlds: WorldFlags):
    """The (N, K) phase of one overlay tick under the adversarial worlds:
    the counterpart of the JAX package's XLA tick
    (models/overlay.py:841-1014), which world configs take in place of
    the fused kernel.

    From the post-wipe view (``ids0``, its packed payload ``p0``,
    ``own_hb0``) and the in-flight plane ``flight`` (the send flags, or
    the send-history words under latency): F XOR-partner rounds, each a
    lexicographic (key, payload) merge of the partner's view and its
    self-entry; the JOINREP broadcast; the JOINREQ aggregate into row 0;
    winner extraction; TREMOVE detection; the metric sums.  The worlds'
    rules: under latency a round delivers the message sent lat(p, r)
    ticks ago, its self-entry dated at that send tick; under byz the
    relayed freshness is clamped to ``t - 2``, liars forge it and boost
    their counters, and liars never purge; a zombie partner's direct
    self-entry earns no credit.  Returns ``(ids, hb, ts, sums)`` with
    ``sums`` i64[6]: recv (exchange rounds only), removals,
    false_removals, victim_slots, adds, view_slots.
    """
    n, k = ids0.shape
    dev = ids0.device
    seed = sched.seed
    ep = t // SLOT_EPOCH
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    occ0 = ids0 >= 0
    kmax = torch.where(occ0, pack_key(ids0, (p0 >> 12) - 1), 0)
    pacc = p0
    recv = torch.zeros((), dtype=torch.int64, device=dev)
    for fi, m in enumerate(masks):
        partner = rows ^ int(m)
        in_ids, in_p = ids0[partner], p0[partner]
        in_ts = (in_p >> 12) - 1
        own_p = own_hb0[partner]
        if worlds.latency:
            lat = link_latency_of(seed, partner, rows, n, worlds.latency)
            sent = ((flight[partner, fi] >> (lat - 1)) & 1) > 0
            self_ts = t - lat
        else:
            sent = flight[partner, fi]
            self_ts = torch.full((n,), t - 1, dtype=torch.int32, device=dev)
        ok = sent & proc
        if worlds.byz:
            liar = sched.byz_of(partner)[:, None]
            in_hb = torch.where(in_ids >= 0, (in_p & 0xFFF) - 1, 0)
            in_ts = torch.minimum(in_ts, torch.full_like(in_ts, t - 2))
            in_ts = torch.where(liar, t - 2, in_ts)
            in_hb = torch.where(liar, (in_hb + sched.byz_boost).clamp(
                max=4093), in_hb)
            in_p = torch.where(in_ids >= 0, pack_th(in_ts, in_hb),
                               0).to(torch.int32)
            own_p = torch.where(liar[:, 0], own_p + sched.byz_boost, own_p)
        valid = ok[:, None] & (in_ids >= 0) & (t - in_ts < t_remove) \
            & (in_ids != rows[:, None])
        recv = recv + ok.sum()
        kmax, pacc = merge_view(kmax, pacc, in_ids, in_ts, in_p, valid)
        if t_remove > 1:
            cred = ok
            if worlds.zombie:
                cred = ok & ~sched.window_failed_at(partner, self_ts)
            kmax, pacc = merge_entry(kmax, pacc, seed, ep, partner, self_ts,
                                     own_p, cred)

    # JOINREP: the introducer's view and self-entry
    b_ids = ids0[INTRODUCER][None, :].expand(n, k)
    b_p = p0[INTRODUCER][None, :].expand(n, k)
    b_ts = (b_p >> 12) - 1
    j_valid = jrep[:, None] & (b_ids >= 0) & (t - b_ts < t_remove) \
        & (b_ids != rows[:, None])
    kmax, pacc = merge_view(kmax, pacc, b_ids, b_ts, b_p, j_valid)
    if t_remove > 1:
        j_ok = jrep & (rows != INTRODUCER)
        if worlds.zombie:
            intro = torch.zeros(1, dtype=torch.int64, device=dev)
            j_ok = j_ok & ~sched.window_failed_at(intro, t - 1)
        kmax, pacc = merge_entry(
            kmax, pacc, seed, ep, torch.full((n,), INTRODUCER, device=dev),
            torch.full((n,), t - 1, dtype=torch.int32, device=dev),
            own_hb0[INTRODUCER].expand(n), j_ok)

    # JOINREQ aggregate into the introducer's row
    is_r0 = (rows == INTRODUCER)[:, None]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    kmax, pacc = lex_max(kmax, pacc, torch.where(is_r0, q_kf[None, :], 0),
                         torch.where(is_r0, q_pf[None, :], zero))

    # winner extraction + detection
    occ = kmax > 0
    ids1 = torch.where(occ, kmax & ID_MASK, -1).to(torch.int32)
    ts1 = torch.where(occ, (pacc >> 12) - 1, zero)
    hb1 = torch.where(occ, (pacc & 0xFFF) - 1, zero)
    stale = (ids1 >= 0) & (t - ts1 >= t_remove) & ops[:, None]
    if worlds.byz:      # liars never purge (the shield attack)
        stale = stale & ~sched.byz_of(rows)[:, None]
    subj = ids1.clamp(min=0)
    subj_failed = sched.window_failed_at(subj, t)
    if worlds.flap:     # a flap-down subject's removal is a true positive
        subj_failed = subj_failed | sched.flap(subj, t)[0]
    ids2 = torch.where(stale, -1, ids1).to(torch.int32)
    hb2 = torch.where(stale, zero, hb1).to(torch.int32)
    ts2 = torch.where(stale, zero, ts1).to(torch.int32)
    sums = torch.stack([
        recv, stale.sum(), (stale & ~subj_failed).sum(),
        ((ids2 >= 0) & subj_failed & ~stale).sum(),
        ((ids1 != ids0) & (ids1 >= 0)).sum(), (ids2 >= 0).sum()])
    return ids2, hb2, ts2, sums


def overlay_step(state: OverlayState, sched: OverlaySchedule,
                 cols: RowColumns, masks, *, k: int, f: int, t_remove: int,
                 can_rejoin: bool, powerlaw: bool, fail0: int, rejoin0: int,
                 exchange, with_coverage: bool = False,
                 worlds: WorldFlags | None = None, comm=None):
    """One overlay tick: ``(state', metrics i32[9])``.

    The JAX tick (models/overlay.py:707-1220): churn wipe, vector
    decisions, the JOINREQ slot aggregate, the whole (N, K) phase through
    ``exchange`` (K3 ``fused_overlay_tick`` or its plain version), the
    join sends, the SLOT_EPOCH re-slot at the END of a boundary tick,
    the drop-masked send flags and the metrics.  ``masks`` are the
    tick's F XOR masks and ``fail0``/``rejoin0`` the introducer's fail
    window (host ints), as K4 receives them; the schedule's per-row
    values come from ``cols``.  K4's and K5's plain versions are S
    calls of this.

    With ``worlds`` (a world config) the (N, K) phase is
    :func:`overlay_world_exchange` instead of ``exchange``, as the JAX
    package routes world configs off its fused kernel, and the worlds'
    rules apply around it: flap phases, the send history, the asym
    per-link thresholds and the partition gate on every send, zombie
    sends.

    ``comm`` (models/overlay_sharded.py ``RingOverlayComm``) makes the
    tick one shard of a peer-sharded run (JAX ``make_overlay_tick(cfg,
    comm=)``): the tables, send flags and history hold the shard's Nl
    rows, the per-peer vectors and ``cols`` stay whole; K3 takes its
    sharded contract (each round's planes from shard ``s ^ (m // Nl)``,
    routed by ``comm.xor_perm_shards``), the introducer's row comes from
    ``comm.bcast_row0`` and every table counter through ``comm.psum``.
    World configs are not sharded.
    """
    t = state.tick
    rows, is_intro = cols.rows, cols.is_intro
    n = rows.shape[0]
    sh = comm is not None and comm.n_shards > 1
    nl = state.ids.shape[0]
    r0 = comm.row_start(n) if sh else 0
    if sh and worlds is not None:
        raise ValueError("world configs do not run peer-sharded")

    def loc(v):
        """A whole per-peer vector at this shard's rows."""
        return comm.slice_rows(v) if sh else v

    dev = state.ids.device
    i32 = torch.int32
    seed = sched.seed
    w = worlds or WorldFlags()
    failed_win = (t > cols.fail) & (t <= cols.rejoin)
    failed = failed_win
    if w.flap:
        fl_f, fl_r = sched.flap(rows, t)
        failed = failed | fl_f
    proc = (t > cols.start) & ~failed
    failed0 = fail0 < t <= rejoin0
    proc0 = t > 0 and not failed0

    # ---- churn wipe ------------------------------------------------
    if can_rejoin:
        rejoining = cols.rejoin == t
        if w.flap:
            rejoining = rejoining | fl_r
        keep = ~rejoining
        keep_l = loc(keep)
        ids0 = torch.where(keep_l[:, None], state.ids, -1)
        hb0 = state.hb * keep_l[:, None]
        ts0 = state.ts * keep_l[:, None]
        in_group0 = state.in_group & keep
        own_hb0 = state.own_hb * keep
    else:
        rejoining = torch.zeros_like(state.in_group)
        ids0, hb0, ts0 = state.ids, state.hb, state.ts
        in_group0, own_hb0 = state.in_group, state.own_hb
    if w.latency:
        # a rejoin is a fresh nodeStart: its in-flight stream dies
        hist0 = state.send_hist * keep_l[:, None] if can_rejoin \
            else state.send_hist
    slot_ep = t // SLOT_EPOCH
    p0 = torch.where(ids0 >= 0, pack_th(ts0, hb0), 0).to(i32)

    # ---- vector decisions --------------------------------------------
    jrep = state.joinrep & proc
    jreq = state.joinreq if proc0 else torch.zeros_like(state.joinreq)
    starting = (cols.start == t) | rejoining
    in_group = in_group0 | jrep | (starting & is_intro)
    ops = proc & in_group
    own_hb = (own_hb0 + ops.to(i32)).to(i32)

    # JOINREQ per-slot aggregate at the introducer (addMember)
    q_key = torch.where(jreq & ~is_intro, pack_key(rows, t), 0)
    q_kf = torch.zeros(k, dtype=torch.int64, device=dev).scatter_reduce_(
        0, slot_of(seed, slot_ep, rows, k), q_key, "amax")
    q_pf = torch.where(q_kf > 0, pack_th(t, 1), 0).to(i32)
    joins_recv = jrep.sum() + jreq.sum()

    # ---- the whole (N, K) phase: K3, or the worlds' exchange ----------
    if worlds is None:
        bits = loc(proc.to(i32) | (ops.to(i32) << 1) | (jrep.to(i32) << 2))
        own_hb0_l = loc(own_hb0)
        idsaux = torch.cat([ids0, own_hb0_l[:, None], bits[:, None],
                            state.send_flags.to(i32)], 1).contiguous()
        p0 = p0.contiguous()
        row0 = torch.cat([ids0[0], p0[0], own_hb0_l[:1]])
        if sh:              # global row 0 lives on shard 0
            row0 = comm.bcast_row0(row0)
        intro = torch.zeros((8, k), dtype=i32, device=dev)
        intro[0] = row0[:k]
        intro[1] = row0[k:2 * k]
        intro[2, 0] = row0[2 * k]
        intro[3] = u32_to_i32(q_kf)
        intro[4] = q_pf
        scalars = (t, as_i32(seed), sched.victim_lo, sched.victim_hi,
                   sched.fail_tick, sched.rejoin_after,
                   as_i32(sched.churn_thr), sched.churn_after)
        shard_kw = {}
        if sh:
            shard_kw = dict(
                masks_local=[m % nl for m in masks], row_start=r0,
                aux_rounds=[comm.xor_perm_shards(idsaux, m // nl)
                            for m in masks],
                pw_rounds=[comm.xor_perm_shards(p0, m // nl)
                           for m in masks])
        ids2, hb2, ts2, ctr = exchange(
            idsaux, p0, intro, masks, scalars, k=k,
            t_remove=t_remove, churn_lo=sched.churn_lo,
            churn_span=sched.churn_span, **shard_kw)
        csum = ctr.sum(0)
        if sh:
            csum = comm.psum(csum)
    else:
        ids2, hb2, ts2, csum = overlay_world_exchange(
            ids0, p0, own_hb0, hist0 if w.latency else state.send_flags,
            proc, ops, jrep, q_kf, q_pf, masks, sched, t,
            t_remove=t_remove, worlds=w)

    # ---- nodeStart / rejoin sends --------------------------------------
    joinreq_sent = starting & ~is_intro
    joinrep_sent = jreq
    active = sched.drop_active(t)
    ru = rows & MASK32
    if active:
        # the asym world: each sender's link to the introducer (JOINREQ),
        # the introducer's link to each receiver (JOINREP)
        qthr = sched.link_thr(ru, INTRODUCER) if w.asym else sched.drop_thr
        pthr = sched.link_thr(INTRODUCER, ru) if w.asym else sched.drop_thr
        qdrop = mix32_t(seed, t, ru, _SALT_JOINREQ_DROP) < qthr
        pdrop = mix32_t(seed, t, ru, _SALT_JOINREP_DROP) < pthr
        joinreq_sent = joinreq_sent & ~qdrop
        joinrep_sent = joinrep_sent & ~pdrop
    pa = w.part and sched.part_active(t)
    if pa:
        # the partition blocks cross-group join traffic at send time
        grp = sched.group_of(rows)
        cross_intro = grp != grp[INTRODUCER]
        joinreq_sent = joinreq_sent & ~cross_intro
        joinrep_sent = joinrep_sent & ~cross_intro

    # ---- slot-map re-roll at the END of a boundary tick ---------------
    ids_pre = ids2
    if (t + 1) // SLOT_EPOCH != slot_ep:
        ids2, hb2, ts2 = reslot(ids2, hb2, ts2, seed, (t + 1) // SLOT_EPOCH)

    # ---- dissemination: next tick's in-flight flags --------------------
    send_src = loc(ops)
    if w.zombie:
        # window-failed in-group peers keep gossiping their frozen tables
        send_src = ops | (failed_win & in_group0)
    send_flags = send_src[:, None].expand(nl, f)
    fis = torch.arange(f, dtype=torch.int64, device=dev)
    if w.asym or pa:
        # the partner of row i on slot fi of the next delivery is
        # i ^ mask(t, fi), known at send time
        nxt = torch.tensor([exchange_mask(seed, t, fi, n) for fi in range(f)],
                           dtype=torch.int64, device=dev)
        partners = rows[:, None] ^ nxt[None, :]
    if active:
        gthr = sched.link_thr(ru[:, None], partners) if w.asym \
            else sched.drop_thr
        gdrop = mix32_t(seed, t, loc(ru)[:, None], fis[None, :],
                        _SALT_GOSSIP_DROP) < gthr
        send_flags = send_flags & ~gdrop
    if pa:
        send_flags = send_flags \
            & (grp[:, None] == sched.group_of(partners))
    if powerlaw:
        send_flags = send_flags & (fis[None, :] < loc(cols.deg)[:, None])
    send_flags = send_flags.contiguous()
    flags_sent = send_flags.sum()
    if sh:
        flags_sent = comm.psum(flags_sent)
    sent = flags_sent + joinreq_sent.sum() + joinrep_sent.sum()
    if w.latency:
        # shift the send history: bit 0 = sent this tick, capped at the
        # largest drawable delay L + 1
        send_hist = ((hist0 << 1) | send_flags.to(i32)) \
            & ((1 << (w.latency + 1)) - 1)
    else:
        send_hist = state.send_hist

    live_hold = ~proc & ~failed
    joinreq_next = joinreq_sent
    if not proc0 and not failed0:
        joinreq_next = joinreq_next | state.joinreq
    joinrep_next = joinrep_sent | (state.joinrep & live_hold)

    if with_coverage:
        live_member = in_group & ~failed & ~is_intro
        covered = covered_histogram(ids_pre, n)
        if sh:
            covered = comm.psum(covered)      # a bool psum is an OR
        live_uncovered = (live_member & ~covered).sum()
    else:
        live_uncovered = torch.tensor(-1, device=dev)
    metrics = torch.stack([
        in_group.sum(), csum[5], csum[4], csum[1], csum[2], csum[3],
        live_uncovered, sent, csum[0] + joins_recv]).to(i32)
    new = OverlayState(
        tick=t + 1, ids=ids2, hb=hb2, ts=ts2, in_group=in_group,
        own_hb=own_hb, send_flags=send_flags, send_hist=send_hist,
        joinreq=joinreq_next, joinrep=joinrep_next)
    return new, metrics

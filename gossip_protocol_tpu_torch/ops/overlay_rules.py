"""The overlay's per-tick rules, in one place.

What one overlay tick computes, below the model's routing: the packed
entry formats (priority key, winner payload), the epoch-slotted map,
the lexicographic merge, the closed-form schedule a subject's fail and
rejoin are read from, the SLOT_EPOCH re-slot, and the tick itself
(:func:`overlay_step`).  Counterpart of the rule parts of
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
    send_hist: torch.Tensor    # i32[N, F] — all zero (no latency world)
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

    Course-world fields of the JAX ``OverlaySchedule``; the world fields
    keep their "off" values (world configs raise in ``config.py``).
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

    def fail_of(self, i: torch.Tensor) -> torch.Tensor:
        if self.churn_thr > 0:
            iu = i.to(torch.int64) & MASK32
            churn_fail = self.churn_lo + (
                mix32_t(self.seed, iu, _SALT_CHURN_TICK) % self.churn_span)
            out = torch.where(self._churned(i), churn_fail, int(NEVER))
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

    def failed_at(self, i: torch.Tensor, t: int) -> torch.Tensor:
        return (t > self.fail_of(i)) & (t <= self.rejoin_of(i))

    def rejoining_at(self, i: torch.Tensor, t: int) -> torch.Tensor:
        return self.rejoin_of(i) == t

    def drop_active(self, t: int) -> bool:
        return bool(self.drop_on) and self.drop_open < t <= self.drop_close


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

def overlay_step(state: OverlayState, sched: OverlaySchedule,
                 cols: RowColumns, masks, *, k: int, f: int, t_remove: int,
                 can_rejoin: bool, powerlaw: bool, fail0: int, rejoin0: int,
                 exchange, with_coverage: bool = False):
    """One overlay tick: ``(state', metrics i32[9])``.

    The JAX tick (models/overlay.py:707-1220) on the course worlds:
    churn wipe, vector decisions, the JOINREQ slot aggregate, the whole
    (N, K) phase through ``exchange`` (K3 ``fused_overlay_tick`` or its
    plain version), the join sends, the SLOT_EPOCH re-slot at the END of
    a boundary tick, the drop-masked send flags and the metrics.
    ``masks`` are the tick's F XOR masks and ``fail0``/``rejoin0`` the
    introducer's fail window (host ints), as K4 receives them; the
    schedule's per-row values come from ``cols``.  K4's and K5's plain
    versions are S calls of this.
    """
    t = state.tick
    n = state.ids.shape[0]
    dev = state.ids.device
    i32 = torch.int32
    rows, is_intro = cols.rows, cols.is_intro
    seed = sched.seed
    failed = (t > cols.fail) & (t <= cols.rejoin)
    proc = (t > cols.start) & ~failed
    failed0 = fail0 < t <= rejoin0
    proc0 = t > 0 and not failed0

    # ---- churn wipe ------------------------------------------------
    if can_rejoin:
        rejoining = cols.rejoin == t
        keep = ~rejoining
        ids0 = torch.where(keep[:, None], state.ids, -1)
        hb0 = state.hb * keep[:, None]
        ts0 = state.ts * keep[:, None]
        in_group0 = state.in_group & keep
        own_hb0 = state.own_hb * keep
    else:
        rejoining = torch.zeros_like(state.in_group)
        ids0, hb0, ts0 = state.ids, state.hb, state.ts
        in_group0, own_hb0 = state.in_group, state.own_hb
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

    # ---- the whole (N, K) phase: K3 ----------------------------------
    bits = proc.to(i32) | (ops.to(i32) << 1) | (jrep.to(i32) << 2)
    idsaux = torch.cat([ids0, own_hb0[:, None], bits[:, None],
                        state.send_flags.to(i32)], 1).contiguous()
    intro = torch.zeros((8, k), dtype=i32, device=dev)
    intro[0] = ids0[0]
    intro[1] = p0[0]
    intro[2, 0] = own_hb0[0]
    intro[3] = u32_to_i32(q_kf)
    intro[4] = q_pf
    scalars = (t, as_i32(seed), sched.victim_lo, sched.victim_hi,
               sched.fail_tick, sched.rejoin_after, as_i32(sched.churn_thr),
               sched.churn_after)
    ids2, hb2, ts2, ctr = exchange(
        idsaux, p0.contiguous(), intro, masks, scalars, k=k,
        t_remove=t_remove, churn_lo=sched.churn_lo,
        churn_span=sched.churn_span)
    csum = ctr.sum(0)

    # ---- nodeStart / rejoin sends --------------------------------------
    joinreq_sent = starting & ~is_intro
    joinrep_sent = jreq
    active = sched.drop_active(t)
    if active:
        ru = rows & MASK32
        qdrop = mix32_t(seed, t, ru, _SALT_JOINREQ_DROP) < sched.drop_thr
        pdrop = mix32_t(seed, t, ru, _SALT_JOINREP_DROP) < sched.drop_thr
        joinreq_sent = joinreq_sent & ~qdrop
        joinrep_sent = joinrep_sent & ~pdrop

    # ---- slot-map re-roll at the END of a boundary tick ---------------
    ids_pre = ids2
    if (t + 1) // SLOT_EPOCH != slot_ep:
        ids2, hb2, ts2 = reslot(ids2, hb2, ts2, seed, (t + 1) // SLOT_EPOCH)

    # ---- dissemination: next tick's in-flight flags --------------------
    send_flags = ops[:, None].expand(n, f)
    fis = torch.arange(f, dtype=torch.int64, device=dev)
    if active:
        gdrop = mix32_t(seed, t, (rows & MASK32)[:, None], fis[None, :],
                        _SALT_GOSSIP_DROP) < sched.drop_thr
        send_flags = send_flags & ~gdrop
    if powerlaw:
        send_flags = send_flags & (fis[None, :] < cols.deg[:, None])
    send_flags = send_flags.contiguous()
    sent = send_flags.sum() + joinreq_sent.sum() + joinrep_sent.sum()

    live_hold = ~proc & ~failed
    joinreq_next = joinreq_sent
    if not proc0 and not failed0:
        joinreq_next = joinreq_next | state.joinreq
    joinrep_next = joinrep_sent | (state.joinrep & live_hold)

    if with_coverage:
        live_member = in_group & ~failed & ~is_intro
        live_uncovered = (live_member
                          & ~covered_histogram(ids_pre, n)).sum()
    else:
        live_uncovered = torch.tensor(-1, device=dev)
    metrics = torch.stack([
        in_group.sum(), csum[5], csum[4], csum[1], csum[2], csum[3],
        live_uncovered, sent, csum[0] + joins_recv]).to(i32)
    new = OverlayState(
        tick=t + 1, ids=ids2, hb=hb2, ts=ts2, in_group=in_group,
        own_hb=own_hb, send_flags=send_flags, send_hist=state.send_hist,
        joinreq=joinreq_next, joinrep=joinrep_next)
    return new, metrics

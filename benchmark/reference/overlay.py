"""Plain PyTorch reference of the bounded-view overlay model (metrics
mode), written from its rules, one lane at a time.

Every peer holds K view slots, each an ``(id, hb, ts)`` entry, slotted
by a hash of (seed, epoch, id) that re-rolls every 16 ticks.  Per tick
``t``: churned peers fail and later rejoin with an empty view; the
JOINREQ / JOINREP traffic and group membership; F exchange rounds, in
round ``f`` peer ``i`` receives the view of partner ``i ^ mask(t - 1,
f)`` (if that partner sent on the round) plus the partner's own entry;
the introducer's view to each JOINREP receiver; the JOINREQs into the
introducer's row; per slot the winner by the lexicographic (priority
key ``(ts + 1) << 20 | id``, payload ``(ts + 1) << 12 | (hb + 1)``)
maximum; TREMOVE removal; the re-slot at the end of an epoch's last
tick; the next tick's sends under the drop draw.  Every draw is
:func:`~.prims.mix32` of the seed and counters, so a lane is a pure
function of its configuration and seed.

``control="f32_key"`` compares the priority keys in float32, whose 24
bits of mantissa cannot hold a key: the exactness the configuration
guarantees, broken the way a float max over packed keys would break it.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from .prims import M32, NEVER, mix32, threshold32, victim_draw

INTRODUCER = 0
ID_BITS = 20
ID_MASK = (1 << ID_BITS) - 1
SLOT_EPOCH = 16
SALT_MASK, SALT_GOSSIP_DROP, SALT_JOINREQ_DROP, SALT_JOINREP_DROP = 1, 2, 3, 4
SALT_CHURN, SALT_CHURN_TICK, SALT_SLOT, SALT_DEGREE = 5, 6, 7, 8
#: per-tick metrics, in the order the program reports them
METRICS = ("in_group", "view_slots", "adds", "removals", "false_removals",
           "victim_slots", "live_uncovered", "sent", "recv")


def dims(cfg: dict) -> tuple[int, int]:
    """(K view slots, F exchange rounds)."""
    b = int(math.ceil(math.log2(max(cfg["max_nnb"], 4))))
    k = cfg.get("overlay_view", 0) or min(64, max(16, 8 * ((b + 1) // 2)))
    f = cfg.get("fanout", 0) or (8 if cfg.get("topology") == "powerlaw"
                                 else 3)
    return k, f


def _check(cfg: dict) -> None:
    plain = dict(partition_groups=0, asym_drop=False, wave_size=0,
                 zombie=False, flap_rate=0.0, byz_rate=0.0,
                 link_latency=0, model="overlay")
    bad = {k: cfg.get(k, v) for k, v in plain.items()
           if cfg.get(k, v) != v}
    if bad:
        raise ValueError(f"the overlay reference runs the course worlds "
                         f"only, not {bad}")


class Schedule:
    """Closed-form per-peer start, fail and rejoin ticks and degrees."""

    def __init__(self, cfg: dict, seed: int, device):
        n = cfg["max_nnb"]
        self.seed = seed & M32
        frac = Fraction(cfg["step_rate"]).limit_denominator(1 << 15)
        num, den = frac.numerator, max(frac.denominator, 1)
        rows = torch.arange(n, dtype=torch.int64, device=device)
        prod = ((rows * num + (1 << 31)) & M32) - (1 << 31)
        self.start = torch.div(prod, den, rounding_mode="floor")
        churn = cfg.get("churn_rate", 0.0)
        rejoin_after = cfg.get("rejoin_after")
        if churn > 0:
            lo, span = cfg["total_ticks"] // 4, max(cfg["total_ticks"] // 2, 1)
            after = rejoin_after if rejoin_after is not None else 40
            churned = (mix32(self.seed, rows, SALT_CHURN) < threshold32(churn)) \
                & (rows != INTRODUCER)
            self.fail = torch.where(
                churned, lo + mix32(self.seed, rows, SALT_CHURN_TICK) % span,
                NEVER)
        else:
            u = victim_draw(seed)
            if cfg["single_failure"]:
                v_lo = int(u * n) % n
                v_hi = v_lo + 1
            else:
                v_lo = (int(u * n) % n) // 2
                v_hi = v_lo + n // 2
            after = rejoin_after if rejoin_after is not None else NEVER
            self.fail = torch.where((rows >= v_lo) & (rows < v_hi),
                                    cfg["fail_tick"], NEVER)
        if after == NEVER:
            self.rejoin = torch.full_like(self.fail, NEVER)
        else:
            self.rejoin = torch.where(self.fail != NEVER, self.fail + after,
                                      NEVER)
        self.can_rejoin = churn > 0 or rejoin_after is not None
        k, f = dims(cfg)
        self.deg = torch.full((n,), f, dtype=torch.int64, device=device)
        if cfg.get("topology") == "powerlaw":
            a = float(cfg.get("powerlaw_alpha", 2.5))
            du = mix32(self.seed, rows, SALT_DEGREE)
            self.deg = torch.ones_like(du)
            for j in range(2, f + 1):
                thr = min(M32, int(round(4294967296.0 * j ** (-(a - 1.0)))))
                self.deg += (du < thr).to(torch.int64)
        self.powerlaw = cfg.get("topology") == "powerlaw"

    def window_failed(self, ids, t: int):
        return (t > self.fail[ids]) & (t <= self.rejoin[ids])


def pack_key(ids, ts):
    return (((ts + 1) << ID_BITS) & M32) | (ids & M32)


def pack_th(ts, hb):
    return ((ts + 1) << 12) | (hb + 1)


def slot_of(seed: int, epoch: int, ids, k: int):
    return mix32(seed, epoch & M32, ids & M32, SALT_SLOT) % k


class Merge:
    """Lexicographic (key, payload) max, exact or with float32 keys."""

    def __init__(self, control=None):
        self.f32 = control == "f32_key"

    def __call__(self, kmax, pacc, key, p):
        if self.f32:
            kf, nf = kmax.to(torch.float32), key.to(torch.float32)
            better = (nf > kf) | ((nf == kf) & (p > pacc))
        else:
            better = (key > kmax) | ((key == kmax) & (p > pacc))
        return torch.where(better, key, kmax), torch.where(better, p, pacc)


def run_lane(cfg: dict, seed: int, device, control=None) -> dict:
    """One lane's whole run: the final state and the metric rows [T, 9]
    (``live_uncovered`` -1, as the fleet reports it)."""
    _check(cfg)
    dev = torch.device(device)
    n, total, t_remove = cfg["max_nnb"], cfg["total_ticks"], cfg["t_remove"]
    k, f = dims(cfg)
    sc = Schedule(cfg, seed, dev)
    seed32 = sc.seed
    lex = Merge(control)
    drop_thr = threshold32(cfg.get("msg_drop_prob", 0.1))
    i64 = torch.int64
    rows = torch.arange(n, dtype=i64, device=dev)
    is_intro = rows == INTRODUCER
    kk = torch.arange(k, dtype=i64, device=dev)
    fis = torch.arange(f, dtype=i64, device=dev)
    ids = torch.full((n, k), -1, dtype=i64, device=dev)
    hb = torch.zeros((n, k), dtype=i64, device=dev)
    ts = torch.zeros((n, k), dtype=i64, device=dev)
    in_group = torch.zeros(n, dtype=torch.bool, device=dev)
    own_hb = torch.zeros(n, dtype=i64, device=dev)
    flags = torch.zeros((n, f), dtype=torch.bool, device=dev)
    joinreq = torch.zeros(n, dtype=torch.bool, device=dev)
    joinrep = torch.zeros(n, dtype=torch.bool, device=dev)
    fail0, rejoin0 = int(sc.fail[0]), int(sc.rejoin[0])
    metrics = []

    def entry(kmax, pacc, epoch, subj, e_ts, e_hb, ok):
        match = slot_of(seed32, epoch, subj, k)
        match = (match[:, None] if torch.is_tensor(match) else match) == kk
        key = torch.where(ok, pack_key(subj, e_ts), 0)
        p = torch.where(ok, pack_th(e_ts, e_hb), 0)
        return lex(kmax, pacc, torch.where(match, key[:, None], 0),
                   torch.where(match, p[:, None], 0))

    for t in range(total):
        failed = (t > sc.fail) & (t <= sc.rejoin)
        proc = (t > sc.start) & ~failed
        failed0 = fail0 < t <= rejoin0
        proc0 = t > 0 and not failed0
        rejoining = (sc.rejoin == t) if sc.can_rejoin \
            else torch.zeros_like(proc)
        keep = ~rejoining
        ids0 = torch.where(keep[:, None], ids, -1)
        hb0, ts0 = hb * keep[:, None], ts * keep[:, None]
        in_group0, own_hb0 = in_group & keep, own_hb * keep
        ep = t // SLOT_EPOCH
        p0 = torch.where(ids0 >= 0, pack_th(ts0, hb0), 0)

        jrep = joinrep & proc
        jreq = joinreq if proc0 else torch.zeros_like(joinreq)
        starting = (sc.start == t) | rejoining
        in_group = in_group0 | jrep | (starting & is_intro)
        ops = proc & in_group
        own_hb = own_hb0 + ops.to(i64)
        q_key = torch.where(jreq & ~is_intro, pack_key(rows, t), 0)
        q_kf = torch.zeros(k, dtype=i64, device=dev).scatter_reduce_(
            0, slot_of(seed32, ep, rows, k), q_key, "amax")
        q_pf = torch.where(q_kf > 0, pack_th(t, 1), 0)
        joins_recv = jrep.sum() + jreq.sum()

        # the exchange rounds
        kmax = torch.where(ids0 >= 0, pack_key(ids0, (p0 >> 12) - 1), 0)
        pacc = p0
        recv = torch.zeros((), dtype=i64, device=dev)
        for fi in range(f):
            m = int(mix32(seed32, (t - 1) & M32, fi, SALT_MASK)) % (n - 1) + 1
            partner = rows ^ m
            in_ids, in_p = ids0[partner], p0[partner]
            in_ts = (in_p >> 12) - 1
            ok = flags[partner, fi] & proc
            valid = ok[:, None] & (in_ids >= 0) & (t - in_ts < t_remove) \
                & (in_ids != rows[:, None])
            recv = recv + ok.sum()
            kmax, pacc = lex(kmax, pacc,
                             torch.where(valid, pack_key(in_ids, in_ts), 0),
                             torch.where(valid, in_p, 0))
            if t_remove > 1:
                kmax, pacc = entry(kmax, pacc, ep, partner, t - 1,
                                   own_hb0[partner], ok)
        # JOINREP: the introducer's view and its own entry
        b_ids = ids0[INTRODUCER][None, :].expand(n, k)
        b_p = p0[INTRODUCER][None, :].expand(n, k)
        b_ts = (b_p >> 12) - 1
        j_valid = jrep[:, None] & (b_ids >= 0) & (t - b_ts < t_remove) \
            & (b_ids != rows[:, None])
        kmax, pacc = lex(kmax, pacc, torch.where(j_valid, pack_key(b_ids, b_ts),
                                                 0),
                         torch.where(j_valid, b_p, 0))
        if t_remove > 1:
            kmax, pacc = entry(kmax, pacc, ep, torch.zeros_like(rows), t - 1,
                               own_hb0[INTRODUCER].expand(n),
                               jrep & ~is_intro)
        # JOINREQs land in the introducer's row
        r0 = is_intro[:, None]
        kmax, pacc = lex(kmax, pacc, torch.where(r0, q_kf[None, :], 0),
                         torch.where(r0, q_pf[None, :], 0))
        # winners, TREMOVE removal, the metric sums
        occ = kmax > 0
        ids1 = torch.where(occ, kmax & ID_MASK, -1)
        ts1 = torch.where(occ, (pacc >> 12) - 1, 0)
        hb1 = torch.where(occ, (pacc & 0xFFF) - 1, 0)
        stale = (ids1 >= 0) & (t - ts1 >= t_remove) & ops[:, None]
        subj_failed = sc.window_failed(ids1.clamp(min=0), t)
        ids = torch.where(stale, -1, ids1)
        hb = torch.where(stale, 0, hb1)
        ts = torch.where(stale, 0, ts1)
        removals, false_removals = stale.sum(), (stale & ~subj_failed).sum()
        victim_slots = ((ids >= 0) & subj_failed & ~stale).sum()
        adds = ((ids1 != ids0) & (ids1 >= 0)).sum()
        view_slots = (ids >= 0).sum()

        # join sends
        jreq_sent = starting & ~is_intro
        jrep_sent = jreq
        drop_on = cfg.get("drop_msg") and \
            cfg["drop_open_tick"] < t <= cfg["drop_close_tick"]
        if drop_on:
            jreq_sent = jreq_sent & ~(mix32(seed32, t, rows,
                                            SALT_JOINREQ_DROP) < drop_thr)
            jrep_sent = jrep_sent & ~(mix32(seed32, t, rows,
                                            SALT_JOINREP_DROP) < drop_thr)
        # re-slot at the end of an epoch's last tick
        if (t + 1) // SLOT_EPOCH != ep:
            ids, hb, ts = _reslot(ids, hb, ts, seed32, (t + 1) // SLOT_EPOCH,
                                  lex)
        # the next tick's sends
        flags = ops[:, None].expand(n, f)
        if drop_on:
            flags = flags & ~(mix32(seed32, t, rows[:, None], fis[None, :],
                                    SALT_GOSSIP_DROP) < drop_thr)
        if sc.powerlaw:
            flags = flags & (fis[None, :] < sc.deg[:, None])
        sent = flags.sum() + jreq_sent.sum() + jrep_sent.sum()
        hold = ~proc & ~failed
        joinreq = jreq_sent | (joinreq if (not proc0 and not failed0)
                               else torch.zeros_like(joinreq))
        joinrep = jrep_sent | (joinrep & hold)
        metrics.append(torch.stack([
            in_group.sum(), view_slots, adds, removals, false_removals,
            victim_slots, torch.full((), -1, device=dev), sent,
            recv + joins_recv]))
    return dict(ids=ids, hb=hb, ts=ts, in_group=in_group, own_hb=own_hb,
                send_flags=flags, joinreq=joinreq, joinrep=joinrep,
                metrics=torch.stack(metrics))


def _reslot(ids, hb, ts, seed: int, epoch: int, lex):
    """Every row's entries into epoch ``epoch``'s slots; where two land
    on one slot the larger (key, payload) wins."""
    n, k = ids.shape
    occ = ids >= 0
    tgt = slot_of(seed, epoch, ids, k)
    key = torch.where(occ, pack_key(ids, ts), 0)
    p = torch.where(occ, pack_th(ts, hb), 0)
    kmax = torch.zeros((n, k), dtype=torch.int64, device=ids.device)
    pacc = torch.zeros_like(kmax)
    for j in range(k):      # slot j's entry moves to its target
        sel = tgt[:, j:j + 1] == torch.arange(k, device=ids.device)[None, :]
        kmax, pacc = lex(kmax, pacc, torch.where(sel, key[:, j:j + 1], 0),
                         torch.where(sel, p[:, j:j + 1], 0))
    on = kmax > 0
    return (torch.where(on, kmax & ID_MASK, -1),
            torch.where(on, (pacc & 0xFFF) - 1, 0),
            torch.where(on, (pacc >> 12) - 1, 0))

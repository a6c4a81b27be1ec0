"""Port copy of ``gossip_protocol_tpu/testing/overlay_oracle.py`` (plain numpy; the
port's config, state and hash helpers).

Scalar oracle for the overlay model: a plain-numpy, loop-based
re-implementation of models/overlay.py's tick semantics, used only for
differential testing at small N.

Because the overlay derives *all* of its randomness and schedules from
pure counter hashing (utils/hash32.py) — XOR exchange masks, the
epoch-rotated global slot map, rotated tiebreaks, drop decisions,
churn membership — this oracle replays the exact device behavior with
no replay harness, and the comparison is bit-exact on the full state
trajectory (tests/test_overlay.py).  It is deliberately slow and
explicit; its only job is to be obviously correct.
"""

from __future__ import annotations

import numpy as np

from ..config import INTRODUCER, SimConfig
from ..models.overlay import degree_thresholds, resolved_dims
from ..ops.overlay_rules import (ID_BITS, SLOT_EPOCH, _SALT_CHURN,
                                 _SALT_CHURN_TICK, _SALT_DEGREE,
                                 _SALT_GOSSIP_DROP, _SALT_JOINREP_DROP,
                                 _SALT_JOINREQ_DROP, _SALT_MASK, _SALT_SLOT)
from ..ops.overlay_rules import pack_th as _pack_th
from ..state import NEVER
from ..utils.hash32 import mix32, threshold32
from .. import worlds

U = np.uint32


class OverlayOracle:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.k, self.f = resolved_dims(cfg)
        n = cfg.n
        self.n = n
        self.seed = U(cfg.seed & 0xFFFFFFFF)
        self.drop_thr = threshold32(cfg.msg_drop_prob)
        self.churn_thr = threshold32(cfg.churn_rate) if cfg.churn_rate > 0 else 0
        self.deg_thr = degree_thresholds(cfg, self.f)

        from fractions import Fraction
        frac = Fraction(cfg.step_rate).limit_denominator(1 << 15)
        self.step_num, self.step_den = frac.numerator, max(frac.denominator, 1)
        self.victim_lo = self.victim_hi = 0
        if cfg.churn_rate <= 0:
            from ..utils.prng import fail_schedule_uniform
            u = fail_schedule_uniform(cfg.seed)
            if cfg.single_failure:
                self.victim_lo = int(u * n) % n
                self.victim_hi = self.victim_lo + 1
            else:
                self.victim_lo = (int(u * n) % n) // 2
                self.victim_hi = self.victim_lo + n // 2
        self.rejoin_after = (cfg.rejoin_after if cfg.rejoin_after is not None
                             else NEVER)
        self.churn_lo = cfg.total_ticks // 4
        self.churn_span = max(cfg.total_ticks // 2, 1)
        self.churn_after = (cfg.rejoin_after if cfg.rejoin_after is not None
                            else 40)

        # --- adversarial failure worlds (worlds.py) -----------------
        self.part_groups = worlds.partition_groups_host(cfg)
        self.part_on = cfg.partition_groups >= 2
        self.part_open, self.part_close = worlds.partition_window(cfg)
        self.asym = bool(cfg.asym_drop)
        self.wave_fail = (worlds.wave_fail_ticks(cfg)
                          if cfg.wave_size > 0 else None)
        self.zombie = bool(cfg.zombie)
        self.flap = cfg.flap_rate > 0
        self.flap_mask = worlds.flap_mask_host(cfg)
        self.flap_anchor = worlds.flap_anchor_host(cfg)
        self.flap_per = max(cfg.flap_period, 1)
        self.flap_down = cfg.flap_down
        _, self.flap_hi = worlds.flap_window(cfg)

        self.t = 0
        self.ids = np.full((n, self.k), -1, np.int32)
        self.hb = np.zeros((n, self.k), np.int32)
        self.ts = np.zeros((n, self.k), np.int32)
        self.in_group = np.zeros(n, bool)
        self.own_hb = np.zeros(n, np.int32)
        self.send_flags = np.zeros((n, self.f), bool)
        self.joinreq = np.zeros(n, bool)
        self.joinrep = np.zeros(n, bool)

    # --- closed-form schedule ---------------------------------------
    def start_of(self, i):
        return i * self.step_num // self.step_den

    def fail_of(self, i):
        if self.churn_thr > 0:
            if i == INTRODUCER or not (
                    int(mix32(self.seed, U(i), U(_SALT_CHURN))) < self.churn_thr):
                return NEVER
            return self.churn_lo + int(
                mix32(self.seed, U(i), U(_SALT_CHURN_TICK))) % self.churn_span
        if self.wave_fail is not None:
            # correlated failure wave: seeded epicenter + radius ramp
            # replaces the scripted draw (worlds.py)
            return int(self.wave_fail[i])
        return (self.cfg.fail_tick
                if self.victim_lo <= i < self.victim_hi else NEVER)

    def rejoin_of(self, i):
        fail = self.fail_of(i)
        after = self.churn_after if self.churn_thr > 0 else self.rejoin_after
        return fail + after if (fail != NEVER and after != NEVER) else NEVER

    def flap_state(self, i, t):
        """(failed, rejoining) under the flap world (worlds.py
        flap_state_host semantics, from the precomputed arrays)."""
        if not self.flap or not bool(self.flap_mask[i]):
            return False, False
        anchor = int(self.flap_anchor[i])
        pos = t - anchor
        if pos < 1:
            return False, False
        c = pos // self.flap_per
        off = pos - c * self.flap_per
        if anchor + c * self.flap_per + self.flap_down > self.flap_hi:
            return False, False
        return (1 <= off <= self.flap_down), off == self.flap_down

    def window_failed(self, i, t):
        """The scripted/churn/wave fail-window component alone — the
        failures the zombie world applies to."""
        return self.fail_of(i) < t <= self.rejoin_of(i)

    def failed(self, i, t):
        return self.window_failed(i, t) or self.flap_state(i, t)[0]

    def rejoining(self, i, t):
        return self.rejoin_of(i) == t or self.flap_state(i, t)[1]

    def drop_active(self, t):
        return (self.cfg.drop_msg
                and self.cfg.drop_open_tick < t <= self.cfg.drop_close_tick)

    def part_active(self, t):
        return self.part_on and self.part_open < t <= self.part_close

    def cross_group(self, i, j):
        return self.part_on and \
            int(self.part_groups[i]) != int(self.part_groups[j])

    def link_thr(self, i, j):
        """Per-link drop threshold of link i -> j (asym world): mean
        ``drop_thr``, uniform in [0, 2*thr) — the i*N+j hash input
        wraps in uint32 exactly like the device path."""
        two = (U(self.drop_thr) * U(2)) & U(0xFFFFFFFF)
        h = int(mix32(self.seed, U(i) * U(self.n) + U(j), U(worlds.SALT_LINK)))
        return h % max(int(two), 1)

    # --- protocol pieces --------------------------------------------
    def slot(self, epoch, j):
        """Global slot of subject ``j`` during slot epoch ``epoch``."""
        return int(mix32(self.seed, U(epoch), U(np.uint32(j)),
                         U(_SALT_SLOT)) % self.k)

    def key(self, t, r, j, ts):
        """Freshness-majorized slot key (models/overlay.py _pack_key):
        (ts+1) << ID_BITS | id — receiver-independent; ``t``/``r``
        kept in the signature for call-site symmetry."""
        return ((ts + 1) << ID_BITS) | j

    def key_direct(self, t, j, ts):
        """A direct self-entry / JOINREQ carries the same key; its
        merge-time-maximal ts is the structural boost."""
        return self.key(t, 0, j, ts)

    def mask(self, t, fi):
        return int(mix32(self.seed, U(np.uint32(t & 0xFFFFFFFF)), U(fi),
                         U(_SALT_MASK)) % U(self.n - 1)) + 1

    # --- one tick ---------------------------------------------------
    def step(self):
        t = self.t
        n, k, f = self.n, self.k, self.f
        T = self.cfg.t_remove
        epoch = t // SLOT_EPOCH          # layout of all tables this tick
        proc = np.array([t > self.start_of(i) and not self.failed(i, t)
                         for i in range(n)])
        rejoining = np.array([self.rejoining(i, t) for i in range(n)])

        # churn wipe
        for i in np.flatnonzero(rejoining):
            self.ids[i] = -1
            self.hb[i] = 0
            self.ts[i] = 0
            self.in_group[i] = False
            self.own_hb[i] = 0

        # candidates per receiver: (slot, subject, hb, ts) — incoming
        # tables are slotted by the same global map, so a table entry's
        # slot is its own position; the partner self-entry hashes in
        cands = [[] for _ in range(n)]
        recv = 0
        for fi in range(f):
            m = self.mask(t - 1, fi)
            for r in range(n):
                p = r ^ m
                if not (self.send_flags[p, fi] and proc[r]):
                    continue
                recv += 1
                for q in range(k):
                    if self.ids[p, q] >= 0:
                        cands[r].append((q, int(self.ids[p, q]),
                                         int(self.hb[p, q]),
                                         int(self.ts[p, q]), False))
                if self.zombie and self.window_failed(p, t - 1):
                    # zombie world: a window-failed sender's message
                    # carries a FROZEN heartbeat — no direct self-entry
                    # credit; its stale table rows merged above
                    continue
                cands[r].append((self.slot(epoch, p), p,
                                 int(self.own_hb[p]), t - 1, True))

        # JOINREP consumption
        jrep = self.joinrep & proc
        for r in np.flatnonzero(jrep):
            for q in range(k):
                if self.ids[INTRODUCER, q] >= 0:
                    cands[r].append((q, int(self.ids[INTRODUCER, q]),
                                     int(self.hb[INTRODUCER, q]),
                                     int(self.ts[INTRODUCER, q]), False))
            if not (self.zombie and self.window_failed(INTRODUCER, t - 1)):
                cands[r].append((self.slot(epoch, INTRODUCER), INTRODUCER,
                                 int(self.own_hb[INTRODUCER]), t - 1, True))
            recv += 1
        in_group = self.in_group | jrep

        # JOINREQ at the introducer
        jreq = self.joinreq & proc[INTRODUCER]
        recv += int(jreq.sum())
        for j in np.flatnonzero(jreq):
            if j != INTRODUCER:
                cands[INTRODUCER].append((self.slot(epoch, int(j)),
                                          int(j), 1, t, True))

        # merge: per-slot max of the packed priority key; among equal
        # keys the winner payload is the max packed _pack_th(ts, hb)
        # — the lexicographic (ts, hb) maximum, as on device
        def pack_th(ts, hb):
            return int(_pack_th(ts, hb))

        new_ids = self.ids.copy()
        new_hb = self.hb.copy()
        new_ts = self.ts.copy()
        for r in range(n):
            best = {}
            for (sl, j, hb, ts, direct) in cands[r]:
                if not (t - ts < T) or j == r or j < 0:
                    continue
                kkey = (self.key_direct(t, j, ts) if direct
                        else self.key(t, r, j, ts))
                p = pack_th(ts, hb)
                cur = best.get(sl)
                if cur is None or kkey > cur[0]:
                    best[sl] = [kkey, p]
                elif kkey == cur[0]:
                    cur[1] = max(cur[1], p)
            for sl, (kkey, p) in best.items():
                if self.ids[r, sl] >= 0:
                    ckey = self.key(t, r, int(self.ids[r, sl]),
                                    int(self.ts[r, sl]))
                    if ckey > kkey:
                        continue
                    if ckey == kkey:
                        p = max(p, pack_th(int(self.ts[r, sl]),
                                           int(self.hb[r, sl])))
                new_ids[r, sl] = kkey & ((1 << ID_BITS) - 1)
                new_ts[r, sl] = (p >> 12) - 1
                new_hb[r, sl] = (p & 0xFFF) - 1

        # nodeStart / rejoin
        starting = np.array([self.start_of(i) == t for i in range(n)]) | rejoining
        in_group = in_group | (starting & (np.arange(n) == INTRODUCER))
        active = self.drop_active(t)
        part = self.part_active(t)
        joinreq_sent = np.zeros(n, bool)
        for i in np.flatnonzero(starting):
            if i != INTRODUCER:
                thr = self.link_thr(i, INTRODUCER) if self.asym \
                    else self.drop_thr
                drop = active and int(mix32(self.seed, U(t), U(i),
                                            U(_SALT_JOINREQ_DROP))) < thr
                if part and self.cross_group(i, INTRODUCER):
                    drop = True
                joinreq_sent[i] = not drop
        joinrep_sent = np.zeros(n, bool)
        for j in np.flatnonzero(jreq):
            thr = self.link_thr(INTRODUCER, j) if self.asym \
                else self.drop_thr
            drop = active and int(mix32(self.seed, U(t), U(j),
                                        U(_SALT_JOINREP_DROP))) < thr
            if part and self.cross_group(INTRODUCER, j):
                drop = True
            joinrep_sent[j] = not drop

        # detection
        ops = proc & in_group
        self.own_hb = self.own_hb + ops.astype(np.int32)
        removals = 0
        for r in np.flatnonzero(ops):
            for sl in range(k):
                if new_ids[r, sl] >= 0 and t - new_ts[r, sl] >= T:
                    removals += 1
                    new_ids[r, sl] = -1
                    new_hb[r, sl] = 0
                    new_ts[r, sl] = 0

        # slot-map re-roll at the SLOT_EPOCH boundary (every row —
        # layout is global, not protocol activity); contention resolved
        # by the same lexicographic (key, payload) rule
        if (t + 1) // SLOT_EPOCH != epoch:
            nxt = (t + 1) // SLOT_EPOCH
            rm_ids = np.full_like(new_ids, -1)
            rm_hb = np.zeros_like(new_hb)
            rm_ts = np.zeros_like(new_ts)
            for r in range(n):
                best = {}
                for q in range(k):
                    j = int(new_ids[r, q])
                    if j < 0:
                        continue
                    sl = self.slot(nxt, j)
                    kkey = self.key(t, r, j, int(new_ts[r, q]))
                    p = pack_th(int(new_ts[r, q]), int(new_hb[r, q]))
                    cur = best.get(sl)
                    if cur is None or kkey > cur[0]:
                        best[sl] = [kkey, p]
                    elif kkey == cur[0]:
                        cur[1] = max(cur[1], p)
                for sl, (kkey, p) in best.items():
                    rm_ids[r, sl] = kkey & ((1 << ID_BITS) - 1)
                    rm_ts[r, sl] = (p >> 12) - 1
                    rm_hb[r, sl] = (p & 0xFFF) - 1
            new_ids, new_hb, new_ts = rm_ids, rm_hb, rm_ts

        # dissemination: in-flight flags for the next tick.  Zombie
        # world: window-failed in-group peers keep gossiping their
        # frozen tables (self.in_group is still the pre-update vector
        # here — a window-failed peer cannot have joined this tick)
        new_flags = np.zeros((n, f), bool)
        sent = int(joinreq_sent.sum()) + int(joinrep_sent.sum())
        send_rows = set(np.flatnonzero(ops))
        if self.zombie:
            send_rows |= {i for i in range(n)
                          if self.window_failed(i, t) and self.in_group[i]}
        for r in sorted(send_rows):
            deg = f
            if self.cfg.topology == "powerlaw":
                du = int(mix32(self.seed, U(r), U(_SALT_DEGREE)))
                deg = 1 + sum(1 for thr in self.deg_thr if du < int(thr))
            for fi in range(deg):
                partner = r ^ self.mask(t, fi)
                thr = self.link_thr(r, partner) if self.asym \
                    else self.drop_thr
                gdrop = active and int(mix32(self.seed, U(t), U(r), U(fi),
                                             U(_SALT_GOSSIP_DROP))) < thr
                if part and self.cross_group(r, partner):
                    gdrop = True
                if not gdrop:
                    new_flags[r, fi] = True
                    sent += 1

        live_hold = ~proc & ~np.array([self.failed(i, t) for i in range(n)])
        self.joinreq = joinreq_sent | (self.joinreq & (not proc[INTRODUCER])
                                       & (not self.failed(INTRODUCER, t)))
        self.joinrep = joinrep_sent | (self.joinrep & live_hold)

        self.ids, self.hb, self.ts = new_ids, new_hb, new_ts
        self.in_group = in_group
        self.send_flags = new_flags
        self.t += 1
        return dict(sent=sent, recv=recv, removals=removals)

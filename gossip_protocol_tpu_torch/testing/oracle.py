"""Port copy of ``gossip_protocol_tpu/testing/oracle.py`` (plain numpy; the
port's config, state and hash helpers).

Scalar oracle: an exact per-node re-implementation of the reference
protocol, used only for differential testing of the vectorized tick.

This mirrors the reference's observable semantics message-by-message —
including the EmulNet buffer's append order, the reverse-scan swap-pop
consumption order (EmulNet.cpp:151-160), the driver's forward recv /
reverse nodeLoop phases (Application.cpp:121-163), and the canonical
handler effects (MP1Node.cpp:219-362) — so the batched TPU tick can be
checked step-for-step against it on identical drop decisions.

It is deliberately *not* TPU code and deliberately slow (O(N^2) Python
per tick); its only job is to be obviously correct.  The reference's
id<10 merge cap (MP1Node.cpp:245) is intentionally NOT reproduced — it
is a scale bug, invisible at N<=10 except for one-tick-later adds of the
last peer, and the framework must scale past it (SURVEY.md §2.2 quirk 2).

Drop decisions are injected as precomputed masks so oracle and TPU runs
share the exact same randomness.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..config import INTRODUCER, SimConfig
from ..state import NEVER

JOINREQ, JOINREP, GOSSIP = 0, 1, 2


@dataclass
class Entry:
    """MemberListEntry (Member.h:62-81): id is our 0-based peer index."""
    peer: int
    hb: int
    ts: int


@dataclass
class Msg:
    kind: int
    src: int
    dst: int
    payload: list  # copy of sender's member list at send time


@dataclass
class OracleEvents:
    added: list = field(default_factory=list)    # (tick, observer, subject)
    removed: list = field(default_factory=list)  # (tick, observer, subject)


class ReferenceOracle:
    """Step-by-step scalar simulation with reference-identical ordering."""

    def __init__(self, cfg: SimConfig, start_tick, fail_tick,
                 gossip_drop=None, joinreq_drop=None, joinrep_drop=None,
                 rejoin_tick=None, flap_state=None):
        self.cfg = cfg
        n = cfg.n
        self.n = n
        self.start_tick = np.asarray(start_tick)
        self.fail_tick = np.asarray(fail_tick)
        self.rejoin_tick = (np.full(n, NEVER, np.int32)
                            if rejoin_tick is None else np.asarray(rejoin_tick))
        # drop masks indexed [t, ...]; None = no drops
        self.gossip_drop = gossip_drop
        self.joinreq_drop = joinreq_drop
        self.joinrep_drop = joinrep_drop
        # adversarial worlds (worlds.py): zombie rides cfg.zombie; the
        # flap world injects ``flap_state(i, t) -> (failed, rejoining)``
        # (worlds.make_flap_state) — periodic down phases on top of the
        # window schedule, with every up-edge a fresh-nodeStart rejoin
        self.zombie = bool(cfg.zombie)
        self.flap_state = flap_state

        self.t = 0
        self.in_group = np.zeros(n, bool)
        self.own_hb = np.zeros(n, np.int64)
        self.lists: list[list[Entry]] = [[] for _ in range(n)]
        self.queues: list[list[Msg]] = [[] for _ in range(n)]
        self.buffer: list[Msg] = []
        self.sent = np.zeros((n, cfg.total_ticks), np.int32)
        self.recv = np.zeros((n, cfg.total_ticks), np.int32)
        self.events = OracleEvents()

    # --- helpers ----------------------------------------------------
    def window_failed(self, i, t=None) -> bool:
        """The scripted/churn/wave fail-WINDOW component alone — the
        failures the zombie world applies to."""
        t = self.t if t is None else t
        return t > self.fail_tick[i] and t <= self.rejoin_tick[i]

    def failed(self, i) -> bool:
        """Churn extension: failed only inside (fail, rejoin]; flapping
        members add their periodic down phases on top."""
        if self.window_failed(i):
            return True
        return self.flap_state is not None \
            and self.flap_state(i, self.t)[0]

    def flap_rejoining(self, i) -> bool:
        return self.flap_state is not None \
            and self.flap_state(i, self.t)[1]

    def find(self, i, peer):
        for e in self.lists[i]:
            if e.peer == peer:
                return e
        return None

    def send(self, msg: Msg, dropped: bool):
        """ENsend (EmulNet.cpp:87-118): drop or append + account."""
        if len(self.buffer) >= self.cfg.en_buff_size or dropped:
            return
        self.buffer.append(msg)
        self.sent[msg.src, self.t] += 1

    def recv_loop(self, i):
        """ENrecv (EmulNet.cpp:144-177): reverse scan with swap-pop."""
        k = len(self.buffer) - 1
        while k >= 0:
            if k < len(self.buffer) and self.buffer[k].dst == i:
                msg = self.buffer[k]
                self.buffer[k] = self.buffer[-1]
                self.buffer.pop()
                self.queues[i].append(msg)
                self.recv[i, self.t] += 1
            k -= 1

    def add_member(self, i, peer, hb, ts):
        """addMember with dedup + join log (MP1Node.cpp:265-301)."""
        if peer == i or self.find(i, peer) is not None:
            return
        self.lists[i].append(Entry(peer, hb, ts))
        self.events.added.append((self.t, i, peer))

    # --- protocol handlers -----------------------------------------
    def handle(self, i, msg: Msg):
        """recvCallBack (MP1Node.cpp:219-260)."""
        t = self.t
        if msg.kind == JOINREQ:
            self.add_member(i, msg.src, 1, t)
            rep = Msg(JOINREP, i, msg.src, [dataclasses.replace(e) for e in self.lists[i]])
            dropped = bool(self.joinrep_drop[t, msg.src]) if self.joinrep_drop is not None else False
            self.send(rep, dropped)
        elif msg.kind == JOINREP:
            self.add_member(i, msg.src, 1, t)
            self.in_group[i] = True
        elif msg.kind == GOSSIP:
            # zombie world: a message from a window-failed sender
            # carries a FROZEN heartbeat — an old observation, not
            # proof of life — so the direct-sender credit is skipped;
            # its stale payload still merges by the ordinary rules
            if not (self.zombie and self.window_failed(msg.src, t - 1)):
                e = self.find(i, msg.src)
                if e is not None:
                    e.hb += 1
                    e.ts = t
                else:
                    self.add_member(i, msg.src, 1, t)
            for inc in msg.payload:
                node = self.find(i, inc.peer)
                if node is not None:
                    if inc.hb > node.hb:
                        node.hb = inc.hb
                        node.ts = t
                elif inc.peer != i and t - inc.ts < self.cfg.t_remove:
                    self.add_member(i, inc.peer, inc.hb, inc.ts)

    def node_loop_ops(self, i):
        """nodeLoopOps (MP1Node.cpp:335-362)."""
        t = self.t
        self.own_hb[i] += 1
        for k in range(len(self.lists[i]) - 1, -1, -1):
            e = self.lists[i][k]
            if t - e.ts >= self.cfg.t_remove:
                self.events.removed.append((t, i, e.peer))
                del self.lists[i][k]
        for e in list(self.lists[i]):
            g = Msg(GOSSIP, i, e.peer,
                    [dataclasses.replace(x) for x in self.lists[i]])
            dropped = bool(self.gossip_drop[t, i, e.peer]) if self.gossip_drop is not None else False
            self.send(g, dropped)

    # --- driver -----------------------------------------------------
    def step(self):
        """One global tick: mp1Run phases A+B (Application.cpp:121-163)."""
        t = self.t
        n = self.n
        # Churn extension: a rejoined peer comes back to an EMPTY
        # inbox, so traffic addressed to a currently-failed peer that
        # is scheduled to rejoin is dropped (the batched tick drops all
        # traffic to failed receivers).  Messages to permanently-failed
        # peers are left to rot exactly like the reference's buffer
        # (EmulNet.cpp:151) — removing them would perturb the swap-pop
        # consumption order for everyone else without any observable
        # protocol effect.
        if (self.rejoin_tick != NEVER).any() or self.flap_state is not None:
            self.buffer = [
                m for m in self.buffer
                if not ((self.window_failed(m.dst)
                         and self.rejoin_tick[m.dst] != NEVER)
                        or (self.flap_state is not None
                            and self.flap_state(m.dst, self.t)[0]))]
        # phase A: forward order receive
        for i in range(n):
            if t > self.start_tick[i] and not self.failed(i):
                self.recv_loop(i)
        # phase B: reverse order introduce / nodeLoop
        for i in range(n - 1, -1, -1):
            if t == self.start_tick[i] or t == self.rejoin_tick[i] \
                    or self.flap_rejoining(i):
                # nodeStart (MP1Node.cpp:67-154); a churned peer's
                # rejoin — and every flap up-edge — re-initializes
                # like initThisNode first
                if t == self.rejoin_tick[i] or self.flap_rejoining(i):
                    self.lists[i] = []
                    self.queues[i] = []
                    self.in_group[i] = False
                    self.own_hb[i] = 0
                if i == INTRODUCER:
                    self.in_group[i] = True
                else:
                    req = Msg(JOINREQ, i, INTRODUCER, [])
                    dropped = bool(self.joinreq_drop[t, i]) if self.joinreq_drop is not None else False
                    self.send(req, dropped)
            elif t > self.start_tick[i] and not self.failed(i):
                # nodeLoop (MP1Node.cpp:176-193)
                q = self.queues[i]
                self.queues[i] = []
                for msg in q:
                    self.handle(i, msg)
                if self.in_group[i]:
                    self.node_loop_ops(i)
            elif self.zombie and self.window_failed(i) and self.in_group[i]:
                # zombie world: a window-failed in-group peer keeps
                # gossiping its FROZEN table — no inbox drain, no
                # heartbeat increment, no removal scan, just the
                # full-list sends with the list frozen at its fail tick
                for e in list(self.lists[i]):
                    g = Msg(GOSSIP, i, e.peer,
                            [dataclasses.replace(x) for x in self.lists[i]])
                    dropped = bool(self.gossip_drop[t, i, e.peer]) \
                        if self.gossip_drop is not None else False
                    self.send(g, dropped)
        self.t += 1

    def run(self, ticks=None):
        for _ in range(ticks if ticks is not None else self.cfg.total_ticks):
            self.step()
        return self

    # --- inspection -------------------------------------------------
    def known_matrix(self) -> np.ndarray:
        m = np.zeros((self.n, self.n), bool)
        for i, lst in enumerate(self.lists):
            for e in lst:
                m[i, e.peer] = True
        return m

    def table(self, what: str) -> np.ndarray:
        m = np.zeros((self.n, self.n), np.int64)
        for i, lst in enumerate(self.lists):
            for e in lst:
                m[i, e.peer] = getattr(e, what)
        return m

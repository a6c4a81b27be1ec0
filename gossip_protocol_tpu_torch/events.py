"""Ordered event stream reconstruction (copy of ``gossip_protocol_tpu/events.py``).

Plain numpy over the host event masks; the port keeps its own copy so it
never imports the JAX package (whose ``state.NEVER`` pulls JAX).

The dbg.log grammar is an external API — Grader.sh greps it
(Grader.sh:40-189) — so the framework reproduces it exactly from the
tick function's dense event masks.  Line *order* inside a tick follows
the reference's main loop: phase B walks nodes in reverse index order
(Application.cpp:138-163), each node logs its adds (checkMessages) before
its removes (nodeLoopOps), node 0 emits the ``@@time=`` heartbeat line
after its nodeLoop every 500 ticks (Application.cpp:156-160), and the
scripted failure lines come last, from ``fail()`` (Application.cpp:181-196).

Within one node's tick the reference's add order depends on EmulNet
queue order; we canonicalize to ascending subject id (the observed order
for the common paths) — Grader.sh sorts lines, so this is not
grader-visible.  Removes are emitted in descending subject order,
matching the reference's reverse list scan (MP1Node.cpp:339).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .addressing import addr_str
from .config import INTRODUCER, SimConfig
from .state import NEVER


@dataclass
class LogEvent:
    """One dbg.log line: ``\\n <addr> [tick] <text>``  (Log.cpp:97-99)."""
    observer: Optional[int]  # peer index, or None for the blank-address quirk
    tick: int
    text: str


def event_stream(cfg: SimConfig, start_tick: np.ndarray, fail_tick: np.ndarray,
                 added: np.ndarray, removed: np.ndarray,
                 first_tick: int = 0,
                 include_boot: Optional[bool] = None,
                 rejoin_tick: Optional[np.ndarray] = None) -> Iterator[LogEvent]:
    """Yield the run's dbg.log events in reference order.

    Args:
      cfg:        scenario config.
      start_tick: i32[N] introduction ticks (Application.cpp:143).
      fail_tick:  i32[N] failure ticks (NEVER sentinel = never fails).
      added:      bool[T, N, N] — added[t, i, j]: observer i logged a
                  join for subject j during (absolute) tick
                  ``first_tick + t``.
      removed:    bool[T, N, N] — ditto for removals.
      first_tick: absolute tick of ``added[0]`` — nonzero when the run
                  segment was resumed from a checkpoint.
      include_boot: emit the per-node "APP" boot lines.  Default: for
                  non-empty segments starting at tick 0 — a fresh run
                  and a run resumed from a tick-0 checkpoint both get
                  them exactly once, while a zero-length segment or a
                  mid-run continuation never duplicates them.
      rejoin_tick: i32[N] churn-extension rejoin ticks (NEVER = stays
                  dead); a rejoining peer logs a fresh nodeStart line
                  and resumes observing from the next tick.
    """
    n = cfg.n
    t_total = added.shape[0]
    if rejoin_tick is None:
        rejoin_tick = np.full(n, NEVER, np.int32)

    # "APP" boot lines: one per node at construction time, forward order
    # (Application.cpp:59-69), stamped with tick 0.
    emit_boot = include_boot if include_boot is not None \
        else (first_tick == 0 and t_total > 0)
    if emit_boot:
        for i in range(n):
            yield LogEvent(i, 0, "APP")

    for t in range(first_tick, first_tick + t_total):
        for i in range(n - 1, -1, -1):
            if t == start_tick[i] or t == rejoin_tick[i]:
                # nodeStart logs (MP1Node.cpp:126-144); a churned
                # peer's rejoin is a fresh nodeStart
                if i == INTRODUCER:
                    yield LogEvent(i, t, "Starting up group...")
                else:
                    yield LogEvent(i, t, "Trying to join...")
            elif (t > start_tick[i] and t <= fail_tick[i]) \
                    or t > rejoin_tick[i]:
                for j in np.nonzero(added[t - first_tick, i])[0]:
                    yield LogEvent(
                        i, t, f"Node {addr_str(j)} joined at time {t}")
                for j in np.nonzero(removed[t - first_tick, i])[0][::-1]:
                    yield LogEvent(
                        i, t, f"Node {addr_str(j)} removed at time {t}")
                if i == 0 and t % 500 == 0:
                    yield LogEvent(i, t, f"@@time={t}")
        if t == cfg.fail_tick:
            # "Node failed" lines, logged with the *failed node's own*
            # address (Application.cpp:184,192).  Note the single- and
            # multi-failure format strings differ by spaces around '='.
            victims = np.nonzero(fail_tick == t)[0]
            for i in victims:
                if cfg.single_failure:
                    yield LogEvent(int(i), t, f"Node failed at time={t}")
                else:
                    yield LogEvent(int(i), t, f"Node failed at time = {t}")


def grader_view(events) -> dict:
    """Digest an event stream into the facts Grader.sh checks.

    Returns dict with:
      joins:    set of (observer, subject) pairs from "joined" lines
      removals: set of (observer, subject) pairs from "removed" lines
      removal_ticks: dict (observer, subject) -> first removal tick
      failed:   set of failed peer indices
    """
    joins, removals, failed = set(), set(), set()
    removal_ticks = {}
    from .addressing import parse_addr
    for ev in events:
        if "joined at time" in ev.text:
            subj = parse_addr(ev.text.split()[1])
            joins.add((ev.observer, subj))
        elif "removed at time" in ev.text:
            subj = parse_addr(ev.text.split()[1])
            removals.add((ev.observer, subj))
            removal_ticks.setdefault((ev.observer, subj), ev.tick)
        elif "Node failed at time" in ev.text:
            failed.add(ev.observer)
    return dict(joins=joins, removals=removals,
                removal_ticks=removal_ticks, failed=failed)

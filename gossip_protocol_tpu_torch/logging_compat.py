"""Reference-grammar log writers: dbg.log, stats.log, msgcount.log (copy
of ``gossip_protocol_tpu/logging_compat.py``; byte-identical output).

These files are the reference's observability surface and external API:

* ``dbg.log``    — event log, grep-asserted by Grader.sh.  First line is
  the hex char-sum of the magic string "CS425" (= 0x131, Log.cpp:79-88);
  every event is ``\\n <addr> [tick] <text>`` (Log.cpp:97-99) where
  ``<addr>`` is the dotted byte form with a trailing space (Log.cpp:73).
  Quirk reproduced under ``bug_compat``: the reference's static address
  buffer is not filled on the very first LOG call (the if/else at
  Log.cpp:56-73 skips the sprintf), so the first line's address is blank.
* ``stats.log``  — created empty (no #STATSLOG# producers exist,
  Log.cpp:90-95).
* ``msgcount.log`` — per-node, per-tick (sent, recv) matrix in the exact
  ENcleanup format (EmulNet.cpp:184-220), including the 10-per-line
  wrapping and the bizarre node-67 "special" row.

This module is the grammar's single source of truth on the Python side;
the native runtime carries an independent implementation of the same
grammar (``native/logsink.cc``) used by the C++ engine.
tests/test_native.py asserts msgcount.log byte-compatibility between
the two, and dbg.log compatibility at the event-set and grader level
(within-tick line order can legitimately differ between the engines'
canonical orders, so dbg.log is not byte-compared).
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from .addressing import addr_str
from .events import LogEvent

MAGIC_NUMBER = "CS425"  # Log.h:19
DBG_LOG = "dbg.log"
STATS_LOG = "stats.log"
MSGCOUNT_LOG = "msgcount.log"


def magic_line() -> str:
    """Hex char-sum of the magic string: "131" (Log.cpp:80-86)."""
    return "%x" % sum(ord(c) for c in MAGIC_NUMBER)


def format_events(events: Iterable[LogEvent], bug_compat: bool = True) -> str:
    """Render an event stream to the dbg.log byte grammar."""
    parts = [magic_line(), "\n"]
    first = True
    for ev in events:
        addr = "" if (first and bug_compat) else addr_str(ev.observer) + " "
        parts.append(f"\n {addr}[{ev.tick}] {ev.text}")
        first = False
    return "".join(parts)


def write_dbg_log(events: Iterable[LogEvent], outdir: str = ".",
                  bug_compat: bool = True) -> str:
    path = os.path.join(outdir, DBG_LOG)
    text = format_events(events, bug_compat)
    with open(path, "w") as f:
        f.write(text)
    # stats.log is opened alongside dbg.log and stays empty (Log.cpp:66-67)
    open(os.path.join(outdir, STATS_LOG), "w").close()
    return path


def format_msgcount(sent: np.ndarray, recv: np.ndarray) -> str:
    """Render the (N, T) counters in ENcleanup's format (EmulNet.cpp:195-216).

    ``sent``/``recv`` are indexed by 0-based peer; rows print as 1-based
    node ids.  T is the final clock value (loop bound at exit).
    """
    n, t_total = sent.shape
    out = []
    for i in range(n):
        node_id = i + 1
        out.append("node %3d " % node_id)
        sent_total = recv_total = 0
        for j in range(t_total):
            sent_total += int(sent[i, j])
            recv_total += int(recv[i, j])
            if node_id != 67:
                out.append(" (%4d, %4d)" % (sent[i, j], recv[i, j]))
                if j % 10 == 9:
                    out.append("\n         ")
            else:
                out.append("special %4d %4d %4d\n" % (j, sent[i, j], recv[i, j]))
        out.append("\n")
        out.append("node %3d sent_total %6u  recv_total %6u\n\n"
                   % (node_id, sent_total, recv_total))
    return "".join(out)


def write_msgcount_log(sent: np.ndarray, recv: np.ndarray,
                       outdir: str = ".") -> str:
    path = os.path.join(outdir, MSGCOUNT_LOG)
    with open(path, "w") as f:
        f.write(format_msgcount(sent, recv))
    return path

"""Write-ahead journal: the append-only record of one serving run (port
of ``gossip_protocol_tpu/store/journal.py``; the same records, so each
package reads the other's journal).

One JSONL file (``<run_dir>/journal.jsonl``), one record per line,
flushed per append so a process death loses at most the line being
written (the tolerant reader below skips a torn tail).  Everything
the service does that matters for recovery is journaled:

* ``meta``    — service parameters at construction (batching, pad
  policy, checkpoint cadence).  Wall-clock policies (``max_wait_s``,
  deadlines) are deliberately NOT persisted: they are meaningless
  across a process death and must be re-chosen by the recovering
  caller.
* ``submit``  — one per admitted request: rid, the full config
  (``SimConfig.to_dict``), mode, priority class, tenant.
* ``cut``     — one per checkpointed lane per leg: rid, the cut's
  absolute clock, legs so far, and the snapshot's content address in
  the spill tier (store/spill.py).
* ``fault``   — every fault the injector actually fired (attempt
  index + kind).  The fault plane is already a pure function of
  ``(seed, attempt index)`` (service/faults.py), so this is
  observability, not state — recovery never replays faults.
* ``outcome`` — one per terminal request: status plus a content
  digest of the delivered result (service/replay.result_digest), so
  a recovered run can prove bit-parity for requests that completed
  BEFORE the death without their results surviving it.
* ``recover`` — appended by each recovery pass: how many requests
  were re-admitted and how many resumed from a spilled cut.

No timestamps anywhere: the journal is a pure record of decisions,
identical for identical request streams, which keeps it diffable and
keeps recovery deterministic.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class Journal:
    """Append-only JSONL writer over one run directory's journal."""

    FILENAME = "journal.jsonl"

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, self.FILENAME)
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        #: records appended by THIS process (an append-only file can
        #: carry records from the run that died; those are the
        #: reader's business, not this counter's)
        self.records_appended = 0

    def _append(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True,
                                 separators=(",", ":")) + "\n")
        # flush to the OS so the record survives os._exit / SIGKILL
        # of this process (page-cache durability — the crash model
        # here is process death, not power loss)
        self._f.flush()
        self.records_appended += 1

    def meta(self, service: dict) -> None:
        self._append({"rec": "meta", "version": 1, "service": service})

    def submit(self, req) -> None:
        self._append({"rec": "submit", "rid": req.rid,
                      "cfg": req.cfg.to_dict(), "mode": req.mode,
                      "priority": req.priority, "tenant": req.tenant})

    def cut(self, rid: int, tick: int, legs: int, digest: str) -> None:
        self._append({"rec": "cut", "rid": rid, "tick": int(tick),
                      "legs": int(legs), "digest": digest})

    def fault(self, idx: int, kind: str) -> None:
        self._append({"rec": "fault", "idx": int(idx), "kind": kind})

    def outcome(self, rid: int, status: str, result=None,
                error: Optional[str] = None) -> None:
        rec = {"rec": "outcome", "rid": rid, "status": status}
        if result is not None:
            from ..service.replay import result_digest
            rec["digest"] = result_digest(result)
        if error is not None:
            rec["error"] = error
        self._append(rec)

    def recover_mark(self, resumed: int, readmitted: int,
                     warmed_buckets: int = 0) -> None:
        self._append({"rec": "recover", "resumed": int(resumed),
                      "readmitted": int(readmitted),
                      "warmed_buckets": int(warmed_buckets)})

    def close(self) -> None:
        self._f.close()


def read_journal(path: str) -> list:
    """All records of a run's journal, in append order.

    ``path`` may be the journal file or its run directory.  A torn
    final line (the process died mid-append) is skipped; a torn line
    anywhere ELSE is corruption and raises — silently dropping
    interior records would un-admit requests.
    """
    if os.path.isdir(path):
        path = os.path.join(path, Journal.FILENAME)
    records = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail: the append the death interrupted
            raise ValueError(
                f"corrupt journal record at {path}:{i + 1} (not the "
                f"final line — this is file corruption, not a torn "
                f"append): {line[:80]!r}")
    return records

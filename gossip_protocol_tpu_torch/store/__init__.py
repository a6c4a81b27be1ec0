"""Durability subsystem: spill tier + write-ahead journal + recovery (port
of ``gossip_protocol_tpu/store/``).

Everything the fleet service needs to survive a process
death: :class:`RunStore` bundles one run directory's two durable
artifacts — the content-addressed checkpoint spill tier
(store/spill.py) and the append-only journal (store/journal.py) —
and ``FleetService(run_dir=...)`` writes through both as it serves.
``FleetService.recover(run_dir)`` (store/recovery.py) then rebuilds
a fresh service from the journal alone, resuming every non-terminal
request from its last spilled cut with zero restarted lanes.

Run directory layout::

    <run_dir>/journal.jsonl        append-only decision record
    <run_dir>/spill/<digest>.npz   one file per checkpoint cut

Host numpy + file IO only.  The journal records and the spill files
are the JAX package's layout, so either package recovers the other's
run directory.
"""

from __future__ import annotations

import os

from .journal import Journal, read_journal
from .spill import (CheckpointStore, CheckpointValidationError,
                    SpilledCheckpoint, inspect_spill, verify_spill)


class RunStore:
    """One serving run's durable state: journal + checkpoint store.

    The scheduler's single durability handle (``FleetService.store``):
    ``put`` journals a cut and admits its snapshot to the spill tier,
    ``materialize`` turns a queued request's lightweight proxy back
    into a dispatchable snapshot, and ``stats`` is what
    ``FleetService.stats()["durability"]`` reports.
    """

    def __init__(self, run_dir: str, max_ram_snapshots: int = 64,
                 policy: str = "eager"):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.journal = Journal(run_dir)
        self.checkpoints = CheckpointStore(
            os.path.join(run_dir, "spill"),
            max_ram_snapshots=max_ram_snapshots, policy=policy)
        self.recoveries = 0
        self.recovered_requests = 0

    def put(self, rid: int, ck) -> SpilledCheckpoint:
        """Durably record one checkpoint cut: spill the snapshot
        (write-through under the default eager policy), journal the
        cut, return the proxy the request queues with."""
        ref = self.checkpoints.ref(ck)
        self.journal.cut(rid, ref.tick, ref.legs, ref.digest)
        return ref

    def materialize(self, ck):
        return self.checkpoints.materialize(ck)

    def stats(self) -> dict:
        out = dict(self.checkpoints.stats())
        out["journal_records"] = self.journal.records_appended
        out["recoveries"] = self.recoveries
        out["recovered_requests"] = self.recovered_requests
        out["run_dir"] = self.run_dir
        return out


from .recovery import recover_service  # noqa: E402  (needs RunStore)

__all__ = [
    "RunStore", "Journal", "read_journal", "CheckpointStore",
    "CheckpointValidationError", "SpilledCheckpoint", "inspect_spill",
    "verify_spill", "recover_service",
]

"""Seeded, deterministic fault injection for the serving layer (port of
``gossip_protocol_tpu/service/faults.py``; the seeded draw is the same
``numpy.random.default_rng((seed, idx))``, so a fault schedule and its
``schedule_digest`` equal the JAX package's for the same seed).

The paper's subject is surviving failure — peers must tolerate message
drops and node crashes with bounded false positives — and the grader
applies that discipline to the *protocol* (the drop10 scenario).  This
module applies the same discipline to the layer that serves it: every
boundary the scheduler crosses on a dispatch (compile, device
dispatch, result unstacking, the mesh itself) can be made to fail on
purpose, from a seed, so chaos runs are replayable regression tests
rather than flakes.

Determinism is the whole design.  A fault decision is a pure function
of ``(seed, attempt_index)`` — drawn from a fresh
``numpy.random.default_rng((seed, idx))``, never from mutable RNG
state — so the i-th dispatch attempt of a replay sees the same fault
no matter what happened around it, and two runs of the same trace with
the same seed produce the identical fault sequence AND the identical
per-request outcomes (pinned by tests/test_torch_resilience.py and the
acceptance gate in service/replay.py ``chaos_replay``).  The service
is single-threaded and its dispatch order is a pure function of the
submit order (no time-based flushes in chaos runs), which closes the
loop.

Fault taxonomy (docs/SERVING.md "Failure model"):

========== =========================================================
kind       injected where / what it simulates
========== =========================================================
compile    raised at the program-build boundary, before the bucket's
           FleetSimulation is even looked up — a failed kernel build
           or a poisoned program cache entry
dispatch   raised between program lookup and execution — a device
           runtime error (the classic transient)
latency    the dispatch completes, then stalls for a deterministic
           extra wait — a slow device / contended host, exercising
           deadline accounting without failing anything
poison     one lane of the finished FleetResult is corrupted
           (message counters forced negative) — a bad result that
           only *validation* can catch (service/resilience.py
           ``validate_lane``)
device_loss raised once, at ``device_loss_at`` — a device dropping
           out; without a lane mesh (the multi-device slice) the
           scheduler retries it like any dispatch failure
device_return fires once, at ``device_return_at`` — a lost device
           coming back.  Not a failure; without a lane mesh there is
           nothing to grow, and the attempt proceeds normally.
           Recorded in :attr:`events` like every fault, so the
           schedule replays digest-for-digest.
========== =========================================================

The injector never touches engine code: it is consulted by
``FleetService._serve_batch`` at each boundary, which keeps the fault
plane a pure serving-layer concern (and keeps solo runs — the
degradation ladder's bottom rung and the parity reference — outside
its reach by construction).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: the injectable fault kinds, in the order the seeded draw indexes
#: them (stable order = stable schedules across code motion)
FAULT_KINDS = ("compile", "dispatch", "latency", "poison")


def _host(a) -> np.ndarray:
    """A lane array as host numpy (a tensor is copied off its device)."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class InjectedFault(RuntimeError):
    """Base of every fault the injector raises (never of the errors
    the resilience layer raises on *detection* — those live in
    service/resilience.py)."""

    kind = "injected"

    def __init__(self, idx: int, detail: str = ""):
        self.idx = idx
        super().__init__(
            f"injected {self.kind} fault at dispatch attempt {idx}"
            + (f": {detail}" if detail else ""))


class InjectedCompileFailure(InjectedFault):
    kind = "compile"


class InjectedDispatchFailure(InjectedFault):
    kind = "dispatch"


class InjectedDeviceLoss(InjectedFault):
    kind = "device_loss"


class FaultInjector:
    """Deterministic fault schedule over dispatch-attempt indices.

    ``fault_rate`` is the per-attempt probability of injecting one of
    ``kinds`` (uniformly); ``device_loss_at`` names ONE attempt index
    that additionally raises a device loss (it wins over the seeded
    draw at that index).  ``schedule`` pins explicit
    ``{attempt_index: kind}`` decisions instead of the seeded draw —
    the unit-test mode, equally deterministic.

    The injector records every injected fault in :attr:`events`
    (``(idx, kind)`` in injection order); :meth:`summary` counts them
    per kind and :meth:`schedule_digest` folds events into a short
    stable hash, which the chaos harness compares across two runs of
    the same seed to prove replayability.
    """

    def __init__(self, seed: int = 0, fault_rate: float = 0.0,
                 kinds=FAULT_KINDS, latency_s: float = 0.05,
                 device_loss_at: Optional[int] = None,
                 device_return_at: Optional[int] = None,
                 schedule: Optional[dict] = None):
        if not 0.0 <= fault_rate <= 1.0:
            raise ValueError(f"fault_rate must be in [0, 1], got "
                             f"{fault_rate}")
        unknown = set(kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)}; "
                             f"expected a subset of {FAULT_KINDS}")
        if schedule is not None:
            bad = set(schedule.values()) - set(FAULT_KINDS) \
                - {"device_loss", "device_return"}
            if bad:
                raise ValueError(
                    f"unknown fault kinds in schedule {sorted(bad)}; "
                    f"expected {FAULT_KINDS} + ('device_loss', "
                    "'device_return')")
        self.seed = int(seed)
        self.fault_rate = float(fault_rate)
        self.kinds = tuple(kinds)
        self.base_latency_s = float(latency_s)
        self.device_loss_at = device_loss_at
        #: ONE attempt index at which a lost device returns (the grow
        #: half of the elasticity ladder).  Like ``device_loss_at`` it
        #: wins over the seeded draw at its index — and losing wins
        #: over returning when both name the same index (a return
        #: cannot shadow the loss it answers)
        self.device_return_at = device_return_at
        self.schedule = dict(schedule) if schedule is not None else None
        self.events: list[tuple[int, str]] = []

    # ---- the deterministic draw -------------------------------------
    def _kind(self, idx: int) -> Optional[str]:
        if self.device_loss_at is not None and idx == self.device_loss_at:
            return "device_loss"
        if self.device_return_at is not None \
                and idx == self.device_return_at:
            return "device_return"
        if self.schedule is not None:
            return self.schedule.get(idx)
        if self.fault_rate <= 0.0 or not self.kinds:
            return None
        rng = np.random.default_rng((self.seed, idx))
        if rng.random() >= self.fault_rate:
            return None
        return self.kinds[int(rng.integers(len(self.kinds)))]

    def plan(self, idx: int) -> Optional[str]:
        """The fault (or None) for dispatch attempt ``idx``; injected
        faults are appended to :attr:`events`."""
        kind = self._kind(idx)
        if kind is not None:
            self.events.append((int(idx), kind))
        return kind

    def latency_s(self, idx: int) -> float:
        """Deterministic injected-latency duration for attempt ``idx``
        (0.5x-1.5x the base, drawn from the same seed plane)."""
        rng = np.random.default_rng((self.seed, idx, 1))
        return self.base_latency_s * (0.5 + float(rng.random()))

    def poison(self, fleet, idx: int) -> int:
        """Corrupt one lane of a finished FleetResult (deterministic
        lane choice): its message counters are forced negative — an
        impossible value the scheduler's lane validation must catch
        (service/resilience.py ``validate_lane``).  Returns the
        poisoned lane index.

        The corrupted array is REPLACED on the lane, never written in
        place: a lane's arrays may be views of another lane's host copy
        or of a tensor on the card, and a write into one would corrupt
        what it views instead of poisoning only this lane."""
        rng = np.random.default_rng((self.seed, idx, 2))
        i = int(rng.integers(len(fleet.lanes)))
        lane = fleet.lanes[i]
        if hasattr(lane, "chunks"):     # a LaneCheckpoint (elastic leg)
            # corrupt the leg's OWN chunk only: the retry rebuilds
            # from the PREVIOUS checkpoint, whose chunk list this
            # replacement never touches (core/fleet.py
            # _advance_checkpoints copies the list per leg)
            ch = lane.chunks[-1]
            if hasattr(ch, "sent"):                     # overlay metrics
                lane.chunks[-1] = dataclasses.replace(
                    ch, sent=np.full_like(_host(ch.sent), -1))
            else:                                       # dense trace tuple
                a, r, s, rc = ch
                lane.chunks[-1] = (a, r, np.full_like(_host(s), -1), rc)
        elif hasattr(lane, "metrics"):                  # overlay
            lane.metrics = dataclasses.replace(
                lane.metrics,
                sent=np.full_like(_host(lane.metrics.sent), -1))
        else:                                           # dense SimResult
            lane.sent = np.full_like(_host(lane.sent), -1)
        return i

    # ---- provenance --------------------------------------------------
    def summary(self) -> dict:
        out = {k: 0 for k in FAULT_KINDS
               + ("device_loss", "device_return")}
        for _, kind in self.events:
            out[kind] += 1
        out["total"] = len(self.events)
        return out

    def schedule_digest(self) -> str:
        """Stable short hash of the injected fault sequence — equal
        across two runs iff the same faults fired at the same attempt
        indices."""
        import hashlib
        return hashlib.sha256(repr(self.events).encode()).hexdigest()[:16]

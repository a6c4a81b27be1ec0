"""Checkpoint spill tier: content-addressed npz storage + RAM LRU (port
of ``gossip_protocol_tpu/store/spill.py``; same file layout and digests).

One file per snapshot under ``<run_dir>/spill/<digest>.npz``, keyed
by the snapshot's existing content address
(``core.fleet.LaneCheckpoint.digest`` — clock + config + carry
bytes; the full config, so same-state lanes of different scenario
variants never share an address).  The
layout is the flattened ``(meta, arrays)`` pair of
``core.fleet.checkpoint_arrays``: a ``__header__`` JSON blob (config,
clock, legs, chunk field order, digest, and a sha over every array)
plus one npz entry per state field and per chunk leaf.

Three properties the serving layer leans on:

* **Atomic writes.**  Every spill lands via tmp + ``os.replace``: a
  kill mid-write leaves a dead ``*.tmp.<pid>`` file, never a torn
  ``<digest>.npz`` — recovery either sees a complete spill or none.
* **Validated loads.**  A fetch re-reads the header sha over the raw
  arrays, rebuilds the snapshot, re-derives its digest, and runs
  ``service.resilience.validate_checkpoint`` — a corrupt or
  mislabeled file raises :class:`CheckpointValidationError` carrying
  a single-command repro (``inspect_spill``) instead of re-entering a
  fleet.
* **Spill-before-evict.**  The in-RAM snapshot map is a bounded LRU;
  under the default eager policy every ``put`` is write-through (the
  durability contract for crash recovery), and under ``lazy`` the
  spill happens at eviction time — either way no snapshot is ever
  dropped from RAM without a bit-identical copy on disk first.

Everything here is host numpy + file IO; the module imports neither
torch nor the fleet at import time, so :func:`inspect_spill` and
:func:`verify_spill` run without a card (and without torch's CUDA).
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

#: spill policies: ``eager`` = write-through on every put (the
#: durability contract — crash recovery needs every cut on disk);
#: ``lazy`` = spill only when the RAM LRU evicts (bounded memory for
#: in-process long runs without the disk traffic)
SPILL_POLICIES = ("eager", "lazy")


class CheckpointValidationError(RuntimeError):
    """A spilled snapshot failed validation on load (corrupt bytes,
    digest mismatch, or an invalid rebuilt checkpoint)."""


def _arrays_sha(arrays: dict) -> str:
    """Content sha over every array (name + shape/dtype + bytes, in
    sorted-name order) — the corruption check ``verify_spill`` runs
    on the raw file, before any checkpoint is rebuilt."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def checkpoint_digest_from_arrays(meta: dict, arrays: dict) -> str:
    """``LaneCheckpoint.digest`` recomputed from the FLAT spill form
    (clock + full config + carry bytes — chunks are covered by the
    file sha).

    Mirrors core/fleet.py ``LaneCheckpoint.digest`` byte for byte
    (pinned by tests/test_torch_durability.py) so the pure-numpy
    inspect path can verify a spill without importing torch.  The config dict
    survives the JSON round trip value-exactly (every ``SimConfig``
    field is a scalar), so sorting its items reproduces the live
    digest's fold.
    """
    h = hashlib.sha256()
    h.update(repr((int(meta["tick"]), meta["mode"])).encode())
    h.update(repr(sorted(meta["cfg"].items())).encode())
    state = sorted(k for k in arrays if k.startswith("state/"))
    for key in state:
        h.update(key.split("/", 1)[1].encode())
        h.update(np.ascontiguousarray(arrays[key]).tobytes())
    return h.hexdigest()[:16]


def save_spill(path: str, meta: dict, arrays: dict) -> int:
    """Atomically write one flattened snapshot; returns bytes written.

    The header gains a ``sha`` over the arrays; the write goes to
    ``<path>.tmp.<pid>`` and lands via ``os.replace`` so a kill at
    any instant leaves either the complete file or none.
    """
    meta = dict(meta)
    meta["sha"] = _arrays_sha(arrays)
    header = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __header__=header, **arrays)
        size = os.path.getsize(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return size


def read_spill(path: str):
    """``(meta, arrays)`` of one spill file — pure numpy, no
    validation (that is :func:`verify_spill`'s job)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__header__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    return meta, arrays


def verify_spill(path: str):
    """Read + verify one spill file; returns ``(meta, arrays)``.

    Checks, in order: readable npz with a header; header sha matches
    the raw arrays (corruption); header digest matches the digest
    recomputed from the carry (mislabeling / content-address drift).
    Pure numpy — :func:`inspect_spill` runs this without torch.
    """
    try:
        meta, arrays = read_spill(path)
    except Exception as e:  # zipfile/json/np errors: all "unreadable"
        raise CheckpointValidationError(
            f"unreadable spill file {path}: {type(e).__name__}: {e}")
    sha = _arrays_sha(arrays)
    if sha != meta.get("sha"):
        raise CheckpointValidationError(
            f"spill file {path} is corrupt: array sha {sha} != "
            f"recorded {meta.get('sha')}")
    digest = checkpoint_digest_from_arrays(meta, arrays)
    if digest != meta.get("digest"):
        raise CheckpointValidationError(
            f"spill file {path} is mislabeled: carry digest {digest} "
            f"!= recorded {meta.get('digest')}")
    return meta, arrays


def inspect_spill(run_dir: str, digest: str) -> dict:
    """One-command verdict on a single spilled snapshot (the repro
    printed by every :class:`CheckpointValidationError`)."""
    path = os.path.join(run_dir, "spill", f"{digest}.npz")
    if not os.path.exists(path):
        return {"digest": digest, "path": path, "ok": False,
                "why": "missing"}
    try:
        meta, arrays = verify_spill(path)
    except CheckpointValidationError as e:
        return {"digest": digest, "path": path, "ok": False,
                "why": str(e)}
    if meta["digest"] != digest:
        return {"digest": digest, "path": path, "ok": False,
                "why": f"file is addressed {digest} but holds "
                       f"{meta['digest']}"}
    return {"digest": digest, "path": path, "ok": True, "why": "",
            "tick": meta["tick"], "legs": meta["legs"],
            "model": meta["model"], "mode": meta["mode"],
            "n_chunks": meta["n_chunks"],
            "bytes": os.path.getsize(path)}


@dataclass
class SpilledCheckpoint:
    """Lightweight stand-in for a stored :class:`LaneCheckpoint`.

    Carries exactly the scalar fields the scheduler reads between
    dispatches (clock, legs, mesh provenance) plus the content
    address; the carry and chunks stay in the store's RAM LRU or on
    disk until a dispatch actually needs them (``load``).  This is
    what makes the RAM bound REAL: a queued request holding a full
    snapshot on ``req.resume`` would defeat any store-side eviction.
    """

    digest: str
    cfg: object
    mode: str
    tick: int
    legs: int
    wall_seconds: float
    mesh_desc: object = None
    _store: "CheckpointStore" = field(default=None, repr=False)

    @property
    def done(self) -> bool:
        return self.tick >= self.cfg.total_ticks

    def load(self):
        """The full snapshot — a RAM hit or a validated disk reload."""
        return self._store.fetch(self.digest)


class CheckpointStore:
    """Content-addressed snapshot store: bounded RAM LRU over a spill
    directory, with the spill-before-evict guarantee."""

    def __init__(self, spill_dir: str, max_ram_snapshots: int = 64,
                 policy: str = "eager"):
        if policy not in SPILL_POLICIES:
            raise ValueError(f"policy must be one of {SPILL_POLICIES}, "
                             f"got {policy!r}")
        if max_ram_snapshots < 1:
            raise ValueError(f"max_ram_snapshots must be >= 1, got "
                             f"{max_ram_snapshots}")
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self.max_ram_snapshots = max_ram_snapshots
        self.policy = policy
        self._ram: OrderedDict = OrderedDict()
        self.spills = 0            # npz files written
        self.spill_bytes = 0       # bytes written to the spill tier
        self.evicted_snapshots = 0  # RAM copies dropped by the LRU
        self.ram_hits = 0
        self.reloads = 0           # validated disk loads
        self.validation_failures = 0

    def _path(self, digest: str) -> str:
        return os.path.join(self.spill_dir, f"{digest}.npz")

    def _spill(self, digest: str, ck) -> None:
        path = self._path(digest)
        if os.path.exists(path):
            return  # content-addressed: same digest, same bytes
        from ..core.fleet import checkpoint_arrays
        meta, arrays = checkpoint_arrays(ck)
        self.spill_bytes += save_spill(path, meta, arrays)
        self.spills += 1

    def ref(self, ck) -> SpilledCheckpoint:
        """Admit a live snapshot to the RAM LRU (evicting under the
        bound, spilling first) and return its lightweight proxy."""
        digest = ck.digest()
        if digest in self._ram:
            self._ram.move_to_end(digest)
        else:
            self._ram[digest] = ck
        if self.policy == "eager":
            self._spill(digest, ck)
        while len(self._ram) > self.max_ram_snapshots:
            old_digest, old_ck = self._ram.popitem(last=False)
            self._spill(old_digest, old_ck)  # spill-before-evict
            self.evicted_snapshots += 1
        return SpilledCheckpoint(
            digest=digest, cfg=ck.cfg, mode=ck.mode, tick=int(ck.tick),
            legs=int(ck.legs), wall_seconds=float(ck.wall_seconds),
            mesh_desc=ck.mesh_desc, _store=self)

    def fetch(self, digest: str):
        """The full snapshot behind a content address.

        RAM hit when the LRU still holds it; otherwise a validated
        disk reload (sha + digest + ``validate_checkpoint``) that
        re-enters the LRU.  Raises :class:`CheckpointValidationError`
        (with the inspect repro) on any validation failure and
        ``FileNotFoundError`` when the address was never spilled.
        """
        ck = self._ram.get(digest)
        if ck is not None:
            self.ram_hits += 1
            self._ram.move_to_end(digest)
            return ck
        path = self._path(digest)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no spilled snapshot {digest} under {self.spill_dir} "
                f"(lazy-policy runs only spill on eviction; crash "
                f"recovery requires policy='eager')")
        try:
            meta, arrays = verify_spill(path)
            from ..core.fleet import checkpoint_from_arrays
            ck = checkpoint_from_arrays(meta, arrays)
            if ck.digest() != digest:
                raise CheckpointValidationError(
                    f"rebuilt snapshot digest {ck.digest()} != "
                    f"address {digest}")
            from types import SimpleNamespace
            from ..service.resilience import validate_checkpoint
            why = validate_checkpoint(
                SimpleNamespace(cfg=ck.cfg, rid=-1), ck)
            if why is not None:
                raise CheckpointValidationError(
                    f"rebuilt snapshot {digest} failed "
                    f"validate_checkpoint: {why}")
        except CheckpointValidationError as e:
            self.validation_failures += 1
            run_dir = os.path.dirname(self.spill_dir) or "."
            raise CheckpointValidationError(
                f"{e}\n  repro: PYTHONPATH=. python -c \"from "
                f"gossip_protocol_tpu_torch.store import inspect_spill; "
                f"print(inspect_spill({run_dir!r}, {digest!r}))\"") from e
        self.reloads += 1
        self._ram[digest] = ck
        while len(self._ram) > self.max_ram_snapshots:
            old_digest, old_ck = self._ram.popitem(last=False)
            self._spill(old_digest, old_ck)
            self.evicted_snapshots += 1
        return ck

    def materialize(self, ck):
        """A real :class:`LaneCheckpoint` for dispatch: proxies are
        fetched (RAM or disk), live snapshots pass through."""
        if isinstance(ck, SpilledCheckpoint):
            return self.fetch(ck.digest)
        return ck

    def stats(self) -> dict:
        return {"spills": self.spills, "spill_bytes": self.spill_bytes,
                "evicted_snapshots": self.evicted_snapshots,
                "ram_snapshots": len(self._ram),
                "max_ram_snapshots": self.max_ram_snapshots,
                "ram_hits": self.ram_hits, "reloads": self.reloads,
                "validation_failures": self.validation_failures,
                "policy": self.policy}

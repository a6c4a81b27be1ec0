"""Program cache: one FleetSimulation per bucket key (port of
``gossip_protocol_tpu/service/cache.py``).

The expensive artifacts — the fleet run closures — already live in the
process-wide ``core.fleet._FLEET_FN_CACHE`` (and the overlay's
``_OVERLAY_FLEET_CACHE``) keyed by (shape key, segment-plan signature,
mesh slot, batch geometry), and every build there moves
``core.tick.run_build_count``.  This cache adds the serving view of the
same thing: bucket key -> the FleetSimulation handle that owns the
bucket's dispatches, plus hit/miss/build counters so the scheduler can
report cache behavior per dispatch ("a mixed trace builds at most once
per distinct bucket key", tests/test_torch_service.py).

``max_entries`` bounds the cache with LRU eviction; evicting a bucket
also drops its run closures from the process caches
(``FleetSimulation.evict_programs``), so the bound frees real memory,
not just the thin handle.  The process caches are shared: evicting a
shape another caller (e.g. the grader) still uses costs that caller one
rebuild — correctness is never affected.

Every handle runs on the cache's ``device`` (``cuda`` unless the caller
asks for ``cpu``).  The lane-mesh handles of the JAX package (and
``rebind_mesh``) come with the multi-device slice, ROADMAP M11.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..config import SimConfig
from ..core.fleet import FleetSimulation
from ..core.tick import run_build_count
from ..state import resolve_device


def _mesh_unported(what: str):
    return NotImplementedError(
        f"{what} needs the lane mesh, which the port gains with the "
        "multi-device slice (ROADMAP M11); serve without mesh=")


class ProgramCache:
    """bucket key -> :class:`~..core.fleet.FleetSimulation` (or its
    canonical subclass for ``"canon"`` keys), LRU-bounded."""

    def __init__(self, chunk_ticks: Optional[int] = None, mesh=None,
                 max_entries: Optional[int] = 64, device=None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1 or None, "
                             f"got {max_entries}")
        if mesh is not None:
            raise _mesh_unported("ProgramCache(mesh=)")
        self.device = resolve_device(device)
        self._chunk_ticks = chunk_ticks
        self.max_entries = max_entries
        # entries are keyed (mesh descriptor, bucket key), the JAX
        # layout; the descriptor is None on one device
        self._sims: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.mesh_rebinds = 0
        self.rekey_hits = 0
        self._builds0 = run_build_count()
        # canonical observability: canonical bucket key -> {"hits":
        # dispatches served, "members": exact bucket keys that would
        # each have been their OWN bucket without canonicalization}
        self._classes: OrderedDict = OrderedDict()

    def _make_sim(self, cfg: SimConfig,
                  canonical: bool = False) -> FleetSimulation:
        if canonical:
            from ..core.fleet import CanonicalFleetSimulation
            return CanonicalFleetSimulation(
                cfg, device=self.device, chunk_ticks=self._chunk_ticks)
        return FleetSimulation(cfg, device=self.device,
                               chunk_ticks=self._chunk_ticks)

    def get(self, key: tuple, cfg: SimConfig,
            members=None) -> FleetSimulation:
        """The bucket's fleet handle (created on first use).

        ``cfg`` seeds the handle's shape on a miss; later calls with
        any same-bucket config return the same handle.  Entries are
        touched LRU-wise; inserting past ``max_entries`` evicts the
        least recently used entry AND its run closures.

        A ``"canon"``-leading ``key`` (service/canonical.py) creates a
        :class:`~..core.fleet.CanonicalFleetSimulation` handle serving
        the whole equivalence class; ``members`` is then the batch's
        EXACT bucket keys (one per lane config), recorded per class so
        :meth:`stats` can report the measured collapse.
        """
        canonical = bool(key) and key[0] == "canon"
        if canonical:
            cls = self._classes.setdefault(
                key, {"hits": 0, "members": set()})
            cls["hits"] += 1
            if members is not None:
                cls["members"].update(members)
        full = (None, key)
        sim = self._sims.get(full)
        if sim is None:
            self.misses += 1
            sim = self._make_sim(cfg, canonical=canonical)
            self._sims[full] = sim
            if self.max_entries is not None \
                    and len(self._sims) > self.max_entries:
                _, old = self._sims.popitem(last=False)
                old.evict_programs()
                self.evictions += 1
        else:
            self.hits += 1
            self._sims.move_to_end(full)
        return sim

    def rebind_mesh(self, mesh, evict: bool = False) -> int:
        raise _mesh_unported("ProgramCache.rebind_mesh")

    def keys(self) -> tuple:
        """The current ``(mesh descriptor, bucket key)`` entries, LRU
        order (oldest first).  Read-only observability: crash recovery
        (store/recovery.py) journals how many bucket handles its
        re-warm pass materialized."""
        return tuple(self._sims)

    @property
    def builds(self) -> int:
        """Whole-run builds observed since this cache was created: a
        process-wide ``run_build_count`` delta — exact when the service
        is the only caller, an upper bound otherwise."""
        return run_build_count() - self._builds0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def class_map(self) -> dict:
        """canonical bucket key -> {"hits", "members"} (members is the
        SET of exact bucket keys served from the class — each one its
        own program without canonicalization, one program now)."""
        return {k: {"hits": v["hits"],
                    "members": frozenset(v["members"])}
                for k, v in self._classes.items()}

    def stats(self) -> dict:
        classes = {
            repr(k): {"hits": v["hits"], "members": len(v["members"])}
            for k, v in self._classes.items()}
        return {"buckets": len(self._sims), "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4),
                "builds": self.builds,
                "evictions": self.evictions,
                "mesh_rebinds": self.mesh_rebinds,
                "rekey_hits": self.rekey_hits,
                "max_entries": self.max_entries,
                "classes": classes,
                "class_member_buckets": sum(
                    len(v["members"]) for v in self._classes.values()),
                "devices": 1}

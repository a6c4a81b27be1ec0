"""Fleet-batched execution: B same-shape simulations in one run (port of
``gossip_protocol_tpu/core/fleet.py``).

Every request to this framework is a (seed x scenario) simulation, and
runs of one config shape are independent lane for lane, so a fleet
steps B of them together at one shared clock.  The per-lane
trajectories stay bit-identical to solo runs (tests/test_torch_fleet.py).

What stands where the JAX package has ``jax.vmap`` of its XLA tick:

* **Lane-axis kernels.**  A dense fleet runs :func:`~.tick.make_fleet_tick`:
  every state and schedule tensor carries a leading lane axis, and the
  K1 route makes three launches a tick for the whole fleet (the drop
  draw, ``masked_max3`` and ``tick_epilogue``, each with a lane axis in
  CUDA; their plain versions on the CPU).  The JAX fleet never runs its
  Pallas kernels (``use_pallas=False``), so the port's fleet takes the
  K1 route at every N, and K2 stays a solo route.  The composable
  worlds (zombie, byz, latency) run their lanes one at a time inside the
  fleet tick (``core/tick.py composable_lanes``, counted).
* **The clock is shared** and stays a host int, as in the solo runs; the
  drop plan (``_shared_drop``) is data (``ops/drop.py LaneDrop``): one
  window row for every lane where the lanes agree, one a lane where
  they do not, never a branch.
* **Overlay fleets** ride K5's lane axis where ``grid_supported`` holds
  (``models/overlay.py make_overlay_fleet_run``), on the card and on the
  CPU alike; elsewhere each lane runs the per-tick route.
* **Trace mode stages events once a chunk**: the sparse device -> host
  encoding (core/sim.py ``_pack_sparse``) runs over the whole
  ``(chunk * n_real, N, N)`` stack.
* **Launch and resolve.**  :meth:`FleetSimulation.launch` enqueues the
  run on the device's stream and records a ``torch.cuda.Event``;
  nothing before :meth:`PendingFleet.resolve` synchronizes the device
  (host tables cross through pinned memory, non-blocking).  Every
  launch that enqueues its run whole, dense or overlay, whole run or
  leg, goes through one protocol, :meth:`FleetSimulation._launch_run`.

There is nothing to compile: the process-wide program cache holds the
built run closures, keyed as the JAX package keys its compiled programs
(the mesh slot, :meth:`FleetSimulation._mesh_entry`, is None on one
device and the mesh descriptor under parallel/fleet_mesh.py's
``MeshFleetSimulation``, so a mesh shrink never finds a stale program),
and its misses count on ``core/tick.py run_build_count``.
:class:`CanonicalFleetSimulation` serves one canonical equivalence class
(service/canonical.py) at its pad-ladder rung.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SimConfig
from ..ops.drop import LaneDrop
from ..state import (SCHED_ARRAYS, WorldState, make_schedule_host,
                     pad_schedule_host, resolve_device, slice_schedule)
from ..utils import spans
from ..utils.threefry import prng_key
from .sim import (SimResult, _finish_masks_host, _pack_sparse, record_event,
                  sparse_cap, to_host_async)
from .tick import TickEvents, make_fleet_tick, note_build


def _shared_drop(cfgs) -> bool:
    """May the fleet share one drop/partition plan across lanes?  (The
    partition window gates sends exactly like the drop window, so it
    rides the same plan.)"""
    c0 = cfgs[0]
    return all((c.drop_msg, c.drop_open_tick, c.drop_close_tick,
                c.msg_drop_prob, c.partition_groups,
                c.partition_open_tick, c.partition_close_tick)
               == (c0.drop_msg, c0.drop_open_tick, c0.drop_close_tick,
                   c0.msg_drop_prob, c0.partition_groups,
                   c0.partition_open_tick, c0.partition_close_tick)
               for c in cfgs[1:])


def _shape(x) -> tuple:
    return tuple(x.shape) if torch.is_tensor(x) else np.shape(x)


def _check_stackable(trees) -> None:
    """Reject mismatched lanes up front, naming lane and field."""
    t0 = trees[0]
    names = [f.name for f in dataclasses.fields(t0)]
    for i, t in enumerate(trees[1:], start=1):
        if type(t) is not type(t0):
            raise ValueError(
                f"lane {i} is a {type(t).__name__}, lane 0 a "
                f"{type(t0).__name__}; fleets stack same-shape lanes only")
        for name in names:
            s0, s = _shape(getattr(t0, name)), _shape(getattr(t, name))
            if s != s0:
                raise ValueError(
                    f"lane {i} field .{name} has shape {s}, but lane 0 "
                    f"has {s0}; fleets stack same-shape lanes only "
                    "(check the lane's config: peer count and tick "
                    "count set these shapes)")


def stack_lanes(trees):
    """Stack same-shape dataclasses on a new leading lane axis: tensors
    with ``torch.stack`` (on their device), every other leaf as numpy."""
    trees = list(trees)
    _check_stackable(trees)
    out = {}
    for f in dataclasses.fields(trees[0]):
        xs = [getattr(t, f.name) for t in trees]
        out[f.name] = torch.stack(xs) if torch.is_tensor(xs[0]) \
            else np.stack([np.asarray(x) for x in xs])
    return dataclasses.replace(trees[0], **out)


def stack_lanes_host(trees):
    """:func:`stack_lanes` semantics on the host alone: every leaf
    stacked in numpy into a CPU tensor, pinned where a card is present,
    so the stacked tree reaches the device by non-blocking copies and
    staging never queues behind a running fleet."""
    trees = list(trees)
    _check_stackable(trees)
    pin = torch.cuda.is_available()
    out = {}
    for f in dataclasses.fields(trees[0]):
        a = np.stack([x.cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x) for x in
                      (getattr(t, f.name) for t in trees)])
        v = torch.from_numpy(np.ascontiguousarray(a))
        out[f.name] = v.pin_memory() if pin else v
    return dataclasses.replace(trees[0], **out)


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory without a sync
    on a card."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _stack_states(states):
    """Stack per-lane states at one clock, keeping the clock a scalar."""
    ticks = {int(s.tick) for s in states}
    if len(ticks) != 1:
        raise ValueError(f"fleet lanes must share one clock, got {ticks}")
    return stack_lanes(states).replace(tick=int(states[0].tick))


def _lane_state(states, i: int):
    """Per-lane view of a stacked state (shared scalar clock)."""
    return type(states)(**{
        f.name: (getattr(states, f.name) if f.name == "tick"
                 else getattr(states, f.name)[i])
        for f in dataclasses.fields(type(states))})


def _state_to_host(states) -> dict:
    """A stacked state's leaves as host numpy (one copy a field)."""
    return {f.name: (getattr(states, f.name).cpu().numpy()
                     if torch.is_tensor(getattr(states, f.name))
                     else np.asarray(getattr(states, f.name)))
            for f in dataclasses.fields(type(states)) if f.name != "tick"}


def fleet_shape_key(cfg: SimConfig):
    """The config bits one fleet run closure bakes in.

    Two configs with equal keys may ride the same fleet: everything else
    (seeds, victim windows, drop probabilities/windows, start ramps)
    flows through the schedules and the drop plan as data.  The overlay
    fixes far more of the config per run (K5's flags, closed-form
    schedule constants), so its lanes must agree on everything but the
    seed.
    """
    if cfg.model == "overlay":
        return ("overlay", cfg.replace(seed=0))
    return ("full_view", cfg.n, cfg.t_remove, cfg.total_ticks,
            cfg.rejoin_after is None, cfg.worlds_key())


def _shape_mismatch(fleet_cfg: SimConfig, lane_cfg: SimConfig) -> str:
    """Name the config fields that break a lane's shape compatibility
    (``field=lane_value != fleet field=fleet_value``)."""
    if lane_cfg.model != fleet_cfg.model:
        return (f"model={lane_cfg.model!r} != fleet "
                f"model={fleet_cfg.model!r}")
    if fleet_cfg.model == "overlay":
        names = [f.name for f in dataclasses.fields(SimConfig)
                 if f.name != "seed"]
    else:
        names = ["max_nnb", "t_remove", "total_ticks",
                 # the adversarial worlds are static tick branches
                 "partition_groups", "partition_open_tick",
                 "partition_close_tick", "asym_drop", "wave_size",
                 "wave_tick", "wave_speed", "zombie", "flap_rate",
                 "flap_period", "flap_down", "flap_open_tick",
                 "flap_close_tick"]
    diffs = [f"{n}={getattr(lane_cfg, n)!r} != fleet "
             f"{n}={getattr(fleet_cfg, n)!r}"
             for n in names
             if getattr(lane_cfg, n) != getattr(fleet_cfg, n)]
    if fleet_cfg.model != "overlay" and \
            (lane_cfg.rejoin_after is None) != (fleet_cfg.rejoin_after is None):
        diffs.append(f"rejoin_after={lane_cfg.rejoin_after!r} != fleet "
                     f"rejoin_after={fleet_cfg.rejoin_after!r}")
    return ", ".join(diffs) or "(keys differ)"


#: fleet run closures, shared across FleetSimulation instances; keys
#: carry the fleet shape key, the segment-plan signature, the mesh slot
#: (None: one device) and the batch geometry.  Misses count on
#: core/tick.py run_build_count.
_FLEET_FN_CACHE: dict = {}


def _fleet_fn(key, builder):
    if key not in _FLEET_FN_CACHE:
        note_build()
        _FLEET_FN_CACHE[key] = builder()
    return _FLEET_FN_CACHE[key]


def _check_unstacked(lanes, n_real: int) -> None:
    """A fleet hands back exactly its real lanes, filler never among
    them."""
    if len(lanes) != n_real:
        raise RuntimeError(
            f"fleet unstacked {len(lanes)} lanes but n_real={n_real}; "
            "filler lanes must never be unstacked into results")


@dataclass
class FleetResult:
    """A finished fleet: per-lane results plus the one shared wall.

    ``lanes`` hold :class:`~.sim.SimResult` (dense model) or
    :class:`~..models.overlay.OverlayResult` (overlay) objects whose
    ``wall_seconds`` is the fleet wall; the aggregate properties are the
    fleet's throughput.  A lane's ``final_state`` is its view of the
    fleet's final state on the fleet's device, as a solo run's is on
    its device; events, counters and metrics are host numpy.  Filler lanes (``n_real``) are never unstacked;
    ``padded_batch`` / ``occupancy`` record the padding.  ``wall_seconds
    == pack_seconds + device_seconds + fetch_seconds``: staging and
    enqueueing the run, the launch's end to the host's wait for it
    returning, and the copy back and unstack.  ``device_seconds`` is
    not the run's device time: when the caller waits late (a pipelined
    service resolving a batch only when a later one displaces it) it
    also holds the wait behind earlier runs on the stream and the time
    the finished run sat before the host came to wait.  The device time
    is the ``fleet.device`` span (utils/spans.py).
    """

    lanes: list
    wall_seconds: float
    padded_batch: int = 0
    device_seconds: float = 0.0
    pack_seconds: float = 0.0
    fetch_seconds: float = 0.0

    @property
    def batch(self) -> int:
        return len(self.lanes)

    @property
    def occupancy(self) -> float:
        """Real-lane fraction of the dispatched run (1.0 unpadded)."""
        width = self.padded_batch or self.batch
        return self.batch / width if width else 0.0

    @property
    def total_node_ticks(self) -> int:
        return sum(r.cfg.n * r.ticks_run for r in self.lanes)

    @property
    def aggregate_node_ticks_per_second(self) -> float:
        if self.wall_seconds <= 0.0:
            return 0.0
        return self.total_node_ticks / self.wall_seconds

    @property
    def node_ticks_per_second_per_run(self) -> float:
        return self.aggregate_node_ticks_per_second / max(self.batch, 1)


@dataclass
class LaneCheckpoint:
    """One lane's resumable snapshot at a segment boundary: host numpy
    only (the lane's carry without the clock, the absolute clock of the
    snapshot, and the per-leg outputs so far), the JAX package's layout,
    so a lane cut in either package resumes in the other.

    ``chunks``: overlay lanes accumulate per-leg ``OverlayMetrics`` of
    numpy ``[leg_ticks]`` fields; dense trace lanes ``(added, removed,
    sent, recv)`` tuples (``[leg_ticks, N, N]`` masks, ``[leg_ticks,
    N]`` counters).  ``mesh_desc`` is the descriptor of the mesh the leg
    ran on (None: one device); it is neither serialized nor digested, as
    in the JAX package, and the serving layer counts a resume on another
    mesh as a lane migration.
    """

    cfg: SimConfig
    mode: str                 # "trace" | "bench"
    tick: int                 # absolute clock of the carry
    state: dict               # {field: np.ndarray}, lane view, no tick
    chunks: list              # accumulated per-leg host outputs
    wall_seconds: float = 0.0
    legs: int = 0
    mesh_desc: object = None

    @property
    def done(self) -> bool:
        return self.tick >= self.cfg.total_ticks

    def digest(self) -> str:
        """Stable short hash of the snapshot (clock, mode, full config,
        carry bytes), over the same bytes in the same order as the JAX
        ``LaneCheckpoint.digest``."""
        h = hashlib.sha256()
        h.update(repr((self.tick, self.mode)).encode())
        h.update(repr(sorted(self.cfg.to_dict().items())).encode())
        for name in sorted(self.state):
            h.update(name.encode())
            h.update(np.ascontiguousarray(self.state[name]).tobytes())
        return h.hexdigest()[:16]


def finish_lane(ck: LaneCheckpoint):
    """Assemble a finished lane's result from its checkpoint (host work
    only): bit-identical to the lane of an uninterrupted fleet run."""
    if not ck.done:
        raise ValueError(
            f"lane at tick {ck.tick} of {ck.cfg.total_ticks} is not "
            "finished; resume it before assembling a result")
    if ck.cfg.model == "overlay":
        from ..models.overlay import (OverlayMetrics, OverlayResult,
                                      make_overlay_schedule)
        from ..ops.overlay_rules import OverlayState
        names = [f.name for f in dataclasses.fields(OverlayMetrics)]
        metrics = OverlayMetrics(**{
            k: np.concatenate([np.asarray(getattr(c, k)) for c in ck.chunks])
            for k in names})
        final = OverlayState(tick=int(ck.tick), **{
            k: torch.from_numpy(np.array(v)) for k, v in ck.state.items()})
        return OverlayResult(cfg=ck.cfg, sched=make_overlay_schedule(ck.cfg),
                             final_state=final, metrics=metrics,
                             wall_seconds=ck.wall_seconds)
    sched = make_schedule_host(ck.cfg)
    added = np.concatenate([c[0] for c in ck.chunks], 0)
    removed = np.concatenate([c[1] for c in ck.chunks], 0)
    sent = np.concatenate([c[2] for c in ck.chunks], 0).T.copy()
    recv = np.concatenate([c[3] for c in ck.chunks], 0).T.copy()
    final = WorldState(tick=int(ck.tick), **{
        k: (np.array(v) if k == "rng" else torch.from_numpy(np.array(v)))
        for k, v in ck.state.items()})
    return SimResult(
        cfg=ck.cfg, start_tick=np.asarray(sched.start_tick),
        fail_tick=np.asarray(sched.fail_tick),
        rejoin_tick=np.asarray(sched.rejoin_tick),
        added=added, removed=removed, sent=sent, recv=recv,
        final_state=final, wall_seconds=ck.wall_seconds)


#: per-chunk array names of a dense trace chunk, in tuple order
_DENSE_CHUNK_FIELDS = ("added", "removed", "sent", "recv")


def checkpoint_arrays(ck: LaneCheckpoint):
    """Flatten one :class:`LaneCheckpoint` into ``(meta, arrays)``, the
    JAX ``checkpoint_arrays`` layout: ``meta`` JSON-safe (config dict,
    clock, legs, chunk field order, digest), ``arrays`` the
    ``state/<field>`` and ``chunk/<j>/<field>`` host arrays."""
    arrays = {f"state/{k}": np.asarray(v) for k, v in ck.state.items()}
    chunk_fields = []
    for j, chunk in enumerate(ck.chunks):
        if dataclasses.is_dataclass(chunk):
            names = tuple(f.name for f in dataclasses.fields(chunk))
            vals = [np.asarray(getattr(chunk, n)) for n in names]
        else:
            names = _DENSE_CHUNK_FIELDS
            vals = [np.asarray(v) for v in chunk]
        chunk_fields.append(list(names))
        for n, v in zip(names, vals):
            arrays[f"chunk/{j}/{n}"] = v
    meta = {"version": 1, "cfg": ck.cfg.to_dict(), "mode": ck.mode,
            "tick": int(ck.tick), "legs": int(ck.legs),
            "wall_seconds": float(ck.wall_seconds),
            "model": ck.cfg.model, "n_chunks": len(ck.chunks),
            "chunk_fields": chunk_fields, "digest": ck.digest()}
    return meta, arrays


def checkpoint_from_arrays(meta: dict, arrays: dict) -> LaneCheckpoint:
    """Inverse of :func:`checkpoint_arrays` (host numpy only); accepts
    what the JAX ``checkpoint_arrays`` writes."""
    cfg = SimConfig.from_dict(meta["cfg"])
    state = {k.split("/", 1)[1]: np.asarray(v)
             for k, v in arrays.items() if k.startswith("state/")}
    chunks = []
    for j in range(meta["n_chunks"]):
        names = meta["chunk_fields"][j]
        vals = [np.asarray(arrays[f"chunk/{j}/{n}"]) for n in names]
        if cfg.model == "overlay":
            from ..models.overlay import OverlayMetrics
            chunks.append(OverlayMetrics(**dict(zip(names, vals))))
        else:
            chunks.append(tuple(vals))
    return LaneCheckpoint(cfg=cfg, mode=meta["mode"],
                          tick=int(meta["tick"]), state=state,
                          chunks=chunks,
                          wall_seconds=float(meta["wall_seconds"]),
                          legs=int(meta["legs"]), mesh_desc=None)


@dataclass
class FleetLeg:
    """One resolved leg of a checkpointed fleet: every real lane
    advanced to the leg's end cut, snapshotted on the host."""

    checkpoints: list
    start: int
    ticks: int
    wall_seconds: float = 0.0
    pack_seconds: float = 0.0
    device_seconds: float = 0.0
    fetch_seconds: float = 0.0
    padded_batch: int = 0

    @property
    def lanes(self) -> list:
        return self.checkpoints

    @property
    def batch(self) -> int:
        return len(self.checkpoints)

    @property
    def occupancy(self) -> float:
        width = self.padded_batch or self.batch
        return self.batch / width if width else 0.0

    @property
    def done(self) -> bool:
        return all(ck.done for ck in self.checkpoints)

    def results(self) -> FleetResult:
        """The final :class:`FleetResult` of a ``done`` leg; its wall is
        the accumulated wall of every leg."""
        lanes = [finish_lane(ck) for ck in self.checkpoints]
        _check_unstacked(lanes, len(self.checkpoints))
        wall = self.checkpoints[0].wall_seconds if self.checkpoints \
            else self.wall_seconds
        for lane in lanes:
            lane.wall_seconds = wall
        return FleetResult(
            lanes=lanes, wall_seconds=wall,
            padded_batch=self.padded_batch
            if len(self.checkpoints) < (self.padded_batch or 0) else 0,
            device_seconds=self.device_seconds,
            pack_seconds=self.pack_seconds,
            fetch_seconds=self.fetch_seconds)


class PendingFleet:
    """An in-flight fleet: the run is enqueued on the device, its results
    not yet fetched.

    :meth:`resolve` waits for the run's event, copies and unstacks the
    results and returns the :class:`FleetResult` (memoized; a failed
    resolution re-raises on every later call).  ``launch(...,
    defer=True)`` stages the lanes without enqueueing the run;
    :meth:`start` enqueues it.  :meth:`is_ready` queries the event
    without blocking.  Nothing here or in the launch synchronizes the
    device before :meth:`wait` / :meth:`resolve`.  ``hold`` keeps the
    staged inputs referenced until resolution.
    """

    def __init__(self, resolve_fn, pack_seconds: float, hold=None,
                 start_fn=None, wait_fn=None, probe_fn=None):
        self._resolve_fn = resolve_fn
        self.pack_seconds = pack_seconds
        self._result: Optional[FleetResult] = None
        self._hold = hold
        self._start_fn = start_fn
        self._wait_fn = wait_fn
        self._probe_fn = probe_fn

    def start(self) -> None:
        """Enqueue the staged run (no-op once started; a failed start is
        retained, so a later call re-raises)."""
        if self._start_fn is not None:
            fn = self._start_fn
            fn()
            self._start_fn = None

    @property
    def started(self) -> bool:
        """True once the run is enqueued (at once for the multi-chunk
        traces, which run inside ``launch``)."""
        return self._start_fn is None

    def is_ready(self) -> bool:
        """True when the run has finished on the device, without
        blocking (False while deferred)."""
        if self._start_fn is not None:
            return False
        if self._wait_fn is None:
            return True
        return bool(self._probe_fn()) if self._probe_fn is not None \
            else False

    def wait(self) -> None:
        """Block until the run has finished on the device (idempotent;
        a failed wait is retained and re-raised)."""
        self.start()
        if self._wait_fn is not None:
            fn = self._wait_fn
            fn()
            self._wait_fn = None

    def resolve(self) -> FleetResult:
        if self._resolve_fn is not None:
            self.wait()
            with spans.span("fleet.fetch"):
                self._result = self._resolve_fn()
            self._resolve_fn = None
            self._hold = None
        return self._result


def _check_end(final, end: int) -> None:
    if final.tick != end:
        raise RuntimeError(
            f"fleet run stopped at tick {final.tick}, expected {end}")


def _timed(res, pack: float, execute: float, fetch: float):
    """``res`` (a :class:`FleetResult` or a :class:`FleetLeg`) with its
    launch's seconds; the wall, their sum, is added onto each lane's (a
    leg's checkpoints carry the wall of their earlier legs)."""
    wall = pack + execute + fetch
    for lane in res.lanes:
        lane.wall_seconds += wall
    res.wall_seconds, res.pack_seconds = wall, pack
    res.device_seconds, res.fetch_seconds = execute, fetch
    return res


class FleetSimulation:
    """Run B same-shape simulations as one fleet, on ``cuda`` unless
    ``device="cpu"``.

    Call :meth:`run` (trace mode / overlay metrics mode) or
    :meth:`run_bench` (dense bench mode) with ``seeds=[...]`` (distinct
    seeds of ``cfg``) or ``configs=[...]`` (same-shape configs, such as
    the grader's three course scenarios, whose differences are all
    schedule data).  Run closures are cached process-wide
    (``_FLEET_FN_CACHE``) per (shape key, segment-plan signature, mode,
    batch width, chunk length), so every FleetSimulation of one shape
    shares one build.

    ``n_real=k`` marks the trailing ``B - k`` lanes as filler: they run
    like any other lane but never enter the event staging and are never
    unstacked into ``FleetResult.lanes``.  Lanes are independent, so
    filler cannot perturb the real lanes.
    """

    #: the drop stream's width (None: the fleet's N); a canonical fleet
    #: draws its lanes' real width inside the rung
    _stream_n: Optional[int] = None
    #: a bench run's merges count their plane descents while spans
    #: record (a mesh's shards do not)
    _counts_merges: bool = True

    def __init__(self, cfg: SimConfig, device=None,
                 chunk_ticks: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chunk_ticks = chunk_ticks
        self._program_keys: set = set()

    def _fleet_program(self, key, builder):
        self._program_keys.add(key)
        return _fleet_fn(key, builder)

    @staticmethod
    def _resolve_n_real(batch: int, n_real) -> int:
        if n_real is None:
            return batch
        if not 1 <= n_real <= batch:
            raise ValueError(
                f"n_real={n_real} must be in [1, {batch}] (the fleet "
                f"dispatched {batch} lanes; filler lanes are the "
                "trailing ones)")
        return int(n_real)

    # ---- lane validation -------------------------------------------
    def _lane_cfgs(self, seeds, configs) -> list[SimConfig]:
        if (seeds is None) == (configs is None):
            raise ValueError("pass exactly one of seeds= or configs=")
        if configs is None:
            configs = [self.cfg.replace(seed=int(s)) for s in seeds]
        configs = list(configs)
        if not configs:
            raise ValueError("empty fleet")
        key = fleet_shape_key(self.cfg)
        for i, c in enumerate(configs):
            if fleet_shape_key(c) != key:
                raise ValueError(
                    f"lane {i} does not share the fleet's compiled "
                    f"shape: {_shape_mismatch(self.cfg, c)}; fleets "
                    "batch same-shape simulations only")
        return configs

    # ---- shared program cache ---------------------------------------
    def _mesh_entry(self):
        """The mesh slot of this fleet's program-cache keys: None on one
        device; parallel/fleet_mesh.py overrides it with the mesh
        descriptor, so a mesh change is a different key."""
        return None

    def _staging_out_shardings(self, state_cls):
        """How a staged stacked state is placed for the run: None here
        (whole on ``self.device``); the mesh subclass returns the spec
        tree its ``shard_map`` splits the state by."""
        return None

    def _key_prefix(self) -> tuple:
        from ..models.segments import plan_signature
        return (fleet_shape_key(self.cfg), plan_signature(self.cfg),
                self._mesh_entry())

    def _cache_key(self, *extra):
        return self._key_prefix() + extra

    def evict_programs(self) -> int:
        """Drop this handle's run closures from the process caches;
        returns how many were evicted (the overlay's by seed-stripped
        config, as the JAX package purges them)."""
        n = 0
        for k in self._program_keys:
            if _FLEET_FN_CACHE.pop(k, None) is not None:
                n += 1
        self._program_keys.clear()
        if self.cfg.model == "overlay" and self._mesh_entry() is None:
            from ..models.overlay import _OVERLAY_FLEET_CACHE
            shape = self.cfg.replace(seed=0)
            stale = [k for k in _OVERLAY_FLEET_CACHE if k[0] == shape]
            for k in stale:
                del _OVERLAY_FLEET_CACHE[k]
            n += len(stale)
        return n

    # ---- the launch protocol ------------------------------------------
    def _launch_run(self, stage, enqueue, finish, end: int, ticks: int,
                    lanes: int, padded: int, defer: bool) -> PendingFleet:
        """Launch one run that is enqueued whole; every launch but a
        multi-chunk trace comes here.

        ``stage()`` builds the run's inputs (timed); ``enqueue(staged)``
        enqueues the run and returns its outputs ``(final state,
        rest)``, and an event is recorded behind them.  At resolution,
        after the wait for that event, the final clock is checked against
        ``end`` and ``finish(staged, final, rest)`` unstacks the
        :class:`FleetResult` or :class:`FleetLeg`, which :func:`_timed`
        gives the launch's seconds: ``pack`` the staging and the enqueue,
        ``execute`` the enqueue's end to the wait's return, ``fetch`` the
        check and ``finish``.  The run is enqueued at once unless
        ``defer``.

        While spans record (utils/spans.py), the launch records under one
        id, each with ``ticks``, ``lanes`` and ``padded`` and, as parent,
        the span open at staging (a service dispatch): ``fleet.stage``,
        ``fleet.enqueue`` (the launches, a block on a full launch queue
        included), ``fleet.fetch`` and ``fleet.device``, the device time
        between two timing events around the enqueue, read after the
        wait (so no synchronization is added) and placed to end when the
        wait returned (:func:`~..utils.spans.device_interval`)."""
        with spans.span("fleet.stage"):
            t0 = time.perf_counter_ns()
            staged = stage()
            t1 = time.perf_counter_ns()
        stage_s = (t1 - t0) / 1e9
        sp = None
        if spans.recording():
            sp = (spans.next_id(), spans.current(),
                  dict(ticks=ticks, lanes=lanes, padded=padded))
            spans.record("fleet.stage", t0, t1, *sp)
        box: dict = {}

        def start():
            ev0 = record_event(self.device, timing=True) if sp else None
            with spans.span("fleet.enqueue"):
                t_s0 = time.perf_counter_ns()
                box["out"] = enqueue(staged)
                box["event"] = record_event(self.device,
                                            timing=sp is not None)
                box["t_launch"] = time.perf_counter_ns()
            box["pack"] = stage_s + (box["t_launch"] - t_s0) / 1e9
            if sp:
                box["ev0"], box["t_s0"] = ev0, t_s0
                spans.record("fleet.enqueue", t_s0, box["t_launch"], *sp)

        def wait():
            if "t_ready" not in box:
                if box["event"] is not None:
                    box["event"].synchronize()
                box["t_ready"] = time.perf_counter_ns()

        def probe():
            return "t_ready" in box or box["event"] is None \
                or box["event"].query()

        def resolve():
            final, rest = box["out"]
            t_f0 = time.perf_counter_ns()
            _check_end(final, end)
            res = finish(staged, final, rest)
            t_f1 = time.perf_counter_ns()
            if sp:
                spans.record("fleet.fetch", t_f0, t_f1, *sp)
                spans.record("fleet.device", *spans.device_interval(
                    box["ev0"], box["event"], box["t_ready"],
                    (box["t_s0"], box["t_launch"])), *sp)
            return _timed(res, box["pack"],
                          (box["t_ready"] - box["t_launch"]) / 1e9,
                          (t_f1 - t_f0) / 1e9)

        pending = PendingFleet(resolve, stage_s, hold=(staged, box),
                               start_fn=start, wait_fn=wait, probe_fn=probe)
        if not defer:
            pending.start()
        return pending

    # ---- dense staging ----------------------------------------------
    def _init_stacked(self, cfgs, width: int) -> WorldState:
        """The stacked tick-0 dense world at ``width``: zero tables and
        each lane's PRNG key."""
        b, dev = len(cfgs), self.device

        def z(*shape, dtype):
            return torch.zeros((b,) + shape, dtype=dtype, device=dev)

        return WorldState(
            tick=0, in_group=z(width, dtype=torch.bool),
            own_hb=z(width, dtype=torch.int32),
            known=z(width, width, dtype=torch.bool),
            hb=z(width, width, dtype=torch.int32),
            ts=z(width, width, dtype=torch.int32),
            gossip=z(width, width, dtype=torch.bool),
            gossip_age=z(width, width, dtype=torch.int32),
            joinreq=z(width, dtype=torch.bool),
            joinrep=z(width, dtype=torch.bool),
            rng=np.stack([prng_key(c.seed) for c in cfgs]))

    def _stage_dense(self, cfgs, scheds, shared: bool):
        """``(stacked schedule on the device, LaneDrop, per-lane device
        schedules or None)``: the per-peer columns and planes stacked on
        the host and copied without a sync; the config scalars are lane
        0's (``fleet_shape_key`` makes the lanes agree on them); the drop
        and partition windows go into the :class:`LaneDrop` plan, one
        row when ``shared``."""
        dev = self.device
        host = stack_lanes_host(scheds)
        sched = scheds[0].replace(**{
            k: getattr(host, k).to(dev, non_blocking=True)
            for k in SCHED_ARRAYS})
        rows = scheds[:1] if shared else scheds
        part = None
        if self.cfg.partition_groups >= 2:
            t = np.arange(len(scheds[0].drop_active))
            part = np.stack([bool(s.part_on) & (s.part_open < t)
                             & (t <= s.part_close) for s in rows])
        drop = LaneDrop(
            keys=np.stack([prng_key(c.seed) for c in cfgs]),
            prob=np.array([s.drop_prob for s in scheds], np.float32),
            active=np.stack([np.asarray(s.drop_active, bool) for s in rows]),
            part=part)
        composable = (self.cfg.zombie or self.cfg.byz_rate > 0
                      or self.cfg.link_latency > 0)
        lanes = None
        if composable:
            lanes = [s.replace(**{k: _to_device(getattr(s, k), dev)
                                  for k in SCHED_ARRAYS}) for s in scheds]
        return sched, drop, lanes

    def _dense_fn(self, mode: str, batch: int, length: int, width: int,
                  shared: bool):
        """The cached run closure ``run(states, staged, counts=None) ->
        (final, TickEvents)`` of ``length`` fleet ticks at ``width``
        (events [L, B, N, N] in trace mode, counters [L, B, W]); every
        tick's merge adds onto ``counts`` (see ``make_fleet_tick``)."""
        def build():
            cfg_w = self.cfg.replace(max_nnb=width)
            trace = mode == "trace"
            tick = make_fleet_tick(cfg_w, with_events=trace,
                                   n_active=self._stream_n)

            def run(states: WorldState, staged, counts=None):
                sched, drop, lanes = staged
                evs = []
                for _ in range(length):
                    states, ev = tick(states, sched, drop, lanes, counts)
                    evs.append(ev)
                return states, _stack_fleet_events(evs, trace, batch, width,
                                                   states.device)

            return run

        return self._fleet_program(
            self._cache_key(mode, batch, length if mode == "trace" else
                            width, shared), build)

    # ---- dense bench ------------------------------------------------
    def run_bench(self, seeds=None, configs=None, warmup: bool = True,
                  n_real: Optional[int] = None) -> FleetResult:
        """Bench-mode fleet: whole runs on the device, one shared timing.
        Mirrors ``Simulation.run_bench`` per lane, the active corner
        included (the bound is config-derived, so every lane shares
        it)."""
        return self.launch_bench(seeds=seeds, configs=configs,
                                 warmup=warmup, n_real=n_real).resolve()

    def launch_bench(self, seeds=None, configs=None, warmup: bool = True,
                     n_real: Optional[int] = None,
                     defer: bool = False) -> PendingFleet:
        """:meth:`run_bench` split at the enqueue: returns a
        :class:`PendingFleet`; with ``defer=True`` the run is staged but
        not enqueued until ``start()``."""
        cfgs = self._lane_cfgs(seeds, configs)
        nr = self._resolve_n_real(len(cfgs), n_real)
        if self.cfg.model == "overlay":
            return self._overlay_launch(cfgs, None, 0, self.cfg.total_ticks,
                                        nr, defer, warmup=warmup)
        from .dense_corner import (_embed_state, active_bound,
                                   bench_stream_width)
        bounds = {active_bound(c) for c in cfgs}
        if len(bounds) != 1:
            raise ValueError(
                f"lanes disagree on the active corner bound {bounds}; "
                "a fleet runs one width")
        a = bounds.pop()
        n = self.cfg.n
        total = self.cfg.total_ticks
        corner = 0 < a < n
        width = a if corner else n
        shared = _shared_drop(cfgs)
        run = self._dense_fn("bench", len(cfgs), total, width, shared)

        def stage():
            scheds = [make_schedule_host(c) for c in cfgs]
            lane_scheds = [slice_schedule(s, a) for s in scheds] \
                if corner else scheds
            return (scheds, self._stage_dense(cfgs, lane_scheds, shared),
                    self._init_stacked(cfgs, width))

        if warmup:            # first-use kernel builds outside the timing
            _, st, states0 = stage()
            run(states0, st)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        m = 2 * nr * width * total

        def enqueue(st):
            # one buffer and one copy to the host: the real lanes' sent /
            # recv rows lane-major [2, nr, W, T], as a lane's result holds
            # them (the host then copies blocks, not transposes), then,
            # while spans record, the merges' counters i64[B, 2] (plane
            # descents and fallbacks, which only the card's kernel adds)
            _, staged, states0 = st
            rec = spans.recording() and self._counts_merges
            buf = torch.empty(m + (4 * len(cfgs) if rec else 0),
                              dtype=torch.int32, device=self.device)
            counts = buf[m:].view(torch.int64).view(-1, 2) if rec else None
            if rec:
                counts.zero_()
            final, ev = run(states0, staged) if counts is None else \
                run(states0, staged, counts)
            rows = buf[:m].view(2, nr, width, total)
            rows[0].copy_(ev.sent[:, :nr].permute(1, 2, 0))
            rows[1].copy_(ev.recv[:, :nr].permute(1, 2, 0))
            return final, to_host_async(buf)

        def finish(st, final, buf_h):
            rows = buf_h[:m].view(2, nr, width, total).numpy()
            if len(buf_h) > m:
                tiles, falls = buf_h[m:].view(torch.int64).view(-1, 2) \
                    .sum(0).tolist()
                spans.count("merge.tiles", tiles)
                spans.count("merge.fallback_tiles", falls)
            lanes = []
            for i, (c, s) in enumerate(zip(cfgs[:nr], st[0][:nr])):
                fs = _lane_state(final, i)
                if corner:
                    fs = _embed_state(fs, n)
                cnt = np.zeros((2, n, total), np.int32)
                cnt[:, :width] = rows[:, i]
                lanes.append(SimResult(
                    cfg=c, start_tick=np.asarray(s.start_tick),
                    fail_tick=np.asarray(s.fail_tick),
                    rejoin_tick=np.asarray(s.rejoin_tick),
                    added=None, removed=None, sent=cnt[0], recv=cnt[1],
                    final_state=fs, wall_seconds=0.0,
                    counter_stream_width=bench_stream_width(c)))
            _check_unstacked(lanes, nr)
            return FleetResult(
                lanes=lanes, wall_seconds=0.0,
                padded_batch=len(cfgs) if nr < len(cfgs) else 0)

        return self._launch_run(stage, enqueue, finish, total, total, nr,
                                len(cfgs), defer)

    # ---- dense trace ------------------------------------------------
    def _chunk(self, length: int, b: int) -> int:
        if self.chunk_ticks is not None:
            return self.chunk_ticks
        per_tick = 2 * self.cfg.n * self.cfg.n * b
        return max(1, min(length, (1 << 30) // max(per_tick, 1)))

    def run(self, seeds=None, configs=None, n_real: Optional[int] = None,
            warmup: bool = True) -> FleetResult:
        """Trace-mode fleet (dense): full event masks for every lane,
        chunked over ticks like ``Simulation.run`` (the chunk budget
        divided by B), the sparse staging once a chunk over the whole
        batch.  Overlay configs run the metrics-mode fleet (``warmup``
        only affects that path)."""
        return self.launch(seeds=seeds, configs=configs, n_real=n_real,
                           warmup=warmup).resolve()

    def _dense_trace_stage_device(self, ev: TickEvents, length: int,
                                  nr: int):
        """Enqueue the device half of one chunk's event staging behind the
        run: the sparse compaction over the real lanes' ``(length * nr,
        N, N)`` stack, and the non-blocking copies of its count and of
        the counters into pinned buffers."""
        n = self.cfg.n
        cap = sparse_cap(length * nr, n)
        a = ev.added[:, :nr].reshape(length * nr, n, n)
        r = ev.removed[:, :nr].reshape(length * nr, n, n)
        packed = _pack_sparse(a, r, cap=cap) \
            if length * nr > 0 and n >= 2 else None
        sr = torch.stack([ev.sent, ev.recv])[:, :, :nr]
        if n <= 8192:
            sr = sr.to(torch.int16)
        nzw_h = None if packed is None else to_host_async(packed[2])
        return (a, r, packed, nzw_h, to_host_async(sr), cap, length)

    def _dense_trace_finish_host(self, staged, nr: int):
        """Host half of one chunk's event staging (after the run's event):
        fetch the compacted words and unpack them."""
        a, r, packed, nzw_h, sr_h, cap, length = staged
        n = self.cfg.n
        if packed is None:
            a_h, r_h = a.cpu().numpy(), r.cpu().numpy()
        else:
            a_h, r_h = _finish_masks_host(a, r, packed[0], packed[1], nzw_h,
                                          cap)
        sr = sr_h.numpy().astype(np.int32, copy=False)
        return (a_h.reshape(length, nr, n, n),
                r_h.reshape(length, nr, n, n), sr[0], sr[1])

    def _lane_schedules(self, cfgs) -> list:
        """Each lane's host schedule at the fleet's width."""
        return [make_schedule_host(c) for c in cfgs]

    def _dense_trace_lanes(self, cfgs, scheds, final, nr: int,
                           added, removed, sent, recv):
        lanes = []
        for i, (c, s) in enumerate(zip(cfgs[:nr], scheds[:nr])):
            lanes.append(SimResult(
                cfg=c, start_tick=np.asarray(s.start_tick),
                fail_tick=np.asarray(s.fail_tick),
                rejoin_tick=np.asarray(s.rejoin_tick),
                added=np.concatenate([ch[:, i] for ch in added], 0),
                removed=np.concatenate([ch[:, i] for ch in removed], 0),
                sent=np.concatenate([ch[:, i] for ch in sent], 0).T.copy(),
                recv=np.concatenate([ch[:, i] for ch in recv], 0).T.copy(),
                final_state=_lane_state(final, i), wall_seconds=0.0))
        _check_unstacked(lanes, nr)
        return lanes

    def launch(self, seeds=None, configs=None,
               n_real: Optional[int] = None,
               warmup: bool = True, defer: bool = False) -> PendingFleet:
        """:meth:`run` split at the enqueue.  A trace that fits one chunk
        is enqueued and resolved later; a multi-chunk trace runs its
        chunk loop inside ``launch`` (each chunk's staging bounds the
        device memory) and hands back a resolved :class:`PendingFleet`
        (``defer`` has no effect there)."""
        cfgs = self._lane_cfgs(seeds, configs)
        nr = self._resolve_n_real(len(cfgs), n_real)
        if self.cfg.model == "overlay":
            return self._overlay_launch(cfgs, None, 0, self.cfg.total_ticks,
                                        nr, defer, warmup=warmup)
        return self._dense_trace_launch(cfgs, None, 0, self.cfg.total_ticks,
                                        nr, defer, leg=False)

    def _dense_trace_launch(self, cfgs, cks, start: int, length: int,
                            nr: int, defer: bool, leg: bool):
        """The dense trace fleet over ticks ``[start, start + length)``,
        from tick 0 (``cks`` None) or from checkpoints; resolves to a
        :class:`FleetResult`, or a :class:`FleetLeg` when ``leg``."""
        b = len(cfgs)
        end = start + length
        shared = _shared_drop(cfgs)
        chunk = self._chunk(length, b)

        def stage():
            scheds = self._lane_schedules(cfgs)
            staged = self._stage_dense(cfgs, scheds, shared)
            if cks is None:
                states0 = self._init_stacked(cfgs, self.cfg.n)
            else:
                states0 = self._resume_states(cks + [cks[0]] * (b - nr),
                                              WorldState, start)
            run = self._dense_fn("trace", b, length, self.cfg.n, shared) \
                if chunk >= length else None
            return scheds, staged, states0, run

        def finish(st, final, chunks):
            if leg:
                return self._dense_leg(cfgs, cks, _state_to_host(final),
                                       chunks, start, length, nr)
            lanes = self._dense_trace_lanes(cfgs, st[0], final, nr,
                                            *zip(*chunks))
            return FleetResult(lanes=lanes, wall_seconds=0.0,
                               padded_batch=b if nr < b else 0)

        if chunk >= length:
            def enqueue(st):
                _, staged, states0, run = st
                states, ev = run(states0, staged)
                return states, self._dense_trace_stage_device(ev, length, nr)

            return self._launch_run(
                stage, enqueue,
                lambda st, final, dev: finish(
                    st, final, [self._dense_trace_finish_host(dev, nr)]),
                end, length, nr, b, defer)
        # multi-chunk: the chunk loop runs here
        with spans.span("fleet.stage"):
            t0 = time.perf_counter_ns()
            st = stage()
            t1 = time.perf_counter_ns()
        pack = (t1 - t0) / 1e9
        chunks = []
        t_dev = 0.0
        states = st[2]
        done = 0
        while done < length:
            ln = min(chunk, length - done)
            run = self._dense_fn("trace", b, ln, self.cfg.n, shared)
            t_dev0 = time.perf_counter()
            states, ev = run(states, st[1])
            stage_dev = self._dense_trace_stage_device(ev, ln, nr)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            t_dev += time.perf_counter() - t_dev0
            chunks.append(self._dense_trace_finish_host(stage_dev, nr))
            done += ln
        _check_end(states, end)
        wall = (time.perf_counter_ns() - t0) / 1e9
        result = _timed(finish(st, states, chunks), pack, t_dev,
                        max(0.0, wall - pack - t_dev))
        return PendingFleet(lambda: result, pack)

    # ---- checkpoint / resume legs ------------------------------------
    def _resume_states(self, cks: list, cls, tick: int):
        """Re-stack per-lane host snapshots into a fleet state on the
        device (non-blocking copies), at the shared clock ``tick``."""
        kw = {}
        for name in cks[0].state:
            a = np.stack([ck.state[name] for ck in cks])
            kw[name] = a.copy() if name == "rng" \
                else _to_device(a, self.device)
        return cls(tick=int(tick), **kw)

    def _advance_checkpoints(self, cks, cfgs, mode: str, end: int,
                             nr: int, snap, chunk_of) -> list:
        """Each real lane's checkpoint at ``end``; its wall is the earlier
        legs', to which :func:`_timed` adds this leg's."""
        out = []
        for i in range(nr):
            prev = cks[i] if cks is not None else None
            out.append(LaneCheckpoint(
                cfg=cfgs[i], mode=mode, tick=end, state=snap(i),
                chunks=(list(prev.chunks) if prev is not None else [])
                + [chunk_of(i)],
                wall_seconds=prev.wall_seconds if prev is not None else 0.0,
                legs=(prev.legs if prev is not None else 0) + 1,
                mesh_desc=self._mesh_entry()))
        return out

    def _dense_leg(self, cfgs, cks, final_h, chunks, start, length,
                   nr) -> FleetLeg:
        a_all = np.concatenate([c[0] for c in chunks], 0)
        r_all = np.concatenate([c[1] for c in chunks], 0)
        s_all = np.concatenate([c[2] for c in chunks], 0)
        r2_all = np.concatenate([c[3] for c in chunks], 0)
        new = self._advance_checkpoints(
            cks, cfgs, "trace", start + length, nr,
            snap=lambda i: {k: np.array(v[i]) for k, v in final_h.items()},
            chunk_of=lambda i: (a_all[:, i], r_all[:, i], s_all[:, i],
                                r2_all[:, i]))
        return FleetLeg(checkpoints=new, start=start, ticks=length,
                        padded_batch=len(cfgs))

    def run_leg(self, seeds=None, configs=None, resume=None,
                ticks=None, n_real=None, width=None,
                mode: str = "trace") -> FleetLeg:
        """:meth:`launch_leg` + resolve."""
        return self.launch_leg(seeds=seeds, configs=configs,
                               resume=resume, ticks=ticks,
                               n_real=n_real, width=width,
                               mode=mode).resolve()

    def launch_leg(self, seeds=None, configs=None, resume=None,
                   ticks=None, n_real=None, width=None,
                   mode: str = "trace", defer: bool = False
                   ) -> PendingFleet:
        """One resumable leg of a fleet run: ``ticks`` ticks from tick 0
        (``seeds=`` / ``configs=``) or from a batch of
        :class:`LaneCheckpoint` (``resume=``).  It resolves to a
        :class:`FleetLeg` whose checkpoints re-enter here until ``done``;
        then :meth:`FleetLeg.results` equals an uninterrupted run bit for
        bit.  Leg boundaries must be the segment planner's cuts
        (``models/segments.py checkpoint_ticks``) or the run's end;
        resumed lanes must share the clock and are padded to ``width``
        with lane 0's snapshot.  Overlay fleets and dense trace fleets
        only (a dense bench run is whole-run by its corner width)."""
        from ..models.segments import checkpoint_ticks
        if resume is None:
            cfgs = self._lane_cfgs(seeds, configs)
            nr = self._resolve_n_real(len(cfgs), n_real)
            cks = None
            start = 0
        else:
            if seeds is not None or configs is not None:
                raise ValueError(
                    "pass resume= alone (the checkpoints carry their "
                    "own configs)")
            cks = list(resume)
            if not cks:
                raise ValueError("empty resume batch")
            t0s = {ck.tick for ck in cks}
            if len(t0s) != 1:
                raise ValueError(
                    f"resumed lanes disagree on the clock "
                    f"{sorted(t0s)}; a fleet shares ONE scan clock — "
                    "batch same-tick checkpoints only")
            modes = {ck.mode for ck in cks}
            if len(modes) != 1:
                raise ValueError(f"resumed lanes mix modes {modes}")
            mode = modes.pop()
            start = t0s.pop()
            nr = len(cks)
            w = nr if width is None else int(width)
            if w < nr:
                raise ValueError(f"width={w} < {nr} resumed lanes")
            cfgs = [ck.cfg for ck in cks + [cks[0]] * (w - nr)]
            self._lane_cfgs(None, cfgs)
        total = self.cfg.total_ticks
        length = (total - start) if ticks is None else int(ticks)
        end = start + length
        if length < 1 or end > total:
            raise ValueError(
                f"leg [{start}, {end}) outside the run's "
                f"[0, {total}] horizon")
        cuts = set(checkpoint_ticks(self.cfg))
        if start != 0 and start not in cuts:
            raise ValueError(
                f"leg start {start} is not a segment cut "
                f"{sorted(cuts)}; segment boundaries are the only "
                "legal snapshot points (models/segments.py)")
        if end != total and end not in cuts:
            raise ValueError(
                f"leg end {end} is not a segment cut {sorted(cuts)} "
                "or the run's end; segment boundaries are the only "
                "legal snapshot points (models/segments.py)")
        if self.cfg.model == "overlay":
            return self._overlay_launch(cfgs, cks, start, length, nr, defer,
                                        leg_mode=mode)
        if mode != "trace":
            raise NotImplementedError(
                "dense bench-mode runs fix their active-corner width for "
                "the whole run and cannot be checkpointed; run them "
                "whole")
        return self._dense_trace_launch(cfgs, cks, start, length, nr,
                                        defer, leg=True)

    # ---- overlay (metrics mode) --------------------------------------
    def _overlay_fleet_fn(self, batch: int, length: Optional[int] = None,
                          start_tick: int = 0):
        from ..models.overlay import make_overlay_fleet_run
        return make_overlay_fleet_run(self.cfg, batch, length=length,
                                      start_tick=start_tick)

    def _overlay_init_stacked(self, b: int):
        """The stacked tick-0 overlay world (every lane's is the same;
        the seed enters through the schedule)."""
        from ..models.overlay import init_overlay_state
        st = init_overlay_state(self.cfg, self.device)
        return type(st)(tick=0, **{
            f.name: getattr(st, f.name).expand(
                (b,) + tuple(getattr(st, f.name).shape)).contiguous()
            for f in dataclasses.fields(type(st)) if f.name != "tick"})

    def _overlay_launch(self, cfgs: Sequence[SimConfig], cks, start: int,
                        length: int, nr: int, defer: bool,
                        warmup: bool = False,
                        leg_mode: Optional[str] = None) -> PendingFleet:
        """The overlay fleet over ticks ``[start, start + length)``, from
        tick 0 (``cks`` None) or from checkpoints; resolves to a
        :class:`FleetResult`, or with ``leg_mode`` to a :class:`FleetLeg`
        whose checkpoints carry that mode."""
        from ..models.overlay import OverlayResult, make_overlay_schedule
        from ..ops.overlay_rules import OverlayState
        b = len(cfgs)
        run = self._overlay_fleet_fn(b, length=length, start_tick=start)
        if warmup:
            run(self._overlay_init_stacked(b),
                [make_overlay_schedule(c) for c in cfgs])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def stage():
            scheds = [make_overlay_schedule(c) for c in cfgs]
            if cks is None:
                return scheds, self._overlay_init_stacked(b)
            return scheds, self._resume_states(cks + [cks[0]] * (b - nr),
                                               OverlayState, start)

        def enqueue(st):
            final, metrics = run(st[1], st[0])
            return final, _metrics_to_host_async(metrics, nr)

        def finish(st, final, mets):
            mets = _metrics_numpy(mets)
            if leg_mode is not None:
                host = _state_to_host(final)
                return FleetLeg(checkpoints=self._advance_checkpoints(
                    cks, cfgs, leg_mode, start + length, nr,
                    snap=lambda i: {k: np.array(v[i])
                                    for k, v in host.items()},
                    chunk_of=lambda i: _lane_metrics(mets, i)),
                    start=start, ticks=length, padded_batch=b)
            lanes = [OverlayResult(
                cfg=c, sched=st[0][i], final_state=_lane_state(final, i),
                metrics=_lane_metrics(mets, i), wall_seconds=0.0)
                for i, c in enumerate(cfgs[:nr])]
            _check_unstacked(lanes, nr)
            return FleetResult(lanes=lanes, wall_seconds=0.0,
                               padded_batch=b if nr < b else 0)

        return self._launch_run(stage, enqueue, finish, start + length,
                                length, nr, b, defer)


class CanonicalFleetSimulation(FleetSimulation):
    """A fleet over one CANONICAL equivalence class (service/canonical.py;
    JAX ``core/fleet.py CanonicalFleetSimulation``): lanes whose exact
    configs differ — peer count below the same pad-ladder rung (drop-off
    classes), drop probability, phase-window jitter within the
    quantization grid, world operand values — ride ONE fleet program at
    the rung width.

    It is the dense trace fleet with ``self.cfg`` a rung-width
    representative (``member.replace(max_nnb=rung)``), so the inherited
    staging, chunking and sparse event staging run at the rung.  The
    canonical deltas:

    * lane validation by canonical key equality (not exact shape);
    * each lane's real-width schedule is padded to the rung with inert
      filler peers (``state.pad_schedule_host``);
    * the drop window is EXACT per lane: each lane's own ``drop_active``
      is its row of the fleet's drop plan (``ops/drop.py LaneDrop``), so
      nothing draws outside it.  (The JAX package draws a class-shared
      quantized superset window and masks it back per lane; the draw
      depends only on (key, tick, stream width), so both give the same
      bits.)  The flap world's scalars ride as one value a lane;
    * the drop stream is drawn at the class's ``stream_n`` (the real
      peer count of drop-on classes) and embedded into the rung: the
      draw kernel reads the asym thresholds at that corner and gates the
      partition over the whole rung;
    * results are sliced back to each lane's real ``n`` on the host —
      filler PEERS, like filler lanes, are never unstacked.

    Per-lane results are bit-identical to exact unpadded solo runs
    (tests/test_torch_canonical.py).  Monolithic trace dispatches only:
    bench mode bakes the active corner and checkpoint legs validate
    exact-plan cuts, so both keep exact buckets.  Unlike the JAX class
    a rung too large for one event chunk is chunked like any dense
    trace fleet rather than refused.
    """

    #: the pad ladder's rung multiple (a mesh service's full-strength
    #: peer count, parallel/fleet_mesh.py CanonicalMeshFleetSimulation)
    _rung_multiple = 1

    def __init__(self, cfg: SimConfig, device=None,
                 chunk_ticks: Optional[int] = None):
        from ..service.canonical import (canonical_bucket_key,
                                         canonical_supported, ladder_rung)
        if not canonical_supported(cfg, "trace"):
            raise ValueError(
                f"config (model={cfg.model!r}) is not canonicalizable; "
                "use FleetSimulation with the exact bucket key")
        self.member_cfg = cfg
        self.rung = ladder_rung(cfg.n, multiple=self._rung_multiple)
        self._canon_key = canonical_bucket_key(cfg, "trace",
                                               peers=self._rung_multiple)
        # the class's drop-stream width: real n for drop-on classes,
        # None (the rung) otherwise — the stream_n of the canonical key
        self._stream_n = cfg.n if (cfg.drop_msg or cfg.asym_drop) else None
        super().__init__(cfg.replace(max_nnb=self.rung), device=device,
                         chunk_ticks=chunk_ticks)

    def _lane_cfgs(self, seeds, configs) -> list[SimConfig]:
        from ..service.canonical import canonical_bucket_key
        if (seeds is None) == (configs is None):
            raise ValueError("pass exactly one of seeds= or configs=")
        if configs is None:
            configs = [self.member_cfg.replace(seed=int(s)) for s in seeds]
        configs = list(configs)
        if not configs:
            raise ValueError("empty fleet")
        for i, c in enumerate(configs):
            k = canonical_bucket_key(c, "trace", peers=self._rung_multiple)
            if k != self._canon_key:
                raise ValueError(
                    f"lane {i} is not a member of this canonical "
                    f"equivalence class: {k} != {self._canon_key}")
        return configs

    def _key_prefix(self) -> tuple:
        # the canonical key IS the program identity (rung, stream_n,
        # static plane set, quantized plan), beside the mesh slot
        return (self._canon_key, self._mesh_entry())

    def _lane_schedules(self, cfgs) -> list:
        return [pad_schedule_host(make_schedule_host(c), self.rung)
                for c in cfgs]

    def _stage_dense(self, cfgs, scheds, shared: bool):
        sched, drop, lanes = super()._stage_dense(cfgs, scheds, shared)
        if self.cfg.flap_rate > 0:
            # the flap knobs are runtime operands of the class: one value
            # a lane, broadcast against the [B, N] anchors
            def col(name):
                return _to_device(np.array(
                    [[getattr(s, name)] for s in scheds], np.int32),
                    self.device)
            sched = sched.replace(flap_period=col("flap_period"),
                                  flap_down=col("flap_down"),
                                  flap_close=col("flap_close"))
        return sched, drop, lanes

    def _dense_trace_lanes(self, cfgs, scheds, final, nr: int,
                           added, removed, sent, recv):
        from .dense_corner import _slice_state
        lanes = []
        for i, (c, s) in enumerate(zip(cfgs[:nr], scheds[:nr])):
            n = c.n
            lanes.append(SimResult(
                cfg=c, start_tick=np.asarray(s.start_tick[:n]),
                fail_tick=np.asarray(s.fail_tick[:n]),
                rejoin_tick=np.asarray(s.rejoin_tick[:n]),
                added=np.concatenate([ch[:, i, :n, :n] for ch in added], 0),
                removed=np.concatenate([ch[:, i, :n, :n] for ch in removed],
                                       0),
                sent=np.concatenate([ch[:, i, :n] for ch in sent], 0).T.copy(),
                recv=np.concatenate([ch[:, i, :n] for ch in recv], 0).T.copy(),
                final_state=_slice_state(_lane_state(final, i), n),
                wall_seconds=0.0))
        _check_unstacked(lanes, nr)
        return lanes

    # the modes the canonical path does not serve: the serving layer's
    # canonical_supported gate routes them to exact buckets first
    def run_bench(self, *a, **kw):
        raise NotImplementedError(
            "canonical buckets serve dense trace only; bench mode "
            "bakes the active-corner width and keeps exact buckets")

    launch_bench = run_bench

    def run_leg(self, *a, **kw):
        from ..service.canonical import CanonicalLegUnsupported
        raise CanonicalLegUnsupported(
            "canonical buckets serve monolithic traces only: "
            "checkpoint legs validate resume cuts against the EXACT "
            "segment plan, which canonical buckets quantize away — "
            "serve legged work from exact buckets "
            "(FleetService(canonicalize=False))")

    launch_leg = run_leg


def _stack_fleet_events(evs: list, trace: bool, b: int, width: int,
                        device) -> TickEvents:
    """Per-tick fleet events stacked over a run: counters [L, B, W] and,
    in trace mode, masks [L, B, W, W] ((L,) placeholders otherwise)."""
    length = len(evs)
    if evs:
        sent = torch.stack([e.sent for e in evs])
        recv = torch.stack([e.recv for e in evs])
    else:
        sent = recv = torch.zeros((0, b, width), dtype=torch.int32,
                                  device=device)
    if not trace:
        added = removed = torch.zeros((length,), dtype=torch.bool,
                                      device=device)
    elif evs:
        added = torch.stack([e.added for e in evs])
        removed = torch.stack([e.removed for e in evs])
    else:
        added = removed = torch.zeros((0, b, width, width), dtype=torch.bool,
                                      device=device)
    return TickEvents(added=added, removed=removed, sent=sent, recv=recv)


def _metrics_to_host_async(metrics, nr: int) -> torch.Tensor:
    """The real lanes' metric series [9, nr, L], copy started (pinned,
    non-blocking)."""
    from ..ops.overlay_rules import METRIC_FIELDS
    return to_host_async(torch.stack(
        [getattr(metrics, f)[:nr] for f in METRIC_FIELDS]))


def _metrics_numpy(mets: torch.Tensor) -> dict:
    from ..ops.overlay_rules import METRIC_FIELDS
    arr = mets.numpy()
    return {f: arr[j] for j, f in enumerate(METRIC_FIELDS)}


def _lane_metrics(mets: dict, i: int):
    from ..models.overlay import OverlayMetrics
    return OverlayMetrics(**{f: np.array(v[i]) for f, v in mets.items()})

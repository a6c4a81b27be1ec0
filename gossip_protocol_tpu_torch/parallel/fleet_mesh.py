"""Meshes of fleets: the lane axis split over a port mesh (port of
``gossip_protocol_tpu/parallel/fleet_mesh.py``).

A fleet's lanes are independent simulations at one shared clock
(core/fleet.py), so splitting them over a 1-D mesh costs no collective
a tick: each lane shard is a sub-fleet on its mesh entry and runs the
port's own fleet routes (the K1 route's lane axis with the lane draw,
K5's lane axis for overlay fleets inside its envelope), so every lane
equals its single-device fleet lane and its solo run, bit for bit, by
the same argument as the JAX package's (``fleet_mesh.py:565-578``).

A 2-D ``Mesh((lanes, peers))`` composes the lane mesh with the peer
sharding of parallel/sharded.py: dense widths that divide the peer axis
run the ``RingComm`` tick inside each lane's peer submesh
(:meth:`MeshFleetSimulation._peer_comm`), every lane at once through the
lane axis of the rectangular ``masked_max3``; other widths, canonical
rungs and the overlay run peer-replicated (every peer shard of a lane
row runs the same lanes, the same bits).

The elastic ladder (:func:`shrink_mesh`, :func:`grow_mesh`) is the JAX
one: a 2-D mesh halves its peer axis first, a 1-D mesh drops its last
entry, growth re-extends the prefix of the full-strength entries, so
every rung's descriptor is a function of the rung alone and a
shrink -> grow round trip re-keys back to programs that served before
(service/cache.py ``rebind_mesh``).  Program caches key on
:func:`mesh_descriptor` (core/fleet.py ``_mesh_entry``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from ..core.fleet import CanonicalFleetSimulation, FleetSimulation
from ..core.tick import TickEvents, make_fleet_tick
from ..state import SCHED_ARRAYS, WorldState
from .mesh import Mesh, P, ctx, make_mesh_entries, shard_map
from .sharded import PEER_AXIS, peer_spec_trees

LANE_AXIS = "lanes"

#: collectives a shard-tick of the 2-D lanes x peers fleet tick may issue
#: on the peer axis (JAX ``LANE_PEER_TICK_COLLECTIVE_BUDGET``): the
#: ``RingComm`` tick's delivery transpose (1 ``all_to_all``), its merge
#: ring (P - 1 ``ppermute``s, the three planes riding one) and the
#: introducer row's OR (1 ``psum``), so 5 at 4 peer shards.
#: analysis/runtime.py holds every tick of the registered 2-D program to
#: :func:`lane_peer_tick_collectives` and that to this budget.
LANE_PEER_TICK_COLLECTIVE_BUDGET = 5


def lane_peer_tick_collectives(n_peers: int) -> dict:
    """The collectives a shard-tick of the 2-D fleet tick owes on the
    peer axis, by kind, at ``n_peers`` peer shards."""
    return {"all_to_all": 1, "ppermute": n_peers - 1, "psum": 1}


def _mesh_of(entries, shape, axes) -> Mesh:
    """A mesh over ``(id, device)`` entries reshaped to ``shape``."""
    devs = np.empty(len(entries), dtype=object)
    devs[:] = [d for _, d in entries]
    ids = np.array([i for i, _ in entries], np.int64)
    return Mesh(devs.reshape(shape), axes, ids=ids.reshape(shape))


def make_lane_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D lane mesh of ``n_devices`` entries (default one a visible card)
    on ``device`` (``cuda`` unless ``cpu`` is asked for)."""
    return Mesh(make_mesh_entries(n_devices, device), (LANE_AXIS,))


def make_lane_peer_mesh(n_lanes: int, n_peers: int, device=None) -> Mesh:
    """2-D ``Mesh((lanes, peers))``: the lane mesh composed with the peer
    axis of parallel/sharded.py."""
    if n_lanes < 1 or n_peers < 1:
        raise ValueError(f"asked for a {n_lanes}x{n_peers} lanes x peers "
                         "mesh")
    devs = np.empty(n_lanes * n_peers, dtype=object)
    devs[:] = make_mesh_entries(n_lanes * n_peers, device)
    return Mesh(devs.reshape(n_lanes, n_peers), (LANE_AXIS, PEER_AXIS))


def mesh_descriptor(mesh: Mesh) -> tuple:
    """Hashable identity of a serving mesh for program-cache keys: axis
    names, flat entry ids and shape (a 2x4 and a 4x2 mesh differ)."""
    return mesh.descriptor()


def mesh_axis_sizes(mesh: Optional[Mesh]) -> tuple:
    """``(n_lanes, n_peers, peer_axis)`` of a serving mesh, validating
    the accepted shapes: ``None`` (one lane slot), a 1-D lane mesh, or
    the 2-D ``Mesh((lanes, peers))``.  Anything else (a transposed axis
    order, foreign axis names, an object that is no port mesh) raises
    here, once."""
    if mesh is None:
        return 1, 1, None
    names = getattr(mesh, "axis_names", None)
    devices = getattr(mesh, "devices", None)
    shape = tuple(np.shape(devices)) if isinstance(mesh, Mesh) else ()
    if isinstance(mesh, Mesh) and len(shape) == 1 and len(names) == 1:
        return int(shape[0]), 1, None
    if isinstance(mesh, Mesh) and len(shape) == 2 \
            and names == (LANE_AXIS, PEER_AXIS):
        return int(shape[0]), int(shape[1]), PEER_AXIS
    raise ValueError(
        f"serving meshes are 1-D ({LANE_AXIS!r},) or 2-D "
        f"({LANE_AXIS!r}, {PEER_AXIS!r}); got axes {names} "
        f"shape {shape}")


def shrink_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """One rung down the serving degradation ladder, axis-aware: a 2-D
    mesh halves its PEER axis over the flat prefix (lanes untouched),
    collapsing to the 1-D lane mesh at one peer; a 1-D mesh drops its
    LAST entry (None below two).  Entries are always a prefix of the
    current flat order, so the ladder's descriptors are a function of
    the rung."""
    if mesh is None:
        return None
    entries = mesh.entries()
    if mesh.devices.ndim == 2:
        lanes, peers = mesh.devices.shape
        new_peers = peers // 2
        keep = entries[:lanes * max(1, new_peers)]
        if new_peers <= 1:
            if len(keep) < 2:
                return None
            return _mesh_of(keep, (len(keep),), (LANE_AXIS,))
        return _mesh_of(keep, (lanes, new_peers), mesh.axis_names)
    keep = entries[:-1]
    if len(keep) < 2:
        return None
    return _mesh_of(keep, (len(keep),), mesh.axis_names)


def grow_mesh(mesh: Optional[Mesh], devices,
              full_shape: Optional[tuple] = None,
              full_axes: Optional[tuple] = None) -> Optional[Mesh]:
    """One rung UP the ladder, the inverse of :func:`shrink_mesh`:
    ``devices`` are the full-strength ``(id, device)`` entries the
    service captured.  On the 1-D ladder one entry at a time (None grows
    to two entries); toward a 2-D ``full_shape`` the lane axis is
    restored first, then the peer axis doubles back, so each grown
    descriptor equals the one the rung had on the way down.  At full
    strength (or with ``devices`` None) the mesh comes back unchanged."""
    if devices is None:
        return mesh
    devs = list(devices)
    if full_shape is not None and len(full_shape) == 2:
        full_lanes, full_peers = int(full_shape[0]), int(full_shape[1])
        if mesh is None:
            cur_lanes, cur_peers = 0, 1
        elif mesh.devices.ndim == 1:
            cur_lanes, cur_peers = mesh.size, 1
        else:
            cur_lanes, cur_peers = mesh.devices.shape
        if cur_lanes < full_lanes:
            nk = min(max(2, cur_lanes + 1), full_lanes, len(devs))
            if nk <= cur_lanes:
                return mesh
            return _mesh_of(devs[:nk], (nk,), (LANE_AXIS,))
        new_peers = min(max(2, cur_peers * 2), full_peers)
        if new_peers <= cur_peers or full_lanes * new_peers > len(devs):
            return mesh
        axes = tuple(full_axes) if full_axes is not None \
            else (LANE_AXIS, PEER_AXIS)
        return _mesh_of(devs[:full_lanes * new_peers],
                        (full_lanes, new_peers), axes)
    k = mesh.size if mesh is not None else 1
    nk = max(2, k + 1)
    if k >= len(devs) or nk > len(devs):
        return mesh
    names = mesh.axis_names if mesh is not None else (LANE_AXIS,)
    return _mesh_of(devs[:nk], (nk,), names)


def _lane_specs(cls, unbatched=("tick",)):
    """Every field of ``cls`` lane-sharded on its leading axis, but the
    unbatched ones (the clock)."""
    return cls(**{f.name: P() if f.name in unbatched else P(LANE_AXIS)
                  for f in dataclasses.fields(cls)})


def compose_lane_peer_specs(lane_specs, peer_specs):
    """Compose a lane spec tree with a peer-axis spec tree into the 2-D
    one: a lane-sharded field gains ``LANE_AXIS`` ahead of its peer spec,
    an unbatched field keeps its peer spec (JAX
    ``compose_lane_peer_specs``)."""
    cls = type(lane_specs)
    out = {}
    for f in dataclasses.fields(cls):
        la = getattr(lane_specs, f.name)
        ps = getattr(peer_specs, f.name)
        out[f.name] = ps if not la else P(LANE_AXIS, *ps)
    return cls(**out)


def _slice_lanes(sched, lo: int, hi: int):
    """A stacked fleet schedule at lanes ``[lo, hi)``: every per-lane
    column and plane (and a canonical fleet's per-lane flap scalars)."""
    kw = {}
    for f in dataclasses.fields(sched):
        v = getattr(sched, f.name)
        if torch.is_tensor(v) and v.dim() >= 1 and (
                f.name in SCHED_ARRAYS or f.name.startswith("flap_")):
            kw[f.name] = v[lo:hi]
        elif isinstance(v, np.ndarray) and f.name in SCHED_ARRAYS:
            kw[f.name] = v[lo:hi]
    return sched.replace(**kw)


def _dense_body(cfg_w: SimConfig, mode: str, length: int, bl: int,
                comm, n_active, peers: int):
    """The shard body of a dense fleet program: this lane shard's
    ``bl`` lanes of the staged fleet, ``length`` ticks."""
    from ..core.fleet import _stack_fleet_events
    trace = mode == "trace"
    tick = make_fleet_tick(cfg_w, with_events=trace, n_active=n_active,
                           comm=comm)
    width = cfg_w.n // (peers if comm is not None else 1)

    def body(states, staged):
        sched, drop, lanes = staged
        lo = ctx().axis_index(LANE_AXIS) * bl
        sched = _slice_lanes(sched, lo, lo + bl)
        drop = drop.rows(lo, lo + bl)
        lanes = None if lanes is None else lanes[lo:lo + bl]
        evs = []
        for _ in range(length):
            states, ev = tick(states, sched, drop, lanes)
            evs.append(ev)
        return states, _stack_fleet_events(evs, trace, bl, width,
                                           states.device)

    return body


def _event_specs(trace: bool, peer_axis) -> TickEvents:
    if peer_axis is None:
        ev = P(None, LANE_AXIS)
        return TickEvents(added=ev if trace else P(),
                          removed=ev if trace else P(), sent=ev, recv=ev)
    em = P(None, LANE_AXIS, peer_axis, None)
    ev = P(None, LANE_AXIS, peer_axis)
    return TickEvents(added=em if trace else P(),
                      removed=em if trace else P(), sent=ev, recv=ev)


def make_lane_peer_bench_fn(cfg: SimConfig, mesh: Mesh):
    """The standalone 2-D program: ``run(states, staged) -> (states,
    (sent, recv))``, the fleet's bench tick with the ``RingComm`` peer
    exchange inside, over ``Mesh((lanes, peers))``; ``staged`` is a
    fleet's ``(stacked schedule, LaneDrop, None)``
    (``FleetSimulation._stage_dense``)."""
    from .comm import RingComm
    if mesh.devices.ndim != 2 or LANE_AXIS not in mesh.axis_names:
        raise ValueError(
            f"make_lane_peer_bench_fn takes a 2-D ({LANE_AXIS!r}, "
            f"peer) mesh, got axes {mesh.axis_names}")
    peer_axis = [a for a in mesh.axis_names if a != LANE_AXIS][0]
    n_lanes, n_peers = mesh.shape[LANE_AXIS], mesh.shape[peer_axis]
    if cfg.n % n_peers:
        raise ValueError(
            f"world of n={cfg.n} nodes does not divide over the "
            f"{n_peers}-device {peer_axis!r} axis")
    comm = RingComm(peer_axis, n_peers)
    state_specs = compose_lane_peer_specs(
        _lane_specs(WorldState), peer_spec_trees(peer_axis)[0])

    def run(states, staged):
        b = states.known.shape[0]
        if b % n_lanes:
            raise ValueError(f"fleet of {b} lanes does not divide over the "
                             f"{n_lanes}-wide {LANE_AXIS!r} axis")
        body = _dense_body(cfg, "bench", cfg.total_ticks, b // n_lanes,
                           comm, None, n_peers)
        final, ev = shard_map(
            body, mesh, in_specs=(state_specs, P()),
            out_specs=(state_specs, _event_specs(False, peer_axis)))(
            states, staged)
        return final, (ev.sent, ev.recv)

    return run


class MeshFleetSimulation(FleetSimulation):
    """:class:`~..core.fleet.FleetSimulation` with the lane axis split
    over a port mesh, 1-D (lanes) or 2-D (lanes x peers).

    Same API and same per-lane results (bit-identical) as the
    single-device fleet; the batch must be a multiple of the lane axis.
    Runs on the mesh's entries (``cuda`` unless built on ``cpu``); the
    results land on the first entry's device.
    """

    _counts_merges = False

    def __init__(self, cfg: SimConfig, mesh: Optional[Mesh] = None,
                 chunk_ticks: Optional[int] = None, device=None):
        mesh = mesh if mesh is not None else make_lane_mesh(device=device)
        self._n_lanes, self._n_peers, self._peer_axis = \
            mesh_axis_sizes(mesh)
        self.mesh = mesh
        super().__init__(cfg, device=mesh.devices.flat[0],
                         chunk_ticks=chunk_ticks)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def n_lanes(self) -> int:
        """The lane axis: the batch-divisibility unit."""
        return self._n_lanes

    @property
    def n_peers(self) -> int:
        """The peer axis (1 on a 1-D mesh)."""
        return self._n_peers

    def _mesh_entry(self):
        return mesh_descriptor(self.mesh)

    def _staging_out_shardings(self, state_cls):
        """Staged stacked states split lane by lane over the mesh."""
        return _lane_specs(state_cls)

    def _lane_cfgs(self, seeds, configs):
        cfgs = super()._lane_cfgs(seeds, configs)
        d = self.n_lanes
        if len(cfgs) % d:
            raise ValueError(
                f"fleet of {len(cfgs)} lanes does not divide over the "
                f"{d}-wide {LANE_AXIS!r} axis; pad to a multiple of "
                f"{d} (the serving layer's pad policies do this — "
                "service/scheduler.py)")
        return cfgs

    def _peer_comm(self, n: int):
        """The peer-axis exchange for an ``n``-peer world, or None when
        the program runs peer-replicated (no peer axis, or a width that
        does not divide it)."""
        if self._peer_axis is None or n % self._n_peers:
            return None
        from .comm import RingComm
        return RingComm(self._peer_axis, self._n_peers)

    def _dense_fn(self, mode: str, batch: int, length: int, width: int,
                  shared: bool):
        def build():
            cfg_w = self.cfg.replace(max_nnb=width)
            comm = self._peer_comm(cfg_w.n)
            peer_axis = None if comm is None else self._peer_axis
            lane = self._staging_out_shardings(WorldState)
            specs = lane if comm is None else compose_lane_peer_specs(
                lane, peer_spec_trees(peer_axis)[0])
            body = _dense_body(cfg_w, mode, length, batch // self.n_lanes,
                               comm, self._stream_n, self._n_peers)
            return shard_map(body, self.mesh, in_specs=(specs, P()),
                             out_specs=(specs, _event_specs(
                                 mode == "trace", peer_axis)))

        return self._fleet_program(
            self._cache_key(mode, batch, length if mode == "trace" else
                            width, shared), build)

    def _overlay_fleet_fn(self, batch: int, length: Optional[int] = None,
                          start_tick: int = 0):
        from ..models.overlay import OverlayMetrics, build_overlay_fleet_run
        from ..ops.overlay_rules import OverlayState
        bl = batch // self.n_lanes
        length = self.cfg.total_ticks if length is None else length

        def build():
            inner = build_overlay_fleet_run(self.cfg, bl, length, start_tick)

            def body(states, scheds):
                lo = ctx().axis_index(LANE_AXIS) * bl
                return inner(states, scheds[lo:lo + bl])

            specs = self._staging_out_shardings(OverlayState)
            return shard_map(body, self.mesh, in_specs=(specs, P()),
                             out_specs=(specs, _lane_specs(OverlayMetrics,
                                                           ())))

        return self._fleet_program(
            self._cache_key("overlay", batch, length, start_tick), build)


class CanonicalMeshFleetSimulation(MeshFleetSimulation,
                                   CanonicalFleetSimulation):
    """A canonical equivalence class (core/fleet.py
    :class:`~..core.fleet.CanonicalFleetSimulation`) served from a mesh:
    the rung-width program split over the lane axis, peer-replicated.

    ``rung_multiple`` pins the pad ladder to peer-shard-divisible rungs
    (service/canonical.py ``ladder_rung(multiple=)``): a mesh service
    passes its FULL-STRENGTH peer count, so canonical bucket keys never
    move when the elastic ladder halves the peer axis.  Monolithic trace
    dispatches only, as the base canonical class.
    """

    def __init__(self, cfg: SimConfig, mesh: Optional[Mesh] = None,
                 chunk_ticks: Optional[int] = None,
                 rung_multiple: int = 1, device=None):
        m = int(rung_multiple)
        if m < 1 or m & (m - 1):
            raise ValueError(
                f"rung_multiple must be a power of two (the pad "
                f"ladder doubles), got {rung_multiple}")
        # read by CanonicalFleetSimulation.__init__ (reached through
        # MeshFleetSimulation's super() chain) for the rung snap
        self._rung_multiple = m
        MeshFleetSimulation.__init__(self, cfg, mesh=mesh,
                                     chunk_ticks=chunk_ticks, device=device)

    def _peer_comm(self, n: int):
        # the rung re-shapes the world (filler peer rows) and the drop
        # stream's corner embedding is defined on the whole table, so
        # canonical programs run peer-replicated
        return None

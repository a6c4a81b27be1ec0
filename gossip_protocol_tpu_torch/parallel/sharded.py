"""Peer-sharded whole-run execution over a port mesh (port of
``gossip_protocol_tpu/parallel/sharded.py``).

The peer axis, and with it every row of the (N, N) membership tables,
is split over a 1-D mesh (parallel/mesh.py); the (N,) vectors, the clock
and the key are replicated.  The whole run is one ``shard_map``: each
shard loops its tick (core/tick.py ``make_tick(comm=RingComm)``) over
the run, and per tick the only traffic between shards is the
``all_to_all`` of the delivery transpose, the ``ppermute`` ring of the
merge and the introducer row's OR.  Every shard's rows equal the
single-device run's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import SimConfig
from ..core.tick import TickEvents, make_tick, stack_events
from ..state import Schedule, WorldState
from .comm import RingComm
from .mesh import Mesh, P, make_mesh_entries, shard_map

PEER_AXIS = "peers"


def make_mesh(n_devices: Optional[int] = None, axis: str = PEER_AXIS,
              device=None) -> Mesh:
    """1-D mesh of ``n_devices`` entries (default one a visible card) on
    ``device`` (``cuda`` unless ``cpu`` is asked for; entries repeat a
    card when there are fewer cards)."""
    return Mesh(make_mesh_entries(n_devices, device), (axis,))


def _state_specs(axis: str) -> WorldState:
    """Per WorldState field: tables row-sharded, the rest replicated."""
    mat = P(axis, None)
    rep = P()
    return WorldState(tick=rep, in_group=rep, own_hb=rep, known=mat, hb=mat,
                      ts=mat, gossip=mat, gossip_age=mat, joinreq=rep,
                      joinrep=rep, rng=rep)


def _sched_specs() -> Schedule:
    # every schedule field replicated: the (N,) vectors and world planes
    # are small next to the row-sharded tables, as in the JAX package
    return Schedule(**{f.name: P() for f in dataclasses.fields(Schedule)})


def peer_spec_trees(axis: str = PEER_AXIS) -> tuple:
    """The peer-axis spec trees ``(state, sched)``: the building block of
    the 2-D lanes x peers composition (parallel/fleet_mesh.py
    ``compose_lane_peer_specs``)."""
    return _state_specs(axis), _sched_specs()


def make_sharded_run(cfg: SimConfig, mesh: Mesh, with_events: bool = True,
                     axis: str = PEER_AXIS):
    """``run(state, sched) -> (final_state, events)``: ``cfg.total_ticks``
    ticks from the state's clock, the tick loop inside ``shard_map`` over
    ``mesh``.  Events come back stitched: ``added``/``removed`` [T, N, N]
    and ``sent``/``recv`` [T, N], row-sharded inside (``P(None, axis,
    None)``); without ``with_events`` the masks are [T] placeholders, as
    the JAX bench program returns them."""
    n_shards = mesh.size
    if cfg.n % n_shards:
        raise ValueError("peer count must divide the mesh axis")
    comm = RingComm(axis, n_shards)
    tick = make_tick(cfg, with_events=with_events, comm=comm)
    length = cfg.total_ticks

    def body(state: WorldState, sched: Schedule):
        events = []
        for _ in range(length):
            state, ev = tick(state, sched)
            events.append(ev)
        return state, stack_events(events, with_events, cfg.n // n_shards,
                                   state.device)

    ev_rows = P(None, axis)
    ev_specs = TickEvents(added=P(None, axis, None) if with_events else P(),
                          removed=P(None, axis, None) if with_events
                          else P(), sent=ev_rows, recv=ev_rows)
    state_specs = _state_specs(axis)
    return shard_map(body, mesh, in_specs=(state_specs, _sched_specs()),
                     out_specs=(state_specs, ev_specs))


def shard_state(state: WorldState, mesh: Mesh,
                axis: str = PEER_AXIS) -> WorldState:
    """A WorldState on the mesh's first entry, ready for a sharded run:
    ``shard_map`` splits the tables by their specs at the call (the
    port's tensors carry no sharding of their own)."""
    dev = mesh.devices.flat[0]
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(WorldState)
        if torch.is_tensor(getattr(state, f.name))})

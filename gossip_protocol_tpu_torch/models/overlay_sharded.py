"""Peer-sharded overlay: the partial-view model over a port mesh (port of
``gossip_protocol_tpu/models/overlay_sharded.py``).

The peer axis (the view tables, send flags and history) is split over a
1-D mesh (parallel/mesh.py); the (N,) vectors are replicated.  For
``N = P * Nl`` (both powers of two) the XOR partner exchange decomposes
exactly along the split, ``i ^ m = (s ^ m_hi) * Nl + (il ^ m_lo)``: the
comm routes the shard bits by handing each round the planes of shard
``s ^ m_hi`` (a ``ppermute``), and K3's sharded contract
(ops/cuda/overlay_exchange.py) applies the local bits.  The masks are
host ints, so the pairing is chosen on the host and no ``switch`` over
the P pairings is needed.  The run is the per-tick K3 route, as the JAX
package's sharded run; its trajectory is the single-device one, bit for
bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig
from ..ops.cuda.overlay_exchange import fused_overlay_tick
from ..ops.overlay_rules import METRIC_FIELDS, OverlaySchedule, OverlayState
from ..parallel.mesh import Mesh, P, ctx, make_mesh_entries, shard_map
from .overlay import OverlayMetrics, make_overlay_tick, schedule_columns

PEER_AXIS = "peers"


class RingOverlayComm:
    """Peer-axis-sharded execution inside a ``shard_map`` body."""

    def __init__(self, axis_name: str, n_shards: int):
        assert n_shards & (n_shards - 1) == 0, \
            "shard count must be a power of two (XOR shard exchange)"
        self.axis = axis_name
        self.n_shards = n_shards

    def row_start(self, n: int) -> int:
        return ctx().axis_index(self.axis) * (n // self.n_shards)

    def slice_rows(self, v):
        nl = v.shape[0] // self.n_shards
        r0 = ctx().axis_index(self.axis) * nl
        return v[r0:r0 + nl]

    def xor_perm_shards(self, x, mask_hi: int):
        """The shard bits of the XOR exchange: shard s gets the block of
        shard ``s ^ mask_hi`` (host int, the same on every shard)."""
        if mask_hi == 0:
            return x
        perm = [(s, s ^ mask_hi) for s in range(self.n_shards)]
        return ctx().ppermute(x, self.axis, perm)

    def bcast_row0(self, x_local):
        """Shard 0's ``x_local``, on every shard (global row 0's data)."""
        return ctx().exchange(self.axis, x_local)[0]

    def psum(self, v):
        """Sum over the shards; a bool tensor sums to an OR."""
        return ctx().psum(v, self.axis)


def make_overlay_mesh(n_devices: Optional[int] = None,
                      axis: str = PEER_AXIS, device=None) -> Mesh:
    """1-D mesh of ``n_devices`` entries on ``device`` (``cuda`` unless
    ``cpu`` is asked for)."""
    return Mesh(make_mesh_entries(n_devices, device), (axis,))


def _state_specs(axis: str) -> OverlayState:
    mat = P(axis, None)
    rep = P()
    return OverlayState(tick=rep, ids=mat, hb=mat, ts=mat, in_group=rep,
                        own_hb=rep, send_flags=mat, send_hist=mat,
                        joinreq=rep, joinrep=rep)


def make_sharded_overlay_run(cfg: SimConfig, mesh: Mesh,
                             axis: str = PEER_AXIS,
                             exchange=fused_overlay_tick):
    """``run(state, sched) -> (final, OverlayMetrics[T])``:
    ``cfg.total_ticks`` per-tick K3 ticks from the state's clock, the
    loop inside ``shard_map`` over ``mesh``.  ``exchange``
    stands in for K3 as in :func:`~.overlay.make_overlay_tick` (it is
    called with the sharded contract).  A world config runs the worlds'
    exchange on each shard instead, never K3, as the JAX sharded tick
    runs it on its XLA phases: the partner rounds, the introducer's row
    and the counters go through the comm, the world draws read global
    ids.  The builder keeps no cache of runs; one keyed on the config
    would have to hold ``cfg.worlds_key()``."""
    n_shards = mesh.size
    comm = RingOverlayComm(axis, n_shards)
    n = cfg.n
    nl = n // n_shards
    if nl * n_shards != n or nl & (nl - 1):
        raise ValueError("shard count must divide the peer count (both "
                         "powers of two)")
    tick = make_overlay_tick(cfg, exchange, comm=comm)
    length = cfg.total_ticks

    def body(state: OverlayState, sched: OverlaySchedule):
        cols = schedule_columns(sched, n, state.device)
        rows = []
        for _ in range(length):
            state, m = tick(state, sched, cols)
            rows.append(m)
        met = torch.stack(rows) if rows else torch.zeros(
            (0, len(METRIC_FIELDS)), dtype=torch.int32, device=state.device)
        return state, met

    run = shard_map(body, mesh, in_specs=(_state_specs(axis), P()),
                    out_specs=(_state_specs(axis), P()))

    def wrapped(state: OverlayState, sched: OverlaySchedule):
        final, met = run(state, sched)
        return final, OverlayMetrics.from_rows(met)

    return wrapped


def shard_overlay_state(state: OverlayState, mesh: Mesh,
                        axis: str = PEER_AXIS) -> OverlayState:
    """An OverlayState on the mesh's first entry, ready for a sharded run
    (``shard_map`` splits the tables at the call)."""
    return state.to(mesh.devices.flat[0])

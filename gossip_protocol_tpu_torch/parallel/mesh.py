"""A device mesh of one process: the port's ``Mesh``, ``shard_map`` and
collectives (counterpart of ``jax.sharding.Mesh``, ``shard_map`` and the
``lax`` collectives the JAX package's multi-device code uses).

The JAX package is single-controller: its meshes are ``Mesh`` objects
over the devices of one process, and its elastic serving rebuilds them
inside the running process (shrink on a device loss, grow on its
return).  The port keeps that shape.  A :class:`Mesh` is a 1-D or 2-D
array of entries, each a ``torch.device`` with an id; entries may repeat
a device (``cuda:0`` x 4 puts four shards on one card, ``cpu`` x 8 is the
counterpart of the JAX tests' eight virtual CPU devices), and on a host
with several cards they are ``cuda:0..P-1``.

:func:`shard_map` runs a body once per entry, each in its own host
thread (as ``torch.nn.parallel.parallel_apply`` does for devices), so a
tick is written once against a comm, as in the JAX package.  The shards
take turns on the host: one runs until it waits at a collective, then
the next (a baton lock), which keeps the threads from trading the GIL
at every operator; the cards run their queued work meanwhile.  Inside the
body :func:`ctx` gives the shard's axis indices and the collectives:
``ppermute``, ``all_to_all``, ``all_gather``, ``psum`` (an OR for a bool
tensor).  A collective is an exchange of per-shard values at a barrier
of the shards it spans (two slot arrays in turn, so that one wait a
collective suffices: a slot is written again only after every shard
has passed the next barrier, so after it read the slot); a shard reads a peer's tensor with
``.to(own_device, non_blocking=True)``, ordered after the producer by a
CUDA event recorded on the producer's stream and waited on by its own.
Nothing in a collective synchronizes the host with a card.  Shards of
one card run on the caller's current stream, so their launches keep the
stream's order; a value read from a peer on the same device may alias
the peer's tensor and is never written in place.

A shard that raises aborts every barrier (no thread hangs) and the
caller re-raises the first error: a shard's failure fails the run.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Optional, Sequence

import numpy as np
import torch


class PartitionSpec(tuple):
    """Per dimension of a tensor, the mesh axis it is split over (or
    None).  ``P()`` is replicated; ``P("peers", None)`` splits rows."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """Mesh entries (``torch.device`` each, with an id) over named axes.

    ``devices`` is an array-like of devices shaped like the mesh; ``ids``
    (default ``0..size-1``) names each entry, so that a 4-entry mesh of
    one card and its 3-entry prefix have distinct descriptors, as JAX
    device ids make them.
    """

    def __init__(self, devices, axis_names: Sequence[str], ids=None):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            d = np.asarray(devices, dtype=object)[idx]
            arr[idx] = torch.device(d)
        if arr.ndim != len(axis_names) or arr.ndim not in (1, 2) \
                or arr.size < 1:
            raise ValueError(f"a mesh is a 1-D or 2-D array of devices with "
                             f"one name an axis; got shape {arr.shape} and "
                             f"axes {tuple(axis_names)}")
        if ids is None:
            ids = np.arange(arr.size).reshape(arr.shape)
        ids = np.asarray(ids, dtype=np.int64).reshape(arr.shape)
        if len(set(ids.flat)) != ids.size:
            raise ValueError(f"mesh entry ids must be distinct: {ids}")
        self.devices = arr
        self.ids = ids
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def entries(self) -> list:
        """``(id, device)`` of every entry, in flat order."""
        return list(zip((int(i) for i in self.ids.flat), self.devices.flat))

    def descriptor(self) -> tuple:
        """Hashable identity for program-cache keys: axis names, flat
        entry ids and shape (a 2x4 and a 4x2 mesh differ)."""
        return (self.axis_names, tuple(int(i) for i in self.ids.flat),
                tuple(self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh_entries(n: Optional[int], device=None) -> list:
    """``n`` entries for a mesh on ``device`` (default ``cuda``; ``n``
    None: one a visible card, or one CPU entry): on the CPU every entry
    is ``cpu``; on CUDA entry i is card ``i % count`` (one card repeats).
    Raises without a card unless ``cpu`` is asked for: a mesh entry of
    ``cuda`` never becomes the CPU."""
    from ..state import resolve_device
    dev = resolve_device(device)
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < 1:
        raise ValueError(f"a mesh needs at least one entry, got {n}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


# ------------------------------------------------------------ the shards

#: seconds a shard waits at a collective before the run fails: a shard
#: that never arrives (a collective called on some shards only) must
#: fail the run, not hang it
COLLECTIVE_TIMEOUT_S = 600.0


class _Group:
    """The shards that one collective over one axis spans."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=COLLECTIVE_TIMEOUT_S)
        self.slots = ([None] * size, [None] * size)
        self.turn = [0] * size        # each shard's next slot array


class _MeshRun:
    """Shared state of one :func:`shard_map` call."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.groups: dict = {}
        shape = mesh.devices.shape
        for ax, name in enumerate(mesh.axis_names):
            others = [range(s) for i, s in enumerate(shape) if i != ax]
            for rest in itertools.product(*others):
                self.groups[(name, rest)] = _Group(shape[ax])
        self.multi_device = len({str(d) for d in mesh.devices.flat}) > 1
        self.baton = threading.Lock()     # held by the shard running

    def abort(self) -> None:
        for g in self.groups.values():
            g.barrier.abort()


_LOCAL = threading.local()


def ctx() -> "ShardContext":
    """The calling shard's context (inside a :func:`shard_map` body)."""
    c = getattr(_LOCAL, "ctx", None)
    if c is None:
        raise RuntimeError("mesh collectives run inside a shard_map body")
    return c


class ShardContext:
    """One shard of a :func:`shard_map` call: its coordinates, device and
    the collectives over the mesh's axes."""

    def __init__(self, run: _MeshRun, coords: tuple):
        self._run = run
        self.coords = coords
        self.device = run.mesh.devices[coords]

    def axis_index(self, axis: str) -> int:
        return self.coords[self._run.mesh.axis_names.index(axis)]

    def _group(self, axis: str) -> _Group:
        ax = self._run.mesh.axis_names.index(axis)
        rest = tuple(c for i, c in enumerate(self.coords) if i != ax)
        return self._run.groups[(axis, rest)]

    def _fetch(self, item):
        value, event = item
        if isinstance(value, tuple):
            return tuple(self._fetch((v, event)) for v in value)
        if not torch.is_tensor(value) or value.device == self.device:
            return value
        if event is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_event(event)
        return value.to(self.device, non_blocking=True)

    def exchange(self, axis: str, value) -> list:
        """Every shard of ``axis``'s group publishes ``value`` (a tensor,
        a tuple of tensors or a host value); returns the group's values
        in axis order (peers' tensors on this shard's device)."""
        g = self._group(axis)
        me = self.axis_index(axis)
        event = None
        if self._run.multi_device:
            devs = [v.device for v in (value if isinstance(value, tuple)
                                       else (value,))
                    if torch.is_tensor(v) and v.device.type == "cuda"]
            if devs:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(devs[0]))
        slots = g.slots[g.turn[me]]
        g.turn[me] ^= 1
        slots[me] = (value, event)
        self._run.baton.release()
        try:
            g.barrier.wait()
        finally:
            self._run.baton.acquire()
        return [self._fetch(item) for item in slots]

    # ---- the lax collectives ------------------------------------------
    def ppermute(self, x, axis: str, perm):
        """``lax.ppermute`` of a tensor or a tuple of tensors: ``perm``
        pairs (source, destination); a shard no pair sends to receives
        zeros."""
        vals = self.exchange(axis, x)
        me = self.axis_index(axis)
        src = [s for s, d in perm if d == me]
        if src:
            return vals[src[0]]
        if isinstance(x, tuple):
            return tuple(torch.zeros_like(v) for v in x)
        return torch.zeros_like(x)

    def all_to_all(self, x, axis: str):
        """``lax.all_to_all(x, axis, 0, 0)``: block i of the leading axis
        goes to shard i; returns the blocks received, in origin order,
        stacked on a new leading axis."""
        vals = self.exchange(axis, x)
        me = self.axis_index(axis)
        return torch.stack([v[me] for v in vals])

    def all_gather(self, x, axis: str, dim: int = 0):
        """``lax.all_gather(tiled=True)``: concatenated on ``dim``."""
        return torch.cat(self.exchange(axis, x), dim)

    def psum(self, x, axis: str):
        """``lax.psum``; a bool tensor sums to an OR."""
        vals = self.exchange(axis, x)
        if torch.is_tensor(x) and x.dtype == torch.bool:
            return torch.stack(vals).any(0)
        if not torch.is_tensor(x):
            return sum(vals)
        return torch.stack(vals).sum(0, dtype=x.dtype)


# ---------------------------------------------------------- tree helpers

def _is_leaf(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def _map(fn, tree, spec):
    """Apply ``fn(leaf, spec)`` over ``tree``; ``spec`` is a
    :class:`PartitionSpec` (for every leaf below) or a tree of the same
    structure."""
    if isinstance(spec, PartitionSpec) or spec is None:
        return _map_one(fn, tree, spec)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), getattr(spec, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, t, s) for t, s in zip(tree, spec, strict=True)]
        return type(tree)(out)
    return fn(tree, P())


def _map_one(fn, tree, spec):
    spec = P() if spec is None else spec
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_one(fn, getattr(tree, f.name), spec)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_one(fn, t, spec) for t in tree)
    return fn(tree, spec)


def _split(x, spec: PartitionSpec, mesh: Mesh, coords: tuple, device):
    """Shard ``coords``'s block of leaf ``x`` under ``spec``, on
    ``device`` (tensors) — a non-array leaf is passed as it is."""
    if not _is_leaf(x):
        return x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.shape[axis]
        idx = coords[mesh.axis_names.index(axis)]
        n = x.shape[dim]
        if n % size:
            raise ValueError(f"dimension {dim} of size {n} does not divide "
                             f"over the {size}-entry {axis!r} axis")
        blk = n // size
        x = x[(slice(None),) * dim + (slice(idx * blk, (idx + 1) * blk),)]
    if torch.is_tensor(x):
        x = x.to(device, non_blocking=True)
        if spec and any(a is not None for a in spec):
            x = x.contiguous()
    return x


def _stitch(parts: list, spec: PartitionSpec, mesh: Mesh, coords: list,
            device):
    """Inverse of :func:`_split` over every shard's output leaf: sharded
    dims concatenated, replicated leaves taken from the first shard."""
    first = parts[0]
    if not _is_leaf(first) or not any(a is not None for a in spec):
        return first.to(device, non_blocking=True) \
            if torch.is_tensor(first) else first
    byc = dict(zip(coords, parts))
    axes = [(d, a) for d, a in enumerate(spec) if a is not None]

    def build(level: int, fixed: dict):
        if level == len(axes):
            c = tuple(fixed.get(name, 0) for name in mesh.axis_names)
            v = byc[c]
            return v.to(device, non_blocking=True) if torch.is_tensor(v) \
                else v
        dim, axis = axes[level]
        blocks = [build(level + 1, {**fixed, axis: i})
                  for i in range(mesh.shape[axis])]
        if torch.is_tensor(blocks[0]):
            return torch.cat(blocks, dim)
        return np.concatenate(blocks, dim)

    return build(0, {})


def _leaves(tree) -> list:
    out = []
    _map_one(lambda x, s: out.append(x), tree, P())
    return out


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _map_one(lambda x, s: next(it), tree, P())


def shard_map(body, mesh: Mesh, in_specs, out_specs):
    """``f(*args)``: split every argument by ``in_specs`` (one spec tree
    an argument: a :class:`PartitionSpec` for all of it, or a dataclass,
    tuple or list of them), run ``body`` on each entry's block in its own
    thread with :func:`ctx` set, and stitch the outputs by ``out_specs``
    onto the first entry's device.  A shard's exception aborts the others
    and is raised here."""
    coords = list(np.ndindex(mesh.devices.shape))
    dev0 = mesh.devices.flat[0]

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map body takes {len(in_specs)} "
                            f"arguments, got {len(args)}")
        state = _MeshRun(mesh)
        streams = {}
        for d in mesh.devices.flat:
            if d.type == "cuda" and str(d) not in streams:
                streams[str(d)] = torch.cuda.current_stream(d)
        outs: list = [None] * len(coords)
        errors: list = []
        err_lock = threading.Lock()

        def work(i: int, c: tuple):
            dev = mesh.devices[c]
            _LOCAL.ctx = ShardContext(state, c)
            state.baton.acquire()
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                    with torch.cuda.stream(streams[str(dev)]):
                        local = [_map(lambda x, s: _split(x, s, mesh, c, dev),
                                      a, sp) for a, sp in zip(args, in_specs)]
                        outs[i] = body(*local)
                else:
                    local = [_map(lambda x, s: _split(x, s, mesh, c, dev),
                                  a, sp) for a, sp in zip(args, in_specs)]
                    outs[i] = body(*local)
            except BaseException as e:        # noqa: BLE001 — re-raised
                with err_lock:
                    if not isinstance(e, threading.BrokenBarrierError) \
                            or not errors:
                        errors.append(e)
                state.abort()
            finally:
                _LOCAL.ctx = None
                state.baton.release()

        threads = [threading.Thread(target=work, args=(i, c), daemon=True)
                   for i, c in enumerate(coords)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        if real or errors:
            raise (real or errors)[0]
        per_shard = [_leaves(o) for o in outs]
        specs = []
        _map(lambda x, s: specs.append(s), outs[0], out_specs)
        stitched = [_stitch([p[j] for p in per_shard], specs[j], mesh,
                            coords, dev0)
                    for j in range(len(specs))]
        return _unflatten(outs[0], stitched)

    return run

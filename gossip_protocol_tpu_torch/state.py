"""World state and schedule of the dense model, as torch tensors.

Counterpart of ``gossip_protocol_tpu/state.py``.  The fields and their
meaning are the JAX package's (see that module's docstring); two
representation choices differ:

* ``WorldState.tick`` is a Python int and ``WorldState.rng`` a numpy
  uint32[2] key.  Both live on the host: every per-tick decision that
  reads them (the drop window, the threefry ``fold_in``) is host
  arithmetic, so the loop never waits on the card to learn the clock.
* The schedule's per-peer columns are tensors on the run's device; its
  drop window (``drop_active``) stays a host numpy array.

The npz checkpoint schema is the JAX package's exactly (``tick`` as an
int32 scalar, ``rng`` as uint32[2], ``gossip_age`` as an all-zero
plane), so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .config import SimConfig
from .utils.threefry import prng_key

NEVER = np.iinfo(np.int32).max  # sentinel fail/rejoin tick: never


def resolve_device(device=None) -> torch.device:
    """The run's device: ``cuda`` unless the caller asks for ``cpu``.

    Raises instead of falling back when CUDA was asked for (or left as
    the default) and no card is visible: a run that silently moved to
    the CPU would report CPU numbers under the card's name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: gossip_protocol_tpu_torch runs on the "
            "card by default; pass device='cpu' (CLI: --device cpu) to run "
            "the plain PyTorch versions on the CPU")
    return dev


@dataclass
class WorldState:
    """Carried state of the simulation (JAX ``WorldState`` fields)."""

    tick: int                 # the global logical clock (host)
    in_group: torch.Tensor    # bool[N]
    own_hb: torch.Tensor      # i32[N]
    known: torch.Tensor       # bool[N, N]
    hb: torch.Tensor          # i32[N, N]
    ts: torch.Tensor          # i32[N, N]
    gossip: torch.Tensor      # bool[N, N] (sender, receiver)
    gossip_age: torch.Tensor  # i32[N, N], all zero (no latency world)
    joinreq: torch.Tensor     # bool[N]
    joinrep: torch.Tensor     # bool[N]
    rng: np.ndarray           # uint32[2] threefry key (host)

    @property
    def n(self) -> int:
        return self.known.shape[0]

    @property
    def device(self) -> torch.device:
        return self.known.device

    def replace(self, **kw) -> "WorldState":
        return dataclasses.replace(self, **kw)


@dataclass
class Schedule:
    """Per-run injection schedule (JAX ``Schedule``, course-world fields).

    ``start_tick``/``fail_tick``/``rejoin_tick`` are i32[N] — numpy from
    :func:`make_schedule_host`, tensors on the run's device from
    :func:`make_schedule`.  The drop window is host data either way.
    """

    start_tick: object
    fail_tick: object
    rejoin_tick: object
    drop_active: np.ndarray   # bool[T] — dropmsg flag during tick t's sends
    drop_prob: np.float32     # MSG_DROP_PROB
    drop_open: int            # exact window open < t <= close
    drop_close: int           #   ((-1, -2) = no window)

    def replace(self, **kw) -> "Schedule":
        return dataclasses.replace(self, **kw)

    def failed_at(self, t: int):
        """bool[N]: is peer i failed while processing tick ``t``?"""
        return (t > self.fail_tick) & (t <= self.rejoin_tick)

    def rejoining_at(self, t: int):
        """bool[N]: peers wiped and re-introduced at tick ``t``."""
        return self.rejoin_tick == t

    def drop_on(self, t: int) -> bool:
        """Is the drop window open for tick ``t``'s sends?  (A tick past
        the schedule reads its last entry, as jnp indexing clamps.)"""
        return bool(self.drop_active[min(t, len(self.drop_active) - 1)])


def make_schedule_host(cfg: SimConfig) -> Schedule:
    """Host (numpy) schedule — ``gossip_protocol_tpu.state.make_schedule_host``
    restricted to the course worlds (the port's config refuses the
    others).  Victims come from the shared counter-based hash PRNG, so
    one seed gives the same schedule in both packages."""
    from .utils.prng import fail_schedule_uniform

    n = cfg.n
    start = np.array([cfg.start_tick(i) for i in range(n)], np.int32)
    fail = np.full(n, NEVER, np.int32)
    u = fail_schedule_uniform(cfg.seed)
    if cfg.single_failure:
        victim = int(u * n) % n
        fail[victim] = cfg.fail_tick
    else:
        r = (int(u * n) % n) // 2
        fail[r: r + n // 2] = cfg.fail_tick
    rejoin = np.full(n, NEVER, np.int32)
    if cfg.rejoin_after is not None:
        if cfg.rejoin_after < 1:
            raise ValueError("rejoin_after must be >= 1")
        failed = fail != NEVER
        rejoin[failed] = fail[failed] + cfg.rejoin_after
    t = np.arange(cfg.total_ticks, dtype=np.int32)
    drop = np.zeros(cfg.total_ticks, bool)
    if cfg.drop_msg:
        drop = (t > cfg.drop_open_tick) & (t <= cfg.drop_close_tick)
    return Schedule(
        start_tick=start, fail_tick=fail, rejoin_tick=rejoin,
        drop_active=drop, drop_prob=np.float32(cfg.msg_drop_prob),
        drop_open=cfg.drop_open_tick if cfg.drop_msg else -1,
        drop_close=cfg.drop_close_tick if cfg.drop_msg else -2)


def make_schedule(cfg: SimConfig, device=None) -> Schedule:
    """:func:`make_schedule_host` with the per-peer columns on ``device``."""
    dev = resolve_device(device)
    s = make_schedule_host(cfg)
    return s.replace(
        start_tick=torch.from_numpy(s.start_tick).to(dev),
        fail_tick=torch.from_numpy(s.fail_tick).to(dev),
        rejoin_tick=torch.from_numpy(s.rejoin_tick).to(dev))


def slice_schedule(s: Schedule, a: int) -> Schedule:
    """Width-``a`` view of the per-peer columns (core/dense_corner.py)."""
    return s.replace(start_tick=s.start_tick[:a], fail_tick=s.fail_tick[:a],
                     rejoin_tick=s.rejoin_tick[:a])


def init_state(cfg: SimConfig, device=None) -> WorldState:
    """Fresh world state at tick 0 (``MP1Node::initThisNode``)."""
    dev = resolve_device(device)
    n = cfg.n

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return WorldState(
        tick=0, in_group=z(n, dtype=torch.bool),
        own_hb=z(n, dtype=torch.int32),
        known=z(n, n, dtype=torch.bool), hb=z(n, n, dtype=torch.int32),
        ts=z(n, n, dtype=torch.int32), gossip=z(n, n, dtype=torch.bool),
        gossip_age=z(n, n, dtype=torch.int32),
        joinreq=z(n, dtype=torch.bool), joinrep=z(n, dtype=torch.bool),
        rng=prng_key(cfg.seed))


_FIELDS = tuple(f.name for f in dataclasses.fields(WorldState))


def _expect_shapes(n: int) -> dict:
    return {"tick": (), "in_group": (n,), "own_hb": (n,),
            "known": (n, n), "hb": (n, n), "ts": (n, n),
            "gossip": (n, n), "gossip_age": (n, n),
            "joinreq": (n,), "joinrep": (n,), "rng": (2,)}


def state_to_host(state: WorldState) -> dict[str, np.ndarray]:
    """State -> the JAX package's host dict / npz schema."""
    out = {}
    for name in _FIELDS:
        v = getattr(state, name)
        if name == "tick":
            out[name] = np.asarray(v, np.int32)
        elif name == "rng":
            out[name] = np.asarray(v, np.uint32).copy()
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def state_from_host(host: dict, device=None) -> WorldState:
    """Inverse of :func:`state_to_host`; accepts the dict that
    ``gossip_protocol_tpu.state.state_to_host`` returns (schema-checked
    like the JAX package's ``struct_from_host``)."""
    dev = resolve_device(device)
    missing = set(_FIELDS) - host.keys()
    if missing:
        raise ValueError(f"checkpoint is missing fields: {sorted(missing)}")
    extra = host.keys() - set(_FIELDS)
    if extra:
        raise ValueError(
            f"checkpoint has unknown fields {sorted(extra)} — written by an "
            "incompatible WorldState schema?")
    n = np.asarray(host["known"]).shape[0]
    for k, shape in _expect_shapes(n).items():
        got = np.asarray(host[k]).shape
        if got != shape:
            raise ValueError(
                f"checkpoint field {k!r} has shape {got}, expected {shape}")
    if np.asarray(host["gossip_age"]).any():
        raise ValueError("checkpoint carries in-flight message ages (the "
                         "latency world), which the port does not run")
    kw = {}
    for name in _FIELDS:
        v = np.asarray(host[name])
        if name == "tick":
            kw[name] = int(v)
        elif name == "rng":
            kw[name] = v.astype(np.uint32).copy()
        else:
            kw[name] = torch.from_numpy(np.array(v)).to(dev)
    return WorldState(**kw)


def save_checkpoint(state: WorldState, path: str) -> None:
    """Write a mid-run checkpoint (.npz, the JAX package's schema).

    The path is used verbatim (np.savez would append ".npz" to an
    extension-less path)."""
    with open(path, "wb") as f:
        np.savez(f, **state_to_host(state))


def load_checkpoint(path: str, device=None) -> WorldState:
    """Load a checkpoint written by either package's ``save_checkpoint``."""
    with np.load(path) as z:
        return state_from_host({k: z[k] for k in z.files}, device)

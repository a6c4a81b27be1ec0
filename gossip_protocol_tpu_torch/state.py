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
int32 scalar, ``rng`` as uint32[2], ``gossip_age`` the latency world's
in-flight message ages), so a checkpoint written by either package
loads in the other.
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
    gossip_age: torch.Tensor  # i32[N, N] ticks the in-flight message has
                              #   waited (latency world; else all zero)
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
    """Per-run injection schedule (the JAX ``Schedule``).

    The per-peer columns (``start_tick``/``fail_tick``/``rejoin_tick``
    and the world arrays) are numpy from :func:`make_schedule_host`,
    tensors on the run's device from :func:`make_schedule`.  The drop
    window and every window scalar are host data either way.  A world
    that is off leaves its fields inert (zeros, or a (0, 0) plane), as
    in the JAX package.
    """

    start_tick: object
    fail_tick: object
    rejoin_tick: object
    drop_active: np.ndarray   # bool[T] — dropmsg flag during tick t's sends
    drop_prob: np.float32     # MSG_DROP_PROB
    drop_open: int            # exact window open < t <= close
    drop_close: int           #   ((-1, -2) = no window)
    # --- adversarial worlds (worlds.py) ---
    part_group: object = None  # i32[N] hashed partition group per node
    part_on: bool = False      # partition world configured
    part_open: int = 0         # cross-group sends blocked:
    part_close: int = 0        #   open < t <= close
    link_prob: object = None   # f32[N, N] per-link drop probability
                               #   (sender-major; (0, 0) when asym is off)
    flap_mask: object = None   # bool[N] which nodes flap
    flap_phase: object = None  # i32[N] absolute cycle anchor per node
    flap_period: int = 1
    flap_down: int = 0         # down ticks per period
    flap_close: int = -1       # last tick a cycle may end at
    byz_mask: object = None    # bool[N] seeded liars
    byz_target: object = None  # bool[N, N] ghost targets ((0, 0) when off)
    byz_boost: int = 0         # relayed-heartbeat inflation
    link_lat: object = None    # i32[N, N] per-link delay ((0, 0) when off)

    def replace(self, **kw) -> "Schedule":
        return dataclasses.replace(self, **kw)

    def flap_state(self, t: int):
        """(failed, rejoining) bool[N] under the flap world: a flapper is
        down for positions [1, flap_down] of every cycle from its anchor
        and rejoins at position flap_down, only for cycles completing by
        ``flap_close`` (JAX ``Schedule._flap_state``)."""
        per = self.flap_period
        # a canonical fleet carries the flap scalars a lane ([B, 1])
        per = per.clamp(min=1) if torch.is_tensor(per) else max(per, 1)
        pos = t - self.flap_phase
        c = pos // per
        off = pos - c * per
        ok = self.flap_mask & (pos >= 1) \
            & (self.flap_phase + c * per + self.flap_down <= self.flap_close)
        return (ok & (off >= 1) & (off <= self.flap_down),
                ok & (off == self.flap_down))

    def window_failed_at(self, t: int):
        """bool[N]: the scripted / churn / wave fail window alone (the
        failures the zombie world applies to)."""
        return (t > self.fail_tick) & (t <= self.rejoin_tick)

    def failed_at(self, t: int):
        """bool[N]: is peer i failed while processing tick ``t``?  The
        fail window, plus the flap world's down phases."""
        f, _ = self.flap_state(t)
        return self.window_failed_at(t) | f

    def rejoining_at(self, t: int):
        """bool[N]: peers wiped and re-introduced at tick ``t`` (the
        churn rejoin, plus every flap up-edge)."""
        _, r = self.flap_state(t)
        return (self.rejoin_tick == t) | r

    def part_active_at(self, t: int) -> bool:
        """Are cross-group sends blocked at tick ``t``?  (host)"""
        return bool(self.part_on) and self.part_open < t <= self.part_close

    def drop_on(self, t: int) -> bool:
        """Is the drop window open for tick ``t``'s sends?  (A tick past
        the schedule reads its last entry, as jnp indexing clamps.)"""
        return bool(self.drop_active[min(t, len(self.drop_active) - 1)])


#: the schedule's per-peer columns and planes (numpy on the host, tensors
#: on the run's device)
SCHED_ARRAYS = ("start_tick", "fail_tick", "rejoin_tick", "part_group",
                "link_prob", "flap_mask", "flap_phase", "byz_mask",
                "byz_target", "link_lat")


def make_schedule_host(cfg: SimConfig) -> Schedule:
    """Host (numpy) schedule — ``gossip_protocol_tpu.state.make_schedule_host``.
    Victims come from the shared counter-based hash PRNG (a wave's from
    ``worlds.wave_fail_ticks``), so one seed gives the same schedule in
    both packages."""
    from . import worlds
    from .utils.prng import fail_schedule_uniform

    n = cfg.n
    start = np.array([cfg.start_tick(i) for i in range(n)], np.int32)
    if cfg.wave_size > 0:
        fail = worlds.wave_fail_ticks(cfg)
    else:
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
    part_open, part_close = worlds.partition_window(cfg)
    _, flap_close = worlds.flap_window(cfg)
    return Schedule(
        start_tick=start, fail_tick=fail, rejoin_tick=rejoin,
        drop_active=drop, drop_prob=np.float32(cfg.msg_drop_prob),
        drop_open=cfg.drop_open_tick if cfg.drop_msg else -1,
        drop_close=cfg.drop_close_tick if cfg.drop_msg else -2,
        part_group=worlds.partition_groups_host(cfg),
        part_on=cfg.partition_groups >= 2,
        part_open=int(part_open), part_close=int(part_close),
        link_prob=worlds.link_prob_host(cfg),
        flap_mask=worlds.flap_mask_host(cfg),
        flap_phase=worlds.flap_anchor_host(cfg),
        flap_period=max(cfg.flap_period, 1), flap_down=cfg.flap_down,
        flap_close=int(flap_close) if cfg.flap_rate > 0 else -1,
        byz_mask=worlds.byz_mask_host(cfg),
        byz_target=worlds.byz_target_host(cfg),
        byz_boost=cfg.byz_boost,
        link_lat=worlds.link_latency_host(cfg))


def make_schedule(cfg: SimConfig, device=None) -> Schedule:
    """:func:`make_schedule_host` with the per-peer columns and planes
    on ``device``."""
    dev = resolve_device(device)
    s = make_schedule_host(cfg)
    return s.replace(**{k: torch.from_numpy(np.ascontiguousarray(
        getattr(s, k))).to(dev) for k in SCHED_ARRAYS})


def slice_schedule(s: Schedule, a: int) -> Schedule:
    """Width-``a`` view of the per-peer columns (core/dense_corner.py;
    the corner is gated off for world configs, so the world fields
    sliced here are inert)."""
    out = {}
    for k in SCHED_ARRAYS:
        v = getattr(s, k)
        out[k] = v if v.shape[0] == 0 else (
            v[:a] if v.ndim == 1 else v[:a, :a])
    return s.replace(**out)


def pad_schedule_host(s: Schedule, width: int) -> Schedule:
    """Embed a width-``n`` host schedule into a width-``width`` one with
    INERT filler peers (JAX ``state.pad_schedule_host``; the canonical
    pad-ladder of service/canonical.py).  Filler peers get
    ``start_tick = NEVER``: never introduced, never known, their state
    rows stay zero, so the real ``n x n`` corner of a padded run equals
    the unpadded run bit for bit.  Planes pad with values that are dead
    by construction: ``link_prob`` 0, ``byz_target`` False, ``link_lat``
    1; a (0, 0) plane (world off) stays as it is.  Window scalars and
    ``drop_active`` are width-independent and pass through."""
    n = int(np.asarray(s.start_tick).shape[0])
    if width == n:
        return s
    if width < n:
        raise ValueError(f"pad width {width} < schedule width {n}")

    def vec(a, fill):
        a = np.asarray(a)
        out = np.full((width,), fill, a.dtype)
        out[:n] = a
        return out

    def plane(a, fill):
        a = np.asarray(a)
        if a.size == 0:
            return a
        out = np.full((width, width), fill, a.dtype)
        out[:n, :n] = a
        return out

    return s.replace(
        start_tick=vec(s.start_tick, NEVER),
        fail_tick=vec(s.fail_tick, NEVER),
        rejoin_tick=vec(s.rejoin_tick, NEVER),
        part_group=vec(s.part_group, 0),
        link_prob=plane(s.link_prob, 0.0),
        flap_mask=vec(s.flap_mask, False),
        flap_phase=vec(s.flap_phase, 0),
        byz_mask=vec(s.byz_mask, False),
        byz_target=plane(s.byz_target, False),
        link_lat=plane(s.link_lat, 1))


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

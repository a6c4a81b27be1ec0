"""Bucket canonicalization: bound the program surface of a mixed mix
(port of ``gossip_protocol_tpu/service/canonical.py``; its keys are the
JAX package's tuples).

The scenario grammar (25 families x 8 worlds, jittered per
request) drives the exact bucket key (service/bucket.py) toward
every-request-its-own-bucket — each paying a fresh program build, the
failure mode continuous-batching servers solve with shape bucketing
(Orca, OSDI'22).  This module collapses near-identical dense trace
requests into CANONICAL equivalence classes along three layers:

* **n pad-ladder** — a dense config's peer count is padded up to the
  next power-of-two rung with INERT filler peers
  (state.pad_schedule_host: never introduced, never known, state rows
  identically zero) and results are sliced back to the real ``n``
  host-side, so ``fleet_shape_key``'s ``n`` component quantizes to
  ladder rungs.
* **plan-signature equivalence classes** — phase windows quantize to
  the ``CHECKPOINT_GRID_TICKS`` grid
  (models/segments.quantized_plan_signature); the exact windows ride
  as Schedule data (``drop_open``/``drop_close`` scalars, the
  injection arrays).
* **runtime world operands** — world parameters the compiled tick
  never bakes (drop probability, byz_boost, wave radius/rate, flap
  knobs, the partition/flap windows, link matrices —
  worlds.OPERAND_WORLD_FIELDS) are dropped from the key entirely;
  only the active-plane SET stays static
  (worlds.canonical_world_key), matching exactly the booleans
  ``core/tick.make_tick`` branches on.  The drop-draw window stays
  (quantized) key material, as in the JAX package, whose class-shared
  ``drop_active`` plane it builds.  The port needs no shared window:
  each lane's exact window is its own row of the fleet's drop plan
  (core/fleet.py ``CanonicalFleetSimulation``), which draws the same
  bits, since the draw depends only on (key, tick, stream width).

Honesty gate: a canonical run must be BIT-IDENTICAL to its exact solo
run (tests/test_torch_canonical.py).

Scope: canonicalization serves MONOLITHIC dense trace dispatches.
Overlay configs compile ~the whole config statically (their
fleet_shape_key is the config), dense bench mode bakes the
active-corner width, and checkpoint legs validate resume cuts against
the exact plan — all three keep the exact bucket key, and
:func:`canonical_bucket_key` falls back to it.
"""

from __future__ import annotations

from ..config import SimConfig
from ..models.segments import quantized_plan_signature
from .types import MODES

#: smallest pad-ladder rung: below this every n shares one program
#: anyway and padding overhead is noise
LADDER_MIN = 4


class CanonicalLegUnsupported(NotImplementedError, ValueError):
    """Canonical buckets cannot serve checkpoint legs.

    Legs validate resume cuts against the EXACT segment plan
    (models/segments.py), which is precisely what canonical buckets
    quantize away — a canonical leg would accept cuts its members'
    exact plans reject.  Raised TYPED and EARLY: at ``FleetService``
    construction when ``canonicalize=True`` meets
    ``checkpoint_every``/``checkpoint_every_s``, and at the canonical
    engine's own leg entrypoints (core/fleet.py
    ``CanonicalFleetSimulation.run_leg``/``launch_leg``) for direct
    engine users — never deep inside leg resolve.  Serve legged work
    from exact buckets (``canonicalize=False``); docs/SERVING.md
    'Bucket canonicalization' documents the trade.

    Subclasses both ``NotImplementedError`` (the engine's historical
    spelling for unserved canonical modes) and ``ValueError`` (the
    service's constructor-gate spelling), so both matchers keep
    working."""


def ladder_rung(n: int, multiple: int = 1) -> int:
    """Next power-of-two rung >= max(n, LADDER_MIN) that ``multiple``
    divides.  ``multiple`` must itself be a power of two (the ladder
    doubles, so any other multiple could never be reached): the mesh
    serving path passes its peer-shard count, snapping every rung to
    peer-shard-divisible widths so filler peer rows can never change
    the peer-axis decomposition."""
    m = int(multiple)
    if m < 1 or m & (m - 1):
        raise ValueError(
            f"ladder_rung multiple must be a power of two (the pad "
            f"ladder doubles), got {multiple}")
    r = LADDER_MIN
    while r < n or r % m:
        r *= 2
    return r


def canonical_supported(cfg: SimConfig, mode: str) -> bool:
    """May this request be served from a canonical bucket?  Dense
    trace only (see module docstring for why overlay and bench keep
    exact keys)."""
    return cfg.model != "overlay" and mode == "trace"


def canonical_fleet_shape_key(cfg: SimConfig, peers: int = 1) -> tuple:
    """The pad-ladder twin of ``core/fleet.fleet_shape_key`` for dense
    configs: ``n`` quantizes to its ladder rung, and the worlds tail
    reduces to the static plane booleans the tick actually bakes.

    ``stream_n`` pins the REAL peer count for drop/asym configs: the
    Bernoulli drop lattice is drawn at the real width and embedded
    into the rung (make_tick ``n_active``), so lanes of different real
    n cannot share a drop-on program without changing each other's
    draw stream — no cross-n collapse there, by bit-identity.  Drop-off
    configs never take the draw branch, so their rung programs are
    width-only and collapse across n freely.

    ``peers`` (a power of two; the mesh serving path's FULL-STRENGTH
    peer-shard count) snaps the rung to peer-shard-divisible widths —
    the key carries the snapped rung, not ``peers`` itself, so peer
    counts that land on the same rung still share a class.
    """
    rung = ladder_rung(cfg.n, multiple=peers)
    stream_n = cfg.n if (cfg.drop_msg or cfg.asym_drop) else None
    return ("canon_full_view", rung, stream_n, cfg.t_remove,
            cfg.total_ticks,
            # exactly the static branch booleans of make_tick
            cfg.rejoin_after is not None or cfg.flap_rate > 0,  # churn
            cfg.partition_groups >= 2,                          # partition
            cfg.asym_drop,                                      # asym
            cfg.zombie,                                         # zombie
            cfg.byz_rate > 0,                                   # byz
            cfg.link_latency > 0)                               # latency


def canonical_bucket_key(cfg: SimConfig, mode: str,
                         peers: int = 1) -> tuple:
    """Equivalence-class key: requests with equal keys ride ONE
    compiled canonical program.  Falls back to the exact
    ``bucket_key`` when canonicalization does not apply — the caller
    can always tell which it got (canonical keys lead with
    ``"canon"``).  ``peers`` snaps the pad ladder to peer-shard-
    divisible rungs (see :func:`canonical_fleet_shape_key`); the
    service pins its full-strength peer count here so elastic
    peer-shard shrink never moves a request's bucket key."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if not canonical_supported(cfg, mode):
        from .bucket import bucket_key
        return bucket_key(cfg, mode)
    return ("canon", mode, canonical_fleet_shape_key(cfg, peers=peers),
            quantized_plan_signature(cfg))

"""Configuration system (copy of ``gossip_protocol_tpu/config.py``).

The port keeps its own copy so it never imports the JAX package.  The
fields, defaults, validation and ``to_dict`` are identical, so a config
built by either package compares equal field for field.  One addition:
the port runs the dense full-view model and the overlay, every
adversarial world of ``worlds.py`` included, so any other model name
raises ``NotImplementedError`` instead of silently computing something
else.

Replacement for the reference's ``Params`` class
(reference: Params.h:21-36, Params.cpp:19-50).  The reference reads a
4-line positional ``.conf`` file (Params.cpp:22-25) and derives everything
else from compile-time constants (Application.h:27 TOTAL_RUNNING_TIME=700,
MP1Node.h:21-22 TREMOVE=20/TFAIL=5, EmulNet.h:10-12 buffer limits,
Params.cpp:29-31 STEP_RATE/MAX_MSG_SIZE/PORTNUM).

Here everything is one frozen dataclass.  The legacy ``.conf`` grammar is
still ingested by :func:`SimConfig.from_conf` so the reference's
``testcases/*.conf`` files work unmodified, and extended knobs (seed,
peer count overrides, topology family, churn) are first-class fields
instead of hardcoded constants.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional

#: Index (0-based) of the introducer/coordinator peer.  The reference
#: hardwires the join address to id=1:port=0 (Application.cpp:209-217,
#: MP1Node.cpp:378-386); ids are assigned sequentially from 1
#: (EmulNet.cpp:72-77), so the introducer is always peer index 0.
INTRODUCER = 0


@dataclass(frozen=True)
class SimConfig:
    """All parameters of one simulation scenario.

    Field names follow the reference's .conf keys where they exist
    (Params.cpp:22-25); the rest mirror the reference's compile-time
    constants with the same defaults.
    """

    # --- legacy .conf fields (Params.cpp:22-25) ---
    max_nnb: int = 10            # MAX_NNB -> number of peers (EN_GPSZ = MAX_NNB, Params.cpp:29)
    single_failure: bool = True  # SINGLE_FAILURE
    drop_msg: bool = False       # DROP_MSG
    msg_drop_prob: float = 0.1   # MSG_DROP_PROB

    # --- reference compile-time constants ---
    total_ticks: int = 700       # TOTAL_RUNNING_TIME (Application.h:27)
    step_rate: float = 0.25      # Params.cpp:30; node i starts at int(step_rate*i)
    t_remove: int = 20           # TREMOVE (MP1Node.h:21)
    t_fail: int = 5              # TFAIL (MP1Node.h:22) — vestigial in the reference too
    portnum: int = 8001          # Params.cpp:12 — note ENinit still assigns port 0
    max_msg_size: int = 4000     # Params.cpp:31
    en_buff_size: int = 30000    # ENBUFFSIZE (EmulNet.h:12)
    fail_tick: int = 100         # failure injection time (Application.cpp:181,188)
    drop_open_tick: int = 50     # drop window opens (Application.cpp:177)
    drop_close_tick: int = 300   # drop window closes (Application.cpp:198)

    # --- new framework knobs (absent in the reference) ---
    #: PRNG seed.  The reference uses ``srand(time(NULL))`` twice
    #: (Application.cpp:50,96) so its runs are irreproducible; we default
    #: to a fixed seed and treat reproducibility as a feature.
    seed: int = 0
    #: Protocol/model family: "full_view" reproduces the reference's
    #: all-pairs full-list heartbeating; "overlay" is the bounded
    #: partial-view family for very large N (BASELINE.json 65k/1M configs).
    model: str = "full_view"
    #: Overlay exchange fanout (only used by model="overlay");
    #: 0 = auto (~log2(N)/2 + 2, see models/overlay.py resolved_dims).
    fanout: int = 0
    #: Overlay view capacity K (slots per node; models/overlay.py).
    #: 0 = auto (~4*log2 N, capped at 64).  Right-sizing matters: too
    #: large a view at small N starves slots of merge candidates.
    overlay_view: int = 0
    #: Overlay payload sample L: view slots carried per message
    #: (rotating window; full view every K/L ticks).  0 = auto (K/2).
    overlay_sample: int = 0
    #: Exchange-graph degree family (overlay only).  "uniform": every
    #: node gossips on all F rounds each tick (Erdős–Rényi-flavored —
    #: the BASELINE 65k shape).  "powerlaw": per-node out-degrees
    #: follow a bounded Pareto tail (P[deg >= k] ~ k^-(alpha-1), the
    #: BASELINE 1M scale-free shape): a few hubs gossip on many rounds,
    #: most nodes on few.  Degrees are a static seeded node property.
    topology: str = "uniform"
    #: Pareto tail exponent for topology="powerlaw".
    powerlaw_alpha: float = 2.5
    #: Churn rate per tick (overlay extension; 0 disables).
    churn_rate: float = 0.0
    #: Churn/rejoin extension (SURVEY.md §5 — the reference never
    #: re-admits a failed node): failed peers are wiped and re-introduced
    #: ``rejoin_after`` ticks after their failure, rejoining through the
    #: normal JOINREQ path.  None disables (reference behavior).
    rejoin_after: Optional[int] = None

    # --- adversarial failure worlds (worlds.py; closed-form
    # --- (seed, tick, node) draws shared by both models) ---
    #: Network partition: >= 2 hashes every node into that many
    #: groups; cross-group sends are blocked while the window below is
    #: open (heals when it closes).  0 disables.
    partition_groups: int = 0
    #: Partition window: cross-group sends blocked for
    #: ``open < t <= close`` (the drop-window convention).
    partition_open_tick: int = 0
    partition_close_tick: int = 0
    #: Asymmetric per-link drop: replaces the uniform ``msg_drop_prob``
    #: with a hashed per-(sender, receiver) threshold of mean
    #: ``msg_drop_prob`` (max ~2x), active during the drop window.
    asym_drop: bool = False
    #: Correlated failure wave: > 0 fails that many nodes in the
    #: contiguous ring block from a seeded epicenter, one radius step
    #: per ``wave_speed`` ticks from ``wave_tick`` (-1: ``fail_tick``).
    #: Replaces the scripted single/multi failure, like churn does.
    wave_size: int = 0
    wave_tick: int = -1
    wave_speed: int = 1
    #: Zombie / stale-table peers: window-failed peers keep gossiping
    #: their frozen table (and frozen heartbeat) instead of going
    #: silent — the false-positive stress world.
    zombie: bool = False
    #: Flapping members: > 0 selects that fraction of nodes to fail and
    #: rejoin periodically inside ``[flap_open, flap_close]`` with a
    #: closed-form duty cycle (down ``flap_down`` of every
    #: ``flap_period`` ticks; -1 windows default to the churn
    #: machinery's quarter points).
    flap_rate: float = 0.0
    flap_period: int = 32
    flap_down: int = 8
    flap_open_tick: int = -1
    flap_close_tick: int = -1
    #: Byzantine forgery plane: > 0 selects that fraction of
    #: nodes as seeded liars (introducer exempt).  Liars inflate their
    #: own heartbeat counter, relay their table at forged freshness
    #: with heartbeats inflated by ``byz_boost``, and advertise a
    #: hashed set of ghost members they have never heard from.  The
    #: direct-sender-credit defense (liveness evidence is direct-only)
    #: compiles in with the plane — see worlds.py.
    byz_rate: float = 0.0
    byz_boost: int = 8
    #: Per-link latency plane: maximum EXTRA delivery delay
    #: in ticks.  Link (i -> j) delivers gossip after
    #: ``1 + mix32(seed, i*n+j, SALT_LAT) % (link_latency + 1)`` ticks
    #: (same hashed-link construction as asym_drop); 0 disables —
    #: every link keeps the reference's one-tick delivery.  Applies to
    #: gossip only (the introducer join path stays one-tick, so the
    #: segment planner's join windows are untouched).
    link_latency: int = 0

    def __post_init__(self):
        self._validate()
        if self.model not in ("full_view", "overlay"):
            raise NotImplementedError(
                f"model={self.model!r} is not a model of "
                "gossip_protocol_tpu_torch (full_view or overlay)")

    def _validate(self):
        if self.model == "overlay":
            n = self.max_nnb
            if n < 4 or n & (n - 1) != 0:
                lo = 1 << max(2, n.bit_length() - 1)
                hi = max(4, 1 << n.bit_length())
                near = lo if (n - lo) <= (hi - n) else hi
                raise ValueError(
                    f"overlay peer count must be a power of two >= 4 "
                    f"(the XOR partner exchange pairs node i with "
                    f"i ^ mask over a 2^b address space), got n={n}; "
                    f"nearest valid n is {near} (or {lo}/{hi})")
        if self.partition_groups == 1 or self.partition_groups < 0:
            raise ValueError(
                f"partition_groups must be 0 (off) or >= 2, got "
                f"{self.partition_groups}")
        if self.partition_groups >= 2:
            if self.partition_close_tick <= self.partition_open_tick:
                raise ValueError(
                    f"partition window ({self.partition_open_tick}, "
                    f"{self.partition_close_tick}] is empty; close must "
                    "exceed open")
            # a window that opens after the run ends silently never
            # engages (same early-failure rule as the flap window;
            # close past the end is legal — "never heals")
            if self.partition_open_tick >= self.total_ticks:
                raise ValueError(
                    f"partition opens at tick "
                    f"{self.partition_open_tick}, after the run ends "
                    f"at {self.total_ticks} — the world would never "
                    "engage")
        if self.asym_drop:
            if not self.drop_msg:
                raise ValueError(
                    "asym_drop rides the drop window; set drop_msg=True")
            if not 0.0 < self.msg_drop_prob < 0.5:
                raise ValueError(
                    f"asym_drop needs 0 < msg_drop_prob < 0.5 (per-link "
                    f"probabilities reach 2x the mean), got "
                    f"{self.msg_drop_prob}")
        if self.wave_size < 0:
            raise ValueError(f"wave_size must be >= 0, got {self.wave_size}")
        if self.wave_size > 0:
            if self.wave_speed < 1:
                raise ValueError(
                    f"wave_speed must be >= 1, got {self.wave_speed}")
            if self.churn_rate > 0:
                raise ValueError(
                    "wave_size and churn_rate both replace the scripted "
                    "failure; enable at most one")
            start = self.fail_tick if self.wave_tick < 0 else self.wave_tick
            if start >= self.total_ticks:
                raise ValueError(
                    f"wave epicenter fails at tick {start}, after the "
                    f"run ends at {self.total_ticks} — the world would "
                    "never engage")
        if self.flap_rate < 0 or self.flap_rate > 1:
            raise ValueError(
                f"flap_rate must be in [0, 1], got {self.flap_rate}")
        if self.flap_rate > 0:
            if not 1 <= self.flap_down < self.flap_period:
                raise ValueError(
                    f"flapping needs 1 <= flap_down < flap_period, got "
                    f"down={self.flap_down} period={self.flap_period}")
            # the resolved window must admit at least one completable
            # cycle (anchor = flap_open in the best case), or the
            # world silently never engages — fail early instead
            lo = self.total_ticks // 4 if self.flap_open_tick < 0 \
                else self.flap_open_tick
            hi = (3 * self.total_ticks) // 4 if self.flap_close_tick < 0 \
                else self.flap_close_tick
            if lo + self.flap_down > hi:
                raise ValueError(
                    f"flap window [{lo}, {hi}] cannot complete a "
                    f"single down phase of {self.flap_down} ticks — "
                    "no node would ever flap; widen the window or "
                    "shrink flap_down")
        if self.byz_rate < 0 or self.byz_rate > 1:
            raise ValueError(
                f"byz_rate must be in [0, 1], got {self.byz_rate}")
        if self.byz_rate > 0 and self.byz_boost < 1:
            raise ValueError(
                f"the Byzantine plane needs byz_boost >= 1 (a 0-boost "
                f"liar forges nothing), got {self.byz_boost}")
        if self.link_latency < 0 or self.link_latency > 23:
            # delays draw in [1, link_latency + 1], so 23 caps the
            # overlay's send-history bitmask at 24 bits — f32 is exact
            # only for integers below 2^24, and the history word rides
            # the f32 permutation matmuls
            raise ValueError(
                f"link_latency must be in [0, 23] ticks, got "
                f"{self.link_latency}")
        if self.link_latency > 0 \
                and self.link_latency + 1 >= self.t_remove:
            raise ValueError(
                f"link_latency={self.link_latency} reaches the "
                f"staleness horizon t_remove={self.t_remove}: a clean "
                "slow link would manufacture false removals; keep "
                "link_latency + 1 < t_remove")

    def worlds_key(self) -> tuple:
        """Hashable digest of the ACTIVE adversarial worlds — the
        static-branch knobs a compiled tick bakes in.  Empty for the
        course worlds; folded into the dense fleet shape key, the
        run-cache keys, and the kernel support gates (the Pallas
        mega/grid kernels do not compile the new worlds — world
        configs take the XLA paths).

        This is the EXACT key: it pins every world parameter, which
        is what the solo run cache and checkpoint-leg validation
        need.  The serving layer's canonical tier keeps only the
        plane TAGS and moves the parameters to runtime operands
        (worlds.canonical_world_key / OPERAND_WORLD_FIELDS) —
        a change here must be mirrored there or the canonical
        completeness pass (``canon-key-complete``) will name the
        uncovered field."""
        ws = []
        if self.partition_groups >= 2:
            ws.append(("part", self.partition_groups,
                       self.partition_open_tick,
                       self.partition_close_tick))
        if self.asym_drop:
            ws.append(("asym",))
        if self.wave_size > 0:
            ws.append(("wave", self.wave_size, self.wave_tick,
                       self.wave_speed))
        if self.zombie:
            ws.append(("zombie",))
        if self.flap_rate > 0:
            ws.append(("flap", self.flap_rate, self.flap_period,
                       self.flap_down, self.flap_open_tick,
                       self.flap_close_tick))
        if self.byz_rate > 0:
            ws.append(("byz", self.byz_rate, self.byz_boost))
        if self.link_latency > 0:
            ws.append(("lat", self.link_latency))
        return tuple(ws)

    @property
    def has_worlds(self) -> bool:
        return bool(self.worlds_key())

    @property
    def has_latency(self) -> bool:
        """The per-link latency plane is on (kernel gates check this
        explicitly, though ``lat`` in :meth:`worlds_key` already routes
        latency configs off every fused path via ``has_worlds``)."""
        return self.link_latency > 0

    @property
    def n(self) -> int:
        """Number of peers (the reference's EN_GPSZ, Params.cpp:29)."""
        return self.max_nnb

    def start_tick(self, i: int) -> int:
        """Tick at which peer index ``i`` is introduced.

        Reference: nodes start when ``t == (int)(STEP_RATE*i)``
        (Application.cpp:143), i.e. C truncation of 0.25*i.
        """
        return int(self.step_rate * i)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    # --- journal serialization (store/journal.py) -------------------
    def to_dict(self) -> dict:
        """JSON-ready field dict.

        Every field is an int/float/bool/str/None scalar, so
        ``json.dumps(cfg.to_dict())`` round-trips exactly (Python's
        float repr is lossless) — the write-ahead journal and the
        spilled-checkpoint headers (gossip_protocol_tpu/store/) both
        persist configs this way and must get back an ``==`` config.
        The port keeps the same schema, so the two packages' dicts of
        one scenario are equal.
        """
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        """Inverse of :meth:`to_dict`.

        Unknown keys are dropped rather than rejected so a journal
        written by a NEWER config schema still replays on an older
        one (the surviving fields keep their recorded values; missing
        fields take defaults) — recovery re-validates results by
        digest, so a semantic mismatch fails loudly downstream
        instead of here.
        """
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    # --- legacy .conf ingestion -------------------------------------
    @classmethod
    def from_conf(cls, path: str, **overrides) -> "SimConfig":
        """Parse a reference-format .conf file (Params.cpp:22-25).

        The reference reads exactly four ``KEY: value`` lines in fixed
        order with fscanf; we accept them in any order and ignore
        unknown keys, but the three shipped testcases parse bit-identically.
        """
        keys = {}
        with open(path, "r") as f:
            for line in f:
                m = re.match(r"\s*([A-Z_]+)\s*:\s*([0-9.eE+-]+)", line)
                if m:
                    keys[m.group(1)] = m.group(2)
        if "MAX_NNB" not in keys and "max_nnb" not in overrides:
            # A conf that never mentions MAX_NNB is malformed or
            # mis-pathed (the reference's positional fscanf would read
            # garbage, Params.cpp:22-25); refuse to silently simulate
            # the defaults.  native/params.cc applies the same rule.
            raise ValueError(f"no MAX_NNB key in {path}")
        kw = {}
        if "MAX_NNB" in keys:
            kw["max_nnb"] = int(keys["MAX_NNB"])
        if "SINGLE_FAILURE" in keys:
            kw["single_failure"] = bool(int(keys["SINGLE_FAILURE"]))
        if "DROP_MSG" in keys:
            kw["drop_msg"] = bool(int(keys["DROP_MSG"]))
        if "MSG_DROP_PROB" in keys:
            kw["msg_drop_prob"] = float(keys["MSG_DROP_PROB"])
        kw.update(overrides)
        return cls(**kw)


#: The three scenarios shipped with the reference (testcases/*.conf).
SINGLE_FAILURE = SimConfig(max_nnb=10, single_failure=True, drop_msg=False)
MULTI_FAILURE = SimConfig(max_nnb=10, single_failure=False, drop_msg=False)
MSG_DROP_SINGLE_FAILURE = SimConfig(max_nnb=10, single_failure=True, drop_msg=True,
                                    msg_drop_prob=0.1)

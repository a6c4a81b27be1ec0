"""The yardstick's roofline arithmetic: the card's published rates and
the least time of the simulated work.

The rates and the per-kernel counts are copies of ``chip_smoke.py``'s
(line numbers beside each), kept here so that a change to the program
cannot move them.  What a cell's roofline share divides by is the least
time of the *work* a window simulated (ticks, peers, lanes, and where
the work depends on the data, the run's own statistics), never of the
kernels that happen to do it:

* a dense tick (:func:`dense_tick_least_ms`) reads and writes the
  protocol's state once (the in-flight gossip and the membership table,
  heartbeats and timestamps, 10 bytes a cell each way), draws the drop
  lattice where the window is open (:func:`draw_bound`'s operations) and
  runs the cell rules (the epilogue's 40 operations a cell).  The merge's
  maxima and the drop masks are intermediate data a fused design need
  not write, so their bytes are not counted, nor the merge's operations,
  whose number depends on the algorithm (the tensor-core product count
  of ``merge_stats`` measures today's descent, not the work);
* an overlay launch of 16 ticks is :func:`k5_work` (the plane read and
  written once where it fits on the chip, 8 operations a merge candidate
  of each merge received, 40 a slot and 30 a row a tick for extraction,
  detection and decisions, 8 a slot at a re-slot), its received merges
  read from the lane's own metrics.

Where a count is unsure it counts less, so a share cannot pass 100%.
"""

from __future__ import annotations

import math

import numpy as np

#: H100 SXM HBM3 (NVIDIA data sheet); chip_smoke.py:265
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM int32 outside the tensor cores: 132 SMs x 64 INT32 lanes x
#: 1.98 GHz boost clock (Hopper white paper); chip_smoke.py:268
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: the 50 MB L2 and 132 SMs' 227 KB of shared memory; chip_smoke.py:273
ON_CHIP_BYTES = 50e6 + 132 * 232448


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms: bytes over the HBM rate or int32 operations over
    the INT32 rate, the larger (chip_smoke.py:568-571)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def draw_bound(n: int, na: int, drawn_ticks: int,
               s_ticks: int) -> tuple[float, str]:
    """The drop draw: S (N^2 + 2N) output bytes against 70 int32
    operations an element of each open tick (chip_smoke.py:1245-1255)."""
    return bound(s_ticks * (n * n + 2 * n), 70 * drawn_ticks * (na + 2) * na)


def draw_ops(na: int) -> int:
    """The draw's operations for one open tick at width ``na``
    (chip_smoke.py:1255)."""
    return 70 * (na + 2) * na


def boot_bound(n: int, k: int, batch: int = 1,
               needed: bool = False) -> tuple[float, str]:
    """K5's boot pre-pass: a 32-byte sector (4 bytes needed) a row read,
    the K-word aggregate written, 25 operations a row
    (chip_smoke.py:1234-1242)."""
    return bound(batch * ((4 if needed else 32) * n + 4 * k),
                 batch * 25 * n)


def merge_needed_bytes(n: int, senders_delivering: int) -> int:
    """The merge's needed bytes: gossip and proc read, known / hb / ts (9
    bytes a cell) of the senders that deliver, three i32 maxima written
    (chip_smoke.py:700-702)."""
    return n * n * (1 + 12) + n + 9 * n * senders_delivering


def epilogue_work(n: int, with_events: bool = False) -> tuple[int, int]:
    """The tick epilogue's bytes and operations (chip_smoke.py:755-758)."""
    nbytes = n * n * (12 + 8 + 3 + 8 + 2 + (2 if with_events else 0)) \
        + 13 * n
    return nbytes, 40 * n * n


def k5_work(n: int, k: int, recv: int, s_ticks: int, reslots: int,
            needed: bool = False) -> tuple[float, float]:
    """Bytes and operations of one K5 call of ``s_ticks`` ticks that
    received ``recv`` merges (chip_smoke.py:1200-1231)."""
    plane = 4 * n * 128
    if 2 * plane <= ON_CHIP_BYTES:
        nbytes = plane + 4 * 8 * 128 + 2 * plane
    else:
        nbytes = 2 * s_ticks * plane
    nbytes += 4 * s_ticks * 128
    if needed:
        nbytes += recv * 2 * k * 4
    ops = recv * 8 * (k + 1) + s_ticks * n * (40 * k + 30) \
        + reslots * n * 8 * k
    return nbytes, ops


# ------------------------------------------------------ a window's work

#: bytes a dense cell's state takes: in-flight gossip (1), known (1),
#: heartbeat (4), timestamp (4)
DENSE_STATE_BYTES = 10


def dense_tick_least_ms(a: int, drawn: bool) -> float:
    """One lane's dense tick at the active width ``a``: the state read and
    written once, the cell rules' and (window open) the draw's
    operations."""
    ops = epilogue_work(a)[1] + (draw_ops(a) if drawn else 0)
    return bound(2 * DENSE_STATE_BYTES * a * a, ops)[0]


def dense_run_least_s(conf: dict, width: int, lanes: int) -> float:
    """A fleet of ``lanes`` whole bench runs at width ``width``."""
    ms = 0.0
    for t in range(conf["total_ticks"]):
        drawn = bool(conf["drop_msg"]) \
            and conf["drop_open_tick"] < t <= conf["drop_close_tick"]
        ms += dense_tick_least_ms(width, drawn)
    return lanes * ms / 1e3


def overlay_dims(conf: dict) -> int:
    """K, the view slots (auto: ~4 log2 N, 16..64)."""
    b = int(math.ceil(math.log2(max(conf["max_nnb"], 4))))
    return conf.get("overlay_view", 0) or min(64, max(16, 8 * ((b + 1) // 2)))


def overlay_run_least_s(conf: dict, recv, s_ticks: int = 16) -> float:
    """A fleet of whole overlay runs: per lane and launch of ``s_ticks``
    ticks, :func:`k5_work` of the merges the lane received (``recv``
    [lanes, T], the lanes' per-tick metric), one re-slot a launch whose
    last tick ends an epoch."""
    n, k = conf["max_nnb"], overlay_dims(conf)
    recv = np.asarray(recv, np.int64)
    total = recv.shape[1]
    ms = 0.0
    for lane in recv:
        for t0 in range(0, total, s_ticks):
            s = min(s_ticks, total - t0)
            reslots = sum(1 for t in range(t0, t0 + s) if (t + 1) % 16 == 0)
            ms += bound(*k5_work(n, k, int(lane[t0:t0 + s].sum()), s,
                                 reslots))[0]
    return ms / 1e3

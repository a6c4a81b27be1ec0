"""Failure detection as a vectorized staleness mask.

Counterpart of ``gossip_protocol_tpu/ops/detect.py``: every entry whose
timestamp is ``TREMOVE`` or more ticks old is removed and logged
(``nodeLoopOps``, MP1Node.cpp:339-348).  The CUDA epilogue
(csrc/dense_tick.cu) applies the same rule per cell.
"""

from __future__ import annotations


def staleness_mask(ops_mask, known, ts, now: int, t_remove: int):
    """bool[N, N]: entries to remove this tick (``now - ts >= t_remove``
    for rows running their periodic ops)."""
    return ops_mask[:, None] & known & (now - ts >= t_remove)

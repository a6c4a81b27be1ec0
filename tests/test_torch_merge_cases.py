"""Merge inputs shared by tests/test_torch_merge.py (CPU, against the JAX
package) and tests/test_torch_cuda.py (the card, against the plain
versions).  No tests here; no JAX import, so the card's run can use it.

Each case is numpy ``(gossip bool[S, R], proc bool[R], known bool[S, J],
hb i32[S, J], ts i32[S, J])`` at clock ``NOW`` with ``T_REMOVE`` = 20.
The adversarial ones stress the level descent: no delivery at all, one
sender, every value of a column distinct, fresh timestamps over all 20
values the TREMOVE window allows, columns with no fresh entry, and a
contiguous block of dead senders and idle receivers (the live-word skip).
A float case is uniform random deliveries with that density.

The ladder cases hold each column to a few values near the top, as a
gossip state does, so the witness ladder's two rungs suffice: ``ladder``
alone, ``top_ties`` (a column's top value held by one sender in three,
its second by the rest), ``ladder_dead_cols`` (columns no sender knows),
``mixed_fallback`` (one column in 37 with every value distinct, so only
the tiles over those columns fall back past the ladder) and ``spread``
(a column's values drawn from 200 below its top, so most tiles fall back
a few levels deep).
"""

import numpy as np

NOW = 300
T_REMOVE = 20
CASES = ("empty", "single_sender", "distinct", "fresh_spread",
         "no_fresh_cols", "sparse_senders")
LADDER_CASES = ("ladder", "top_ties", "ladder_dead_cols", "mixed_fallback",
                "spread")


def merge_case(case, n: int, seed: int):
    rng = np.random.default_rng(seed)
    p = case if isinstance(case, float) else 0.6
    gossip = rng.random((n, n)) < p
    proc = np.ones(n, bool) if isinstance(case, float) \
        else rng.random(n) < 0.9
    known = rng.random((n, n)) < 0.7
    hb = rng.integers(0, 400, (n, n), dtype=np.int32)
    # spans both sides of the freshness gate now - ts < t_remove
    ts = rng.integers(NOW - 2 * T_REMOVE, NOW + 1, (n, n), dtype=np.int32)
    if case == "empty":
        gossip[:] = False
    elif case == "single_sender":
        gossip[:] = False
        gossip[rng.integers(n)] = rng.random(n) < 0.8
    elif case == "distinct":
        known[:] = True
        hb = np.argsort(rng.random((n, n)), axis=0).astype(np.int32) * 3 + 1
        ts[:] = NOW
    elif case == "fresh_spread":
        known[:] = True
        ts = NOW - rng.integers(0, T_REMOVE, (n, n), dtype=np.int32)
    elif case == "no_fresh_cols":
        ts[:, rng.random(n) < 0.5] = NOW - 3 * T_REMOVE
    elif case == "sparse_senders":
        gossip[n // 3: 2 * n // 3] = False
        proc[n // 2:] = False
    elif case in LADDER_CASES:
        # a column's values: its top, one below it, and (stale) far below
        top = rng.integers(100, 400, n, dtype=np.int32)
        gap = rng.random((n, n))
        hb = np.where(gap < 0.05, top, np.where(gap < 0.9, top - 1,
                                                top - 30)).astype(np.int32)
        ts = np.where(gap < 0.9, NOW - 1, NOW - 2 * T_REMOVE).astype(np.int32)
        if case == "top_ties":
            hb = np.where(gap < 0.33, top, top - 2).astype(np.int32)
        elif case == "spread":
            hb = top - rng.integers(0, 200, (n, n), dtype=np.int32)
            ts = NOW - rng.integers(0, 200, (n, n), dtype=np.int32) // 10
        elif case == "ladder_dead_cols":
            known[:, rng.random(n) < 0.2] = False
        elif case == "mixed_fallback":
            cols = np.arange(n) % 37 == 5
            hb[:, cols] = (np.argsort(rng.random((n, n)), axis=0)[:, cols]
                           * 3 + 1).astype(np.int32)
            ts[:, cols] = NOW
    elif not isinstance(case, float):
        raise ValueError(case)
    return gossip, proc, known, hb, ts

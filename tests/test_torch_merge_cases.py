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
"""

import numpy as np

NOW = 300
T_REMOVE = 20
CASES = ("empty", "single_sender", "distinct", "fresh_spread",
         "no_fresh_cols", "sparse_senders")


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
    elif not isinstance(case, float):
        raise ValueError(case)
    return gossip, proc, known, hb, ts

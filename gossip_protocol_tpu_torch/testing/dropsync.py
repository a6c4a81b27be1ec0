"""Shared drop-decision precomputation for differential tests (port of
``gossip_protocol_tpu/testing/dropsync.py``).

Replays the tick's exact draw (ops/drop.py: one per-tick ``fold_in``
and one (N+2, N) uniform draw covering the gossip rows, JOINREQ and
JOINREP in that order) through ``utils/threefry.py``, the bit-exact
plain form of ``jax.random``'s threefry stream, so the scalar oracle
consumes the very decisions the simulation draws on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INTRODUCER, SimConfig
from ..state import Schedule
from ..utils.threefry import fold_in, prng_key, uniform


def make_drop_masks(cfg: SimConfig, sched: Schedule):
    """Returns (gossip_drop[T,N,N], joinreq_drop[T,N], joinrep_drop[T,N])
    boolean numpy arrays: True = that send would be dropped.

    Covers the adversarial worlds that ride the drop plane (worlds.py)
    as the tick applies them: the asym world swaps the uniform threshold
    for the per-link matrix inside the same windowed draw, and the
    partition world ORs its deterministic cross-group mask in outside
    the window.  ``sched`` may hold numpy columns
    (``make_schedule_host``) or tensors (``make_schedule``)."""
    n, t_total = cfg.n, cfg.total_ticks
    base = prng_key(cfg.seed)
    active = np.asarray(sched.drop_active)

    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    lp = host(sched.link_prob)
    if lp.size:
        # the tick's threshold rows: gossip links, then JOINREQ i ->
        # introducer, then JOINREP introducer -> j
        thr = torch.from_numpy(np.concatenate(
            [lp, lp[:, INTRODUCER][None, :], lp[INTRODUCER][None, :]], 0))
    else:
        thr = float(np.float32(sched.drop_prob))

    g = np.zeros((t_total, n, n), bool)
    q = np.zeros((t_total, n), bool)
    r = np.zeros((t_total, n), bool)
    for t in range(t_total):
        if not active[t]:
            continue
        drop = (uniform(fold_in(base, t), (n + 2, n), "cpu") < thr).numpy()
        g[t], q[t], r[t] = drop[:n], drop[n], drop[n + 1]
    if bool(sched.part_on):
        grp = host(sched.part_group)
        cross = grp[:, None] != grp[None, :]
        po, pc = int(sched.part_open), int(sched.part_close)
        for t in range(t_total):
            if po < t <= pc:
                g[t] |= cross
                q[t] |= cross[:, INTRODUCER]
                r[t] |= cross[INTRODUCER]
    return g, q, r

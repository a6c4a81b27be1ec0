"""Message-loss injection (counterpart of ``gossip_protocol_tpu/ops/drop.py``).

Replaces ``EmulNet::ENsend``'s drop check (EmulNet.cpp:90-94).  One
(N+2, N) uniform draw covers every send class of a tick — gossip rows
(sender-major), the JOINREQ vector, the JOINREP vector — keyed by
``fold_in(rng, t)``.  The draw is the JAX package's threefry stream bit
for bit (utils/threefry.py), so both packages drop the same messages
from the same seed.  Outside the drop window no draw is made, as the
JAX ``lax.cond`` skips it.

:func:`drop_masks` draws S consecutive ticks at once: on a CUDA device
one launch of the ``drop_masks`` kernel (csrc/drop.cu), on the CPU
:func:`drop_masks_plain`, the torch threefry route.  The JAX package
computes this draw in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.threefry import fold_in, uniform

#: ticks one ``drop_masks`` launch draws at most (a bit each of its
#: window mask, csrc/drop.cu MAX_TICKS)
DROP_MAX_TICKS = 32


def drop_masks_plain(rng, t0: int, active, prob, n: int,
                     n_active: int | None = None, device="cpu"):
    """Plain PyTorch version of :func:`drop_masks`: one
    ``utils/threefry.py`` draw per tick whose window is open."""
    na = n if n_active is None else n_active
    s_ticks = len(active)
    g = torch.zeros((s_ticks, n, n), dtype=torch.bool, device=device)
    q = torch.zeros((s_ticks, n), dtype=torch.bool, device=device)
    p = torch.zeros((s_ticks, n), dtype=torch.bool, device=device)
    thr = float(np.float32(prob))
    for s, on in enumerate(active):
        if on:
            d = uniform(fold_in(rng, t0 + s), (na + 2, na), device) < thr
            g[s, :na, :na] = d[:na]
            q[s, :na] = d[na]
            p[s, :na] = d[na + 1]
    return g, q, p


def drop_masks(rng, t0: int, active, prob, n: int,
               n_active: int | None = None, device="cpu"):
    """The drop decisions of ticks ``t0 .. t0 + S - 1``: gossip
    bool[S, N, N] (sender-major), JOINREQ / JOINREP bool[S, N].

    ``rng`` is the run's uint32[2] key, ``active`` S host bools (is the
    drop window open for that tick's sends), ``prob`` the float32
    MSG_DROP_PROB.  ``n_active`` (default N) is the draw's width: the
    ``n_active x n_active`` lattice and the first ``n_active`` entries
    of the two vectors are drawn, the rest is zero.  On a CPU device
    :func:`drop_masks_plain`; on a CUDA device one kernel launch (or an
    exception).
    """
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    dev = torch.device(device)
    if dev.type == "cpu":
        return drop_masks_plain(rng, t0, active, prob, n, na, dev)
    from .cuda._build import check, library, stream_ptr
    s_ticks = len(active)
    if not 1 <= s_ticks <= DROP_MAX_TICKS:
        raise ValueError(f"drop_masks: {s_ticks} ticks, expected 1 to "
                         f"{DROP_MAX_TICKS}")
    bits = sum(1 << s for s, on in enumerate(active) if on)
    k0, k1 = (int(k) for k in np.asarray(rng, np.uint32))
    g = torch.empty((s_ticks, n, n), dtype=torch.bool, device=dev)
    q = torch.empty((s_ticks, n), dtype=torch.bool, device=dev)
    p = torch.empty((s_ticks, n), dtype=torch.bool, device=dev)
    code = library("drop.cu").gp_drop_masks(
        g.data_ptr(), q.data_ptr(), p.data_ptr(), k0, k1, int(t0), bits,
        float(np.float32(prob)), n, na, s_ticks, stream_ptr(dev))
    drop_masks.launches += 1
    check(code, "drop_masks")
    return g, q, p


drop_masks.launches = 0


def tick_drop_masks(rng, t: int, n: int, active: bool, prob, device,
                    link_prob=None, n_active: int | None = None):
    """Per-tick drop decisions ``(gossip bool[N, N], joinreq bool[N],
    joinrep bool[N])`` for tick ``t``: :func:`drop_masks` of one tick.

    ``active`` is whether the drop window is open for this tick's sends
    (host bool), ``n_active`` the draw's width as in :func:`drop_masks`.
    ``link_prob`` (the asymmetric-drop world) is not ported and raises.
    """
    if link_prob is not None:
        raise NotImplementedError(
            "per-link drop probabilities (asym_drop world) are not yet "
            "ported to gossip_protocol_tpu_torch")
    g, q, p = drop_masks(rng, t, (active,), prob, n, n_active, device)
    return g[0], q[0], p[0]

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

Two adversarial worlds (worlds.py) ride the same draw, at full width
only: the asym world's per-link thresholds replace the uniform
probability (``link_prob``, JAX ``ops/drop.py:49-57``), and the
partition world ORs its cross-group mask into every class while the
partition is open, a deterministic gate outside the drop window (JAX
``core/tick.py:238-250``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INTRODUCER
from ..utils.threefry import fold_in, uniform

#: ticks one ``drop_masks`` launch draws at most (a bit each of its
#: window mask, csrc/drop.cu MAX_TICKS)
DROP_MAX_TICKS = 32


def _cross_masks(group, device):
    """The partition's cross-group masks: gossip bool[N, N] (sender,
    receiver) and the join rows' bool[N] (``group[c] != group[INTRODUCER]``)."""
    grp = torch.as_tensor(np.asarray(group) if not torch.is_tensor(group)
                          else group, device=device)
    cross = grp[:, None] != grp[None, :]
    return cross, cross[:, INTRODUCER]


def drop_masks_plain(rng, t0: int, active, prob, n: int,
                     n_active: int | None = None, device="cpu",
                     link_prob=None, group=None, part_active=None):
    """Plain PyTorch version of :func:`drop_masks`: one
    ``utils/threefry.py`` draw per tick whose window is open, compared
    against ``prob`` or the per-link thresholds, then the partition's
    cross-group OR on the ticks where it is open."""
    na = n if n_active is None else n_active
    s_ticks = len(active)
    g = torch.zeros((s_ticks, n, n), dtype=torch.bool, device=device)
    q = torch.zeros((s_ticks, n), dtype=torch.bool, device=device)
    p = torch.zeros((s_ticks, n), dtype=torch.bool, device=device)
    if link_prob is None:
        thr = float(np.float32(prob))
    else:
        lp = torch.as_tensor(np.asarray(link_prob, np.float32)
                             if not torch.is_tensor(link_prob)
                             else link_prob, device=device)
        thr = torch.cat([lp, lp[:, INTRODUCER][None, :],
                         lp[INTRODUCER][None, :]], 0)
    for s, on in enumerate(active):
        if on:
            d = uniform(fold_in(rng, t0 + s), (na + 2, na), device) < thr
            g[s, :na, :na] = d[:na]
            q[s, :na] = d[na]
            p[s, :na] = d[na + 1]
    if group is not None:
        cross, cross_intro = _cross_masks(group, device)
        for s, pa in enumerate(part_active):
            if pa:
                g[s] |= cross
                q[s] |= cross_intro
                p[s] |= cross_intro
    return g, q, p


def drop_masks(rng, t0: int, active, prob, n: int,
               n_active: int | None = None, device="cpu", link_prob=None,
               group=None, part_active=None):
    """The drop decisions of ticks ``t0 .. t0 + S - 1``: gossip
    bool[S, N, N] (sender-major), JOINREQ / JOINREP bool[S, N].

    ``rng`` is the run's uint32[2] key, ``active`` S host bools (is the
    drop window open for that tick's sends), ``prob`` the float32
    MSG_DROP_PROB.  ``n_active`` (default N) is the draw's width: the
    ``n_active x n_active`` lattice and the first ``n_active`` entries
    of the two vectors are drawn, the rest is zero.  The worlds' inputs
    (full width only): ``link_prob`` f32[N, N] sender-major per-link
    probabilities replacing ``prob``; ``group`` i32[N] partition groups
    with ``part_active`` S host bools (is the partition open for that
    tick's sends).  On a CPU device :func:`drop_masks_plain`; on a CUDA
    device one kernel launch (or an exception).
    """
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    if (link_prob is not None or group is not None) and na != n:
        raise ValueError("per-link thresholds and partition groups run at "
                         f"full width only (n_active={na} < N={n})")
    if group is not None and len(part_active) != len(active):
        raise ValueError("part_active needs one flag a tick")
    dev = torch.device(device)
    if dev.type == "cpu":
        return drop_masks_plain(rng, t0, active, prob, n, na, dev,
                                link_prob, group, part_active)
    from .cuda._build import check, check_args, library, ptr, stream_ptr
    s_ticks = len(active)
    if not 1 <= s_ticks <= DROP_MAX_TICKS:
        raise ValueError(f"drop_masks: {s_ticks} ticks, expected 1 to "
                         f"{DROP_MAX_TICKS}")
    specs = []
    if link_prob is not None:
        specs.append((link_prob, torch.float32, (n, n)))
    if group is not None:
        specs.append((group, torch.int32, (n,)))
    if specs:
        check_args("drop_masks", *specs)
    bits = sum(1 << s for s, on in enumerate(active) if on)
    pbits = 0 if group is None else \
        sum(1 << s for s, pa in enumerate(part_active) if pa)
    k0, k1 = (int(k) for k in np.asarray(rng, np.uint32))
    g = torch.empty((s_ticks, n, n), dtype=torch.bool, device=dev)
    q = torch.empty((s_ticks, n), dtype=torch.bool, device=dev)
    p = torch.empty((s_ticks, n), dtype=torch.bool, device=dev)
    code = library("drop.cu").gp_drop_masks(
        g.data_ptr(), q.data_ptr(), p.data_ptr(), ptr(link_prob), ptr(group),
        k0, k1, int(t0), bits, pbits, float(np.float32(prob)), n, na,
        s_ticks, stream_ptr(dev))
    drop_masks.launches += 1
    check(code, "drop_masks")
    return g, q, p


drop_masks.launches = 0


def tick_drop_masks(rng, t: int, n: int, active: bool, prob, device,
                    link_prob=None, n_active: int | None = None,
                    group=None, part_active: bool = False):
    """Per-tick drop decisions ``(gossip bool[N, N], joinreq bool[N],
    joinrep bool[N])`` for tick ``t``: :func:`drop_masks` of one tick.

    ``active`` is whether the drop window is open for this tick's sends
    (host bool), ``n_active`` the draw's width, and ``link_prob``,
    ``group`` and ``part_active`` the worlds' inputs, as in
    :func:`drop_masks`.
    """
    g, q, p = drop_masks(rng, t, (active,), prob, n, n_active, device,
                         link_prob, group,
                         None if group is None else (part_active,))
    return g[0], q[0], p[0]

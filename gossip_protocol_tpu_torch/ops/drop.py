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

Two adversarial worlds (worlds.py) ride the same draw, at any draw
width: the asym world's per-link thresholds replace the uniform
probability (``link_prob``, JAX ``ops/drop.py:49-57``), read at the
``n_active x n_active`` corner as the JAX tick's ``link_prob[:na, :na]``
(``core/tick.py:219-221``), and the partition world ORs its cross-group
mask into every class over the whole N x N while the partition is open,
a deterministic gate outside the drop window (JAX
``core/tick.py:238-247``).  A canonical bucket (service/canonical.py)
draws its lanes at their real width inside the padded rung this way.

Each wrapper counts its calls (``calls``, on any device, at entry) apart
from its kernel launches (``launches``, on a card only): one call a
fleet tick for all lanes, one a K2 stack (analysis/runtime.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import INTRODUCER
from ..utils.threefry import fold_in, uniform
from .cuda._build import count_launch

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
        lp = lp[:na, :na]
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
    of the two vectors are drawn, the rest is zero.  The worlds' inputs:
    ``link_prob`` f32[N, N] sender-major per-link probabilities replacing
    ``prob``, read at the ``n_active`` corner; ``group`` i32[N] partition
    groups with ``part_active`` S host bools (is the partition open for
    that tick's sends), gating all N peers.  On a CPU device :func:`drop_masks_plain`; on a CUDA
    device one kernel launch (or an exception).
    """
    count_launch(drop_masks, "calls")
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
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
    count_launch(drop_masks)
    check(code, "drop_masks")
    return g, q, p


drop_masks.launches = 0
drop_masks.calls = 0


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


class LaneDrop:
    """A fleet's drop plan, one row a lane: the run keys, probabilities
    and per-tick drop / partition windows that ``drop_masks_lanes``
    reads.  The JAX fleet splits these into a shared (unbatched) and a
    per-lane (vmapped) schedule (``core/fleet.py`` ``_shared_drop``);
    here the split is data: ``active`` / ``part`` hold one row when
    every lane shares the plan, else one row a lane.  The host arrays
    serve the plain version; on a card the tables go to the device once,
    through pinned memory without a sync (:meth:`device_tables`)."""

    def __init__(self, keys, prob, active, part=None):
        self.keys = np.ascontiguousarray(keys, np.uint32).reshape(-1, 2)
        self.prob = np.ascontiguousarray(prob, np.float32).reshape(-1)
        self.active = np.ascontiguousarray(active, bool)
        self.part = None if part is None else np.ascontiguousarray(part, bool)
        b = self.keys.shape[0]
        if self.prob.shape != (b,):
            raise ValueError(f"{b} keys but {self.prob.shape[0]} "
                             "probabilities")
        for name, tab in (("active", self.active), ("part", self.part)):
            if tab is not None and (tab.ndim != 2
                                    or tab.shape[0] not in (1, b)):
                raise ValueError(f"{name} has shape {tab.shape}: one row, "
                                 f"or one a lane of {b}")
        self._dev = {}

    @property
    def batch(self) -> int:
        return self.keys.shape[0]

    def rows(self, lo: int, hi: int) -> "LaneDrop":
        """The plan of lanes ``[lo, hi)`` (a shared row stays shared): a
        lane shard's share of a fleet on a mesh (parallel/fleet_mesh.py)."""
        def pick(tab):
            return None if tab is None else (tab if tab.shape[0] == 1
                                             else tab[lo:hi])
        return LaneDrop(self.keys[lo:hi], self.prob[lo:hi],
                        pick(self.active), pick(self.part))

    def lane(self, tab, b: int, t: int) -> bool:
        """Lane ``b``'s flag at tick ``t`` (a tick past the table reads
        its last column, as ``Schedule.drop_on``)."""
        row = tab[b if tab.shape[0] > 1 else 0]
        return bool(row[min(t, len(row) - 1)])

    def device_tables(self, device):
        """``(keys u32 as i32[B, 2], prob f32[B], active u8, part u8 or
        None)`` on ``device``, uploaded once."""
        key = str(device)
        if key not in self._dev:
            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)) \
                    .pin_memory().to(device, non_blocking=True)
            self._dev[key] = (
                up(self.keys.view(np.int32)), up(self.prob),
                up(self.active.astype(np.uint8)),
                None if self.part is None else up(self.part.astype(np.uint8)))
        return self._dev[key]


def drop_masks_lanes_plain(plan: LaneDrop, t: int, n: int,
                           n_active: int | None = None, device="cpu",
                           link_prob=None, group=None):
    """Plain version of :func:`drop_masks_lanes`: :func:`drop_masks_plain`
    of one tick a lane, each with that lane's key, probability, window,
    thresholds and groups, stacked."""
    outs = []
    for b in range(plan.batch):
        part = None if group is None else (plan.lane(plan.part, b, t),)
        outs.append(drop_masks_plain(
            plan.keys[b], t, (plan.lane(plan.active, b, t),), plan.prob[b],
            n, n_active, device, None if link_prob is None else link_prob[b],
            None if group is None else group[b], part))
    return tuple(torch.cat(col) for col in zip(*outs))


def drop_masks_lanes(plan: LaneDrop, t: int, n: int,
                     n_active: int | None = None, device="cpu",
                     link_prob=None, group=None):
    """The drop decisions of tick ``t`` for every lane of a fleet:
    gossip bool[B, N, N] (sender-major), JOINREQ / JOINREP bool[B, N].

    Lane ``b`` draws ``fold_in(keys[b], t)`` where its drop window is
    open, against ``prob[b]`` or its per-link thresholds ``link_prob[b]``
    (f32[B, N, N], read at the ``n_active`` corner), and ORs in its
    partition (``group`` i32[B, N], all N peers) where its partition is
    open, exactly as its solo run's :func:`tick_drop_masks` at ``t``;
    ``n_active`` embeds every lane's draw.  On a CPU device :func:`drop_masks_lanes_plain`; on a CUDA
    device one kernel launch for the whole fleet (or an exception).
    """
    count_launch(drop_masks_lanes, "calls")
    na = n if n_active is None else n_active
    if not 0 < na <= n:
        raise ValueError(f"n_active={na} outside (0, {n}]")
    if group is not None and plan.part is None:
        raise ValueError("partition groups need the plan's part windows")
    dev = torch.device(device)
    if dev.type == "cpu":
        return drop_masks_lanes_plain(plan, t, n, na, dev, link_prob, group)
    from .cuda._build import check, check_args, library, ptr, stream_ptr
    b = plan.batch
    specs = []
    if link_prob is not None:
        specs.append((link_prob, torch.float32, (b, n, n)))
    if group is not None:
        specs.append((group, torch.int32, (b, n)))
    if specs:
        check_args("drop_masks_lanes", *specs)
    keys, prob, active, part = plan.device_tables(dev)
    t_len = plan.active.shape[1]
    stride = t_len if plan.active.shape[0] > 1 else 0
    if part is not None and plan.part.shape != plan.active.shape:
        raise ValueError("the part and active windows must share a layout")
    g = torch.empty((b, n, n), dtype=torch.bool, device=dev)
    q = torch.empty((b, n), dtype=torch.bool, device=dev)
    p = torch.empty((b, n), dtype=torch.bool, device=dev)
    code = library("drop.cu").gp_drop_masks_lanes(
        g.data_ptr(), q.data_ptr(), p.data_ptr(), ptr(link_prob), ptr(group),
        keys.data_ptr(), prob.data_ptr(), active.data_ptr(),
        None if part is None or group is None else part.data_ptr(), int(t),
        min(int(t), t_len - 1), stride, n, na, b, stream_ptr(dev))
    count_launch(drop_masks_lanes)
    check(code, "drop_masks_lanes")
    return g, q, p


drop_masks_lanes.launches = 0
drop_masks_lanes.calls = 0

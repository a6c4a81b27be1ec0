"""Plain PyTorch reference of the dense full-view MP1 model in bench mode
(whole run, counters only), written from the protocol's rules, one lane
at a time.

Per tick ``t`` (MP1Node.cpp:219-362, Application.cpp:121-163, the port's
vectorised tick semantics): the JOINREQ / JOINREP traffic, group
membership and own heartbeats; the gossip merge (for every receiver and
column the largest ``hb + 1`` a delivering sender holds, the largest
fresh one, and its ``ts + 1``); merge into existing entries, piggyback
adds, the direct sender's credit, the join cells, TREMOVE removal, and
the next tick's sends under the drop draw, each sender's full list to
every member it knows.

What a bench run's semantics also fix, and the reference follows:

* only peers that start within the run ever act, so the run lives on
  the leading ``A x A`` corner (``A``: the first index whose start tick
  is past the run, padded to a multiple of 128), every row and column
  beyond stays zero;
* the drop draw of tick ``t`` is threefry ``uniform(fold_in(key, t),
  (A + 2, A))``: gossip rows (sender-major), then the JOINREQ and the
  JOINREP vector, at the corner's width.

The merge is exact and cheap: per column the levels below the column's
largest value are tested as 0/1 products ``deliver @ [v == level]`` on
the matrix units (products of 0 and 1 with a positive sum are positive
in any precision), lowest offset first, until every cell that has a
contributor is resolved.  ``control="bf16"`` rounds the merged payloads
through bfloat16 first: the exactness the configuration guarantees,
broken the way a lower-precision merge would break it.
"""

from __future__ import annotations

import torch

from .prims import NEVER, fold_in, seed_key, uniform, victim_draw

INTRODUCER = 0
#: levels tested per product (columns stacked side by side)
LEVEL_CHUNK = 8


def start_tick(cfg: dict, i: int) -> int:
    return int(cfg["step_rate"] * i)


def active_width(cfg: dict) -> int:
    """The corner a bench run acts on (see the module docstring)."""
    n, total = cfg["max_nnb"], cfg["total_ticks"]
    if cfg["step_rate"] < 0 or start_tick(cfg, n - 1) < total:
        return n
    if cfg.get("rejoin_after") is not None \
            and cfg["fail_tick"] + cfg["rejoin_after"] < total:
        return n
    lo = next(i for i in range(n) if start_tick(cfg, i) >= total)
    return min(n, -(-lo // 128) * 128)


def _check(cfg: dict) -> None:
    plain = dict(partition_groups=0, asym_drop=False, wave_size=0,
                 zombie=False, flap_rate=0.0, byz_rate=0.0,
                 link_latency=0, rejoin_after=None, model="full_view")
    bad = {k: cfg.get(k, v) for k, v in plain.items()
           if cfg.get(k, v) != v}
    if bad:
        raise ValueError(f"the dense reference runs the course worlds only, "
                         f"not {bad}")


def schedule(cfg: dict, seed: int, a: int, device):
    """Start and fail ticks of the corner's peers."""
    n = cfg["max_nnb"]
    start = torch.tensor([start_tick(cfg, i) for i in range(a)],
                         dtype=torch.int32, device=device)
    fail = torch.full((a,), NEVER, dtype=torch.int32, device=device)
    u = victim_draw(seed)
    if cfg["single_failure"]:
        lo, hi = int(u * n) % n, int(u * n) % n + 1
    else:
        lo = (int(u * n) % n) // 2
        hi = lo + n // 2
    fail[min(lo, a):min(hi, a)] = cfg["fail_tick"]
    return start, fail


def _level_max(d, v, mm):
    """max over senders s with ``d[r, s]`` of ``v[s, c]`` (0 where none),
    for ``v >= 0``: ``d`` [R, S] as 0/1 in the product type ``mm``."""
    pos = v > 0
    top = v.amax(0)                                     # [C]
    off = top[None, :] - v
    res = torch.zeros((d.shape[0], v.shape[1]), dtype=torch.int32,
                      device=v.device)
    open_ = (d @ pos.to(mm)) > 0                        # has a contributor
    if not bool(open_.any()):
        return res
    levels = torch.unique(off[pos]).tolist()
    for i in range(0, len(levels), LEVEL_CHUNK):
        chunk = levels[i:i + LEVEL_CHUNK]
        ind = torch.stack([(off == k) & pos for k in chunk], 1)  # [S, L, C]
        hit = (d @ ind.view(ind.shape[0], -1).to(mm)).view(
            d.shape[0], len(chunk), -1) > 0
        for j, k in enumerate(chunk):
            new = hit[:, j] & open_
            res = torch.where(new, top[None, :] - k, res)
            open_ &= ~new
        if not bool(open_.any()):
            break
    return res


def merge(gossip, proc, known, hb, ts, t: int, t_remove: int, mm,
          control=None):
    """The three merge maxima i32[R, C], -1 where no sender delivers:
    of ``hb + 1`` over known entries, of the fresh ones (``t - ts <
    t_remove``), and of those fresh entries' ``ts + 1``."""
    d = (gossip & proc[None, :]).t()                    # [receiver, sender]
    live = d.any(0)[:, None]
    k = known.to(torch.int32) * live
    fresh = k * (t - ts < t_remove)
    planes = (k * (hb + 1), fresh * (hb + 1), fresh * (ts + 1))
    if control == "bf16":
        planes = tuple(p.to(torch.bfloat16).to(torch.int32) for p in planes)
    dm = d.to(mm)
    return tuple(_level_max(dm, p, mm) - 1 for p in planes)


def run_lane(cfg: dict, seed: int, device, control=None) -> dict:
    """One lane's whole bench run: the final corner state and the per-peer
    sent / received counters [A, T]."""
    _check(cfg)
    dev = torch.device(device)
    mm = torch.float16 if dev.type == "cuda" else torch.float32
    a, total, t_remove = active_width(cfg), cfg["total_ticks"], cfg["t_remove"]
    start, fail = schedule(cfg, seed, a, dev)
    key = seed_key(seed)
    prob = float(torch.tensor(cfg["msg_drop_prob"], dtype=torch.float32))
    b8, i32 = torch.bool, torch.int32

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    in_group, own_hb = z(a, dtype=b8), z(a, dtype=i32)
    joinreq, joinrep = z(a, dtype=b8), z(a, dtype=b8)
    known, gossip = z(a, a, dtype=b8), z(a, a, dtype=b8)
    hb, ts = z(a, a, dtype=i32), z(a, a, dtype=i32)
    sent, recv = z(total, a, dtype=i32), z(total, a, dtype=i32)
    idx = torch.arange(a, device=dev)
    is_intro = idx == INTRODUCER
    self_mask = idx[:, None] == idx[None, :]
    row0, col0 = is_intro[:, None], is_intro[None, :]
    for t in range(total):
        if cfg["drop_msg"] and cfg["drop_open_tick"] < t \
                <= cfg["drop_close_tick"]:
            d = uniform(fold_in(key, t), a + 2, a, dev) < prob
            gdrop, qdrop, pdrop = d[:a], d[a], d[a + 1]
        else:
            gdrop, qdrop, pdrop = z(a, a, dtype=b8), z(a, dtype=b8), \
                z(a, dtype=b8)
        # per-peer decisions (no peer rejoins in these configurations)
        failed = t > fail
        proc = (t > start) & ~failed
        proc0, failed0 = proc[INTRODUCER], failed[INTRODUCER]
        jreq = joinreq & proc0
        jrep = joinrep & proc
        starting = start == t
        in_group = in_group | jrep | (starting & is_intro)
        ops = proc & in_group
        own_hb = own_hb + ops.to(i32)
        jreq_sent = starting & ~is_intro & ~qdrop
        jrep_sent = jreq & ~pdrop
        hold = ~proc & ~failed
        joinreq = jreq_sent | (joinreq & ~proc0 & ~failed0)
        joinrep = jrep_sent | (joinrep & hold)
        v_sent = jreq_sent.to(i32) + torch.where(
            is_intro, jrep_sent.sum(dtype=i32), 0)
        v_recv = jrep.to(i32) + torch.where(is_intro, jreq.sum(dtype=i32), 0)

        # the gossip merge and the cell rules
        m_all, m_fresh, t_fresh = merge(gossip, proc, known, hb, ts, t,
                                        t_remove, mm, control)
        dfull = gossip.t() & proc[:, None]
        inc = known & (m_all > hb)
        hb1 = torch.where(inc, m_all, hb)
        ts1 = torch.where(inc, t, ts)
        padd = ~known & (t_fresh >= 0) & ~self_mask
        hb1 = torch.where(padd, m_all, hb1)
        ts1 = torch.where(padd, torch.where(m_all > m_fresh, t, t_fresh), ts1)
        known_pb = known | padd
        dinc = dfull & known_pb
        hb1 = torch.where(dinc, hb1 + 1, hb1)
        ts1 = torch.where(dinc, t, ts1)
        dadd = dfull & ~known_pb & ~self_mask
        hb1 = torch.where(dadd, 1, hb1)
        ts1 = torch.where(dadd, t, ts1)
        known2 = known_pb | dadd
        q_cell = row0 & jreq[None, :] & ~known2 & ~col0
        known3 = known2 | q_cell
        hb1 = torch.where(q_cell, 1, hb1)
        ts1 = torch.where(q_cell, t, ts1)
        r_cell = col0 & jrep[:, None] & ~known3
        known4 = known3 | r_cell
        hb = torch.where(r_cell, 1, hb1).to(i32)
        ts = torch.where(r_cell, t, ts1).to(i32)
        known = known4 & ~(ops[:, None] & known4 & (t - ts >= t_remove))
        gsent = ops[:, None] & known & ~gdrop
        gossip = gsent | (gossip & hold[None, :])
        sent[t] = gsent.sum(1, dtype=i32) + v_sent
        recv[t] = dfull.sum(1, dtype=i32) + v_recv
    return dict(width=a, known=known, hb=hb, ts=ts, gossip=gossip,
                in_group=in_group, own_hb=own_hb, joinreq=joinreq,
                joinrep=joinrep, sent=sent.t(), recv=recv.t())

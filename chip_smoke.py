#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (gossip_protocol_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``gossip_protocol_tpu_torch/csrc/`` (one
nvcc per source, in parallel), holds each kernel against its plain
PyTorch version on the card, drives the port's dense and overlay main
paths at full width, checks the results, times every kernel, and prints
one line per phase:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. kernel vs plain version on the card, bit-exact, on random inputs:
   ``masked_max3`` + ``tick_epilogue`` at N in {10, 64, 1024, 2816}, dense
   and sparse (empty delivery slabs); ``dense_mega_ticks`` at N in
   {64, 512} (S=16) and N=896 (S=8); ``fused_overlay_tick`` (K3) on
   random valid states at N=64, 4096 and 65,536 (K=64, F=3) and on the
   real tick-136 state of the N=2^20 power-law run (F=8);
   ``mega_overlay_ticks`` (K4) at N=64 and 4096 (S=16, churn, drop,
   power-law degrees) and on a 12-tick remainder launch;
   ``grid_overlay_ticks`` (K5) at N=64, 4096 and 65,536 on the
   ``churn65k`` and ``powerlaw1m`` shapes: each flag combination their
   segment plans use, all-live launches at ticks 300 and 17 (off the
   slot-epoch grid), a 12-tick remainder and a B=2 fleet launch; K5's
   boot pre-pass (``grid_boot_rows``) against ``_boot_rows`` on the real
   ticks 16 and 20 of the power-law shape at N=64, 4096, 65,536 and
   2^20 and on a B=2 churn fleet (seeds 0 and 1) at N=4096; the dense
   drop draw (``drop_masks``) at N in {10, 64, 896, 2816} and S in
   {1, 8, 16}, the window closed at every fourth tick of a launch, at
   full width and embedded at 3/4 of it;
3. the graded path: the three N=10 testcases on ``cuda``, each timed,
   must grade 90;
4. card vs CPU: N=64 multifailure and N=64 drop, 700 ticks — the
   ``dbg.log`` and ``msgcount.log`` bytes of a ``cuda`` run must equal
   those of the port's own ``cpu`` run; overlay N=64 churn (200 ticks)
   and N=128 drop (120 ticks) through ``OverlaySimulation``: final state
   and every metric equal on ``cuda`` and ``cpu``;
5. full-width runs with closed-form oracles: N=512 multifailure trace
   (K2), N=1024 multifailure 10% drop trace (K1 at full width), and
   bench N=4096 10% drop at 700 ticks (corner 2816, K1) and 200 ticks
   (corner 896, K2), with node-ticks/s and, from one more profiled run,
   the 200-tick corner's device idle share; then BASELINE's overlay
   configs
   (5e) — N=4096 10% drop, 608 ticks (K4, 38 launches), N=65,536 20%
   churn, 608 ticks (K5, 38 launches) and N=2^20 power-law single
   failure, 272 ticks (K5, F=8, 17 launches; no K3 launch on either) —
   each validated as bench.py validates it (all in the group, no victim
   slot or entry left, every member uncovered at the end covered again
   within SLOT_EPOCH + 1 ticks), with node-ticks/s (and the N=4096 run's
   idle share from one more profiled run); and the overlay
   cross-paths (5f): the per-tick K3 route of each of the three runs
   equals it through K4 or K5, the first 48 ticks of the N=65,536 run
   through K3 equal the plain per-tick path, and a B=4 K5 fleet of the
   N=65,536 run (seeds 0-3, 64 ticks) equals its lanes' solo K5 runs;
6. each kernel held against its plain version and timed on the input
   of a launch the main path makes (the run stopped one launch early:
   tick 699 of the 700-tick corner (N=2816), of the N=1024 trace and of
   the N=10 multifailure testcase for K1, the last full K2 launch of
   the 200-tick corner and of the N=512 trace, tick 607 of the N=65,536
   churn run and of the N=4096 drop run for K3, the launch at tick 592
   of the N=4096 drop run for K4, the last full launches of the N=65,536
   churn run (tick 592) and
   of the N=2^20 power-law run (tick 256) for K5, with the boot block
   built on the card as the route does; K3 also at tick 136 of the N=2^20
   run, the width of its per-tick cross-check there; the boot pre-pass
   at tick 16 of both K5 runs; the drop draw as the dense routes call it,
   at ticks 300 (window open) and 699 (closed) of the 700-tick corner
   (N=2816, S=1) and for the last K2 launch of the 200-tick corner (N=896,
   S=8)), then a ``kernels``
   JSON line: per kernel its launches on the main path (phases 3-5,
   counters zeroed before each path and read after it, bench warm-ups
   and kernel-vs-plain comparisons not counted), its time, its plain
   version's time, and the least time the card could take (bytes over
   3.35 TB/s or int32 operations over the card's int32 rate, whichever
   is larger; for ``masked_max3``, whose descent runs on the int8
   tensor cores, the bytes the function needs or the descent's s8
   products at the tensor-core rate, the larger; K5 also carries the
   bytes its data needs, the partner rows it merges included).  K5 is
   also timed, in turns with itself, built without its partner loads and
   with its loads alone (``csrc/overlay_tick.cu K5_VARIANT``, built in
   phase 1).  Before the kernels line, each
   ``masked_max3`` input is described: its deliveries, the distinct
   levels and tile products of each plane, the share of cells the
   pre-resolve closes, the share of empty delivery slabs the earlier
   int32 product-max design (32 senders x 64 receivers a slab) skipped,
   and both bounds.

``--dense-only TREE`` runs, after the first phase, only the dense path
of the package in the checkout at ``TREE``: the dense kernels of phase
6, then phases 3 and 5a-c; ``--overlay-only TREE`` only the overlay
path: phase 6's overlay kernels, then 5e's three runs.
``--turns OTHER_CHECKOUT`` runs one of them (``--turns-path dense``,
the default, or ``overlay``) for another checkout and for this one in
turns (other, this, this, other, twice), each run a process of its own,
and prints every wall and kernel time of the eight runs.

``--profile`` also fails if a dense ``cuda`` run issued any of the
threefry draw's torch operators (the draw is the ``drop_masks`` kernel).

Any failure raises and exits non-zero; no phase catches and continues.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM int32 outside the tensor cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost clock (Hopper white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_TC_OPS_PER_S = 1979e12
# H100 SXM on-chip storage: the 50 MB L2 and 132 SMs' 227 KB of shared
# memory a block can use
ON_CHIP_BYTES = 50e6 + 132 * 232448
REPO = os.path.dirname(os.path.abspath(__file__))


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- inputs

def k1_inputs(n: int, seed: int, device, sparse: bool = False):
    """Random valid inputs of one per-tick step (numpy seed).  With
    ``sparse`` only the first third of the senders gossip and only the
    first half of the receivers process, as early in a run, so the
    merge kernel's skip of empty delivery slabs is exercised."""
    import torch
    rng = np.random.default_rng(seed)
    t = 300
    gossip = rng.random((n, n)) < 0.6
    proc = rng.random(n) < 0.9
    if sparse:
        gossip[n // 3:] = False
        proc[n // 2:] = False

    def b(p, shape):
        return torch.from_numpy(rng.random(shape) < p).to(device)

    def i(lo, hi, shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape, dtype=np.int32)).to(device)

    return dict(gossip=torch.from_numpy(gossip).to(device),
                proc=torch.from_numpy(proc).to(device), known=b(0.7, (n, n)),
                hb=i(0, 400, (n, n)), ts=i(t - 40, t + 1, (n, n)),
                gdrop=b(0.1, (n, n)), ops=b(0.85, n), jrep=b(0.2, n),
                jreq=b(0.2, n), live_hold=b(0.1, n), t=t)


def k2_inputs(n: int, s_ticks: int, seed: int, device):
    """Random valid K2 launch inputs: a mid-run state with a join ramp,
    failures inside the launch and (for churn) rejoins inside it."""
    import torch
    rng = np.random.default_rng(seed)
    t0 = 90
    never = np.iinfo(np.int32).max
    start = (0.25 * np.arange(n)).astype(np.int32)
    fail = np.full(n, never, np.int32)
    rejoin = np.full(n, never, np.int32)
    victims = rng.random(n) < 0.2
    fail[victims] = t0 + 2
    rejoin[victims] = t0 + 5
    aux = np.stack([rng.random(n) < 0.8, rng.integers(0, 90, n),
                    rng.random(n) < 0.1, rng.random(n) < 0.1,
                    start, fail, rejoin, np.zeros(n)], 1).astype(np.int32)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(
        known=t_((rng.random((n, n)) < 0.7).astype(np.int32)),
        hb=t_(rng.integers(0, 90, (n, n), dtype=np.int32)),
        ts=t_(rng.integers(t0 - 30, t0 + 1, (n, n), dtype=np.int32)),
        gossip=t_((rng.random((n, n)) < 0.6).astype(np.int32)),
        aux=t_(aux), gdrop=t_(rng.random((s_ticks, n, n)) < 0.1),
        qdrop=t_(rng.random((s_ticks, n)) < 0.1),
        pdrop=t_(rng.random((s_ticks, n)) < 0.1), sp=t0)


def max_abs_err(a, b) -> float:
    import torch
    if a is None and b is None:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ------------------------------------------------------------ phase 2

def compare_k1(x: dict, t_remove: int, events=(True, False)) -> dict:
    """masked_max3 and tick_epilogue kernels vs their plain versions on
    the same tensors; returns the max abs error of each."""
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_plain)
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_plain)
    args = (x["gossip"], x["proc"], x["known"], x["hb"], x["ts"], x["t"])
    m_k = masked_max3(*args, t_remove=t_remove)
    m_p = masked_max3_plain(*args, t_remove=t_remove)
    err = {"masked_max3": max(max_abs_err(a, b) for a, b in zip(m_k, m_p)),
           "tick_epilogue": 0.0}
    for ev in events:
        e_args = (*m_k, x["gossip"], x["proc"], x["known"], x["hb"], x["ts"],
                  x["gdrop"], x["ops"], x["jrep"], x["jreq"], x["live_hold"],
                  x["t"])
        o_k = tick_epilogue(*e_args, t_remove=t_remove, with_events=ev)
        o_p = tick_epilogue_plain(*e_args, t_remove=t_remove, with_events=ev)
        err["tick_epilogue"] = max(
            err["tick_epilogue"],
            max(max_abs_err(a, b) for a, b in zip(o_k, o_p)))
    return err


def compare_k2(x: dict, kws) -> float:
    """dense_mega_ticks vs its plain version on the same tensors, for
    each keyword set in ``kws``; returns the max abs error."""
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import (
        dense_mega_ticks, dense_mega_ticks_plain)
    worst = 0.0
    for kw in kws:
        o_k = dense_mega_ticks(**x, **kw)
        o_p = dense_mega_ticks_plain(**x, **kw)
        worst = max(worst, max(max_abs_err(a, b) for a, b in zip(o_k, o_p)))
    return worst


# ----------------------------------------------------------- oracles

def oracle_trace(res, exact_removal: bool) -> dict:
    """Closed-form checks of a trace run of the multifailure family.

    Every live peer that entered the group (a member) knows every other
    member at the end and none of the victims; no member was ever
    removed by a live peer; every victim a member ever added is
    removed.  (Under drops a live peer whose JOINREQ or JOINREP was
    lost never enters the group: the reference sends each once.  Such a
    peer may be added from the introducer's gossip and removed again,
    so it is counted, not checked.)  With
    ``exact_removal`` (no drops), every live peer joined and each such
    removal happens exactly once, at fail + TREMOVE + 1 or, where the
    victim's largest heartbeat was still being relayed one tick after
    the failure (the merge stamps the local clock), one tick later.
    """
    from gossip_protocol_tpu_torch.state import NEVER
    cfg = res.cfg
    victims = res.fail_tick != NEVER
    live = ~victims
    fs = res.final_state
    in_group = fs.in_group.cpu().numpy()
    known = fs.known.cpu().numpy()
    members = live & in_group
    m = int(members.sum())
    sub = known[np.ix_(members, members)]
    if not (sub | np.eye(m, dtype=bool)).all():
        raise AssertionError("join incomplete among live members")
    if known[np.ix_(members, victims)].any():
        raise AssertionError("a live member still lists a victim")
    rm_any = res.removed.any(0)
    if rm_any[np.ix_(live, members)].any():
        raise AssertionError("false removal of a live member")
    had = res.added.any(0)[np.ix_(members, victims)]
    if (had & ~rm_any[np.ix_(members, victims)]).any():
        raise AssertionError("a victim was never removed")
    out = {"live_members": m, "victims": int(victims.sum()),
           "live_never_joined": int(live.sum()) - m,
           "victim_pairs_removed": int(had.sum())}
    if exact_removal:
        if m != int(live.sum()):
            raise AssertionError("a live peer never joined")
        t_rm = cfg.fail_tick + cfg.t_remove + 1
        rm_mv = res.removed[:, members][:, :, victims]
        if not (rm_mv.sum(0) == had).all():
            raise AssertionError("victim removals are not exactly once")
        if not ((rm_mv[t_rm] | rm_mv[t_rm + 1]) == had).all():
            raise AssertionError(
                f"victim removals not all at t={t_rm} or t={t_rm + 1}")
        out["removals_at"] = {t_rm: int(rm_mv[t_rm].sum()),
                              t_rm + 1: int(rm_mv[t_rm + 1].sum())}
    return out


def oracle_bench(res) -> dict:
    """Bench-mode checks: all ticks ran, counters are sane, and at the
    end no live member of the corner lists a victim that failed at
    least TREMOVE + 1 ticks before."""
    from gossip_protocol_tpu_torch.state import NEVER
    cfg = res.cfg
    fs = res.final_state
    if fs.tick != cfg.total_ticks:
        raise AssertionError("bench run did not finish")
    if (res.sent < 0).any() or (res.recv < 0).any():
        raise AssertionError("negative counters")
    victims = res.fail_tick != NEVER
    members = ~victims & fs.in_group.cpu().numpy()
    known = fs.known.cpu().numpy()
    old = victims & (res.start_tick + cfg.t_remove + 1 < cfg.total_ticks) \
        & (cfg.fail_tick + cfg.t_remove + 1 < cfg.total_ticks)
    if known[np.ix_(members, old)].any():
        raise AssertionError("a live member still lists an old victim")
    return {"live_members": int(members.sum()),
            "sent_total": int(res.sent.sum())}


# ----------------------------------------------------------- timing

def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_tc(nbytes: float, ops: float) -> tuple[float, str]:
    """As :func:`bound`, for int8 operations on the tensor cores."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT8_TC_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def corner_start(cfg, a: int, dev):
    """The width-``a`` slices of a run's tick-0 state and schedule, as
    the bench corner (or, with ``a == N``, a full-width run) starts."""
    from gossip_protocol_tpu_torch.core.dense_corner import _slice_state
    from gossip_protocol_tpu_torch.state import (init_state, make_schedule,
                                                 slice_schedule)
    return (_slice_state(init_state(cfg, dev), a),
            slice_schedule(make_schedule(cfg, dev), a))


def k1_launch_input(cfg, a: int, dev) -> dict:
    """The per-tick kernels' input at the last tick of a per-tick run of
    width ``a``: the run stopped one tick early, then that tick's drop
    masks and vector decisions, as ``make_tick`` builds them."""
    from gossip_protocol_tpu_torch.core.tick import make_tick_run
    from gossip_protocol_tpu_torch.ops.drop import tick_drop_masks
    from gossip_protocol_tpu_torch.ops.vector import vector_step
    t = cfg.total_ticks - 1
    st, sched = corner_start(cfg, a, dev)
    st, _ = make_tick_run(cfg.replace(max_nnb=a, total_ticks=t),
                          with_events=False)(st, sched)
    gdrop, qdrop, pdrop = tick_drop_masks(st.rng, t, a, sched.drop_on(t),
                                          sched.drop_prob, dev)
    churn = cfg.rejoin_after is not None
    v = vector_step(t, sched.start_tick, sched.fail_tick, sched.rejoin_tick,
                    st.in_group, st.own_hb, st.joinreq, st.joinrep, qdrop,
                    pdrop, churn=churn)
    known, hb, ts = st.known, st.hb, st.ts
    if churn:
        keep = ~v.rejoining[:, None]
        known, hb, ts = known & keep, hb * keep, ts * keep
    return dict(gossip=st.gossip, proc=v.proc, known=known, hb=hb, ts=ts,
                gdrop=gdrop.contiguous(), ops=v.ops, jrep=v.jrep, jreq=v.jreq,
                live_hold=v.hold, t=t)


def k2_launch_input(cfg, a: int, dev) -> tuple[dict, int]:
    """K2's input at the last full launch of a megakernel run of width
    ``a``: the run stopped one launch early, packed as
    ``make_dense_mega_run`` packs it, with that launch's drop stack.
    Returns the inputs and the launch's tick count S."""
    import torch

    from gossip_protocol_tpu_torch.core.dense_mega import (
        drop_stack, make_dense_mega_run, pack_aux)
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import \
        dense_mega_ticks_for
    s_ticks = dense_mega_ticks_for(a)
    t0 = (cfg.total_ticks // s_ticks - 1) * s_ticks
    st, sched = corner_start(cfg, a, dev)
    st, _ = make_dense_mega_run(cfg.replace(max_nnb=a, total_ticks=t0))(
        st, sched)
    g, q, p = drop_stack(st.rng, t0, s_ticks, a, sched, dev)
    i32 = torch.int32
    return dict(known=st.known.to(i32), hb=st.hb, ts=st.ts,
                gossip=st.gossip.to(i32), aux=pack_aux(st, sched), gdrop=g,
                qdrop=q, pdrop=p, sp=t0), s_ticks


def merge_stats(x: dict, t_remove: int) -> dict:
    """What the masked_max3 descent needs at one launch input, from its
    plain mirror (``ops/merge.py masked_max3_descent``, also held equal
    to the plain version here): the deliveries; per plane the distinct
    positive values a column holds among the senders that deliver at
    all, the products the tiles run (pre-resolve included), and the
    share of cells the pre-resolve finishes; the share of empty (so
    skipped) 32-sender x 64-receiver delivery slabs in the earlier int32
    product-max design; and two bounds.  ``bound`` is the descent's: the
    bytes the function needs (gossip and proc read, known/hb/ts only in
    the rows of senders that deliver, three i32 maxima written) over
    3.35 TB/s, or the s8 MACs of the products the tiles run (tile x live
    senders x products) at 1,979 T int8 operations/s, the larger.
    ``int32_bound`` counts the same bytes beside the product-max's
    3 D N maxima on the INT32 lanes."""
    import torch

    from gossip_protocol_tpu_torch.ops.merge import (
        TILE_COLS, TILE_ROWS, WORD, masked_max3_descent, masked_max3_plain,
        merge_payloads)
    args = (x["gossip"], x["proc"], x["known"], x["hb"], x["ts"], x["t"])
    n = x["known"].shape[0]
    (m, lv) = masked_max3_descent(*args, t_remove=t_remove)
    want = masked_max3_plain(*args, t_remove=t_remove)
    if not all(torch.equal(a, b) for a, b in zip(m, want)):
        raise AssertionError("masked_max3_descent != masked_max3_plain")
    d = x["gossip"] & x["proc"][None, :]                  # [s, r]
    sender = d.any(1)
    w = -(-n // WORD)
    dpad = torch.zeros((w * WORD, n), dtype=torch.bool, device=d.device)
    dpad[:n] = d
    out = {"n": n, "deliveries": int(d.sum()),
           "senders_delivering": int(sender.sum()),
           "receivers_reached": int(d.any(0).sum())}
    # the earlier product-max design skipped a (32-sender slab,
    # 64-receiver tile) pair with no delivery
    slabs = torch.zeros((w * WORD, -(-n // 64) * 64), dtype=torch.bool,
                        device=d.device)
    slabs[:n, :n] = d
    slab_any = slabs.view(w, WORD, -1, 64).any(3).any(1)
    out["product_max_slab_skip_share"] = 1.0 - float(slab_any.float().mean())
    # live words per row tile and the MACs a product of each tile costs
    rt = -(-n // TILE_ROWS)
    live_words = dpad.view(w, WORD, n).any(1)              # [W, r]
    k_live = torch.stack([live_words[:, i * TILE_ROWS:(i + 1) * TILE_ROWS]
                          .any(1).sum() for i in range(rt)]) * WORD
    tile_r = torch.tensor([min(TILE_ROWS, n - i * TILE_ROWS)
                           for i in range(rt)], device=d.device)
    ct = -(-n // TILE_COLS)
    tile_c = torch.tensor([min(TILE_COLS, n - j * TILE_COLS)
                           for j in range(ct)], device=d.device)
    macs = 0
    for name, v in zip("aft", merge_payloads(x["known"], x["hb"], x["ts"],
                                             x["t"], t_remove)):
        p = lv[name]
        vs = v[sender].sort(0).values
        distinct = ((vs[1:] != vs[:-1]) & (vs[1:] > 0)).sum(0) \
            + (vs[:1] > 0).sum(0) if len(vs) else torch.zeros(n)
        macs += int((p * (tile_r * k_live)[:, None] * tile_c[None, :]).sum())
        out[f"plane_{name}"] = {
            "levels_per_column_mean": float(distinct.float().mean()),
            "levels_per_column_max": int(distinct.max()),
            "products_per_tile_mean": float(p.float().mean()),
            "products_per_tile_max": int(p.max()),
            "products_total": int(p.sum()),
            "pre_resolve_fill_share": float((m["aft".index(name)] == -1)
                                            .float().mean())}
    # bytes: gossip and proc read, known/hb/ts (9 bytes a cell) of the
    # senders that deliver, the three maxima written
    nbytes = n * n * (1 + 12) + n + 9 * n * out["senders_delivering"]
    out["bytes"] = nbytes
    out["tensor_core_macs"] = macs
    out["bound"] = bound_tc(nbytes, 2 * macs)
    out["int32_bound"] = bound(nbytes, 3 * out["deliveries"] * n)
    return out


def time_k1(x: dict, t_remove: int, with_events: bool, reps: int,
            describe: bool = True) -> dict:
    """masked_max3 and tick_epilogue on one real launch input: kernel and
    plain outputs held equal, their times (ms) and the epilogue's bound;
    with ``describe`` also what the merge needs there
    (:func:`merge_stats`, which reads this tree's descent mirror) and
    its bounds."""
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_plain)
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_plain)
    err = compare_k1(x, t_remove, events=(with_events,))
    if any(v != 0 for v in err.values()):
        raise AssertionError(f"kernel != plain on the launch input: {err}")
    n = x["known"].shape[0]
    args = (x["gossip"], x["proc"], x["known"], x["hb"], x["ts"], x["t"])
    m = masked_max3(*args, t_remove=t_remove)
    e_args = (*m, x["gossip"], x["proc"], x["known"], x["hb"], x["ts"],
              x["gdrop"], x["ops"], x["jrep"], x["jreq"], x["live_hold"],
              x["t"])
    nnz = int((x["gossip"] & x["proc"][None, :]).sum())
    out = {"n": n, "tick": x["t"], "with_events": with_events,
           "deliveries": nnz, "max_abs_err": err}
    out["masked_max3"] = dict(
        ms=cuda_ms(lambda: masked_max3(*args, t_remove=t_remove), reps),
        plain_ms=cuda_ms(
            lambda: masked_max3_plain(*args, t_remove=t_remove), 2))
    if describe:
        stats = merge_stats(x, t_remove)
        out["merge_stats"] = stats
        out["masked_max3"]["bound"] = stats["bound"]
        out["masked_max3"]["bound_int32"] = stats["int32_bound"]
    # epilogue: three i32 maxima, hb/ts, known, gossip, gdrop in;
    # hb/ts, known, gossip (and with events added/removed) out; five
    # row lanes in, sent/recv out
    ep_bytes = n * n * (12 + 8 + 3 + 8 + 2 + (2 if with_events else 0)) \
        + 13 * n
    # the cell rule chain is about 40 integer operations per cell
    ep_ops = 40 * n * n
    out["tick_epilogue"] = dict(
        ms=cuda_ms(lambda: tick_epilogue(*e_args, t_remove=t_remove,
                                         with_events=with_events), reps),
        plain_ms=cuda_ms(lambda: tick_epilogue_plain(
            *e_args, t_remove=t_remove, with_events=with_events), 3),
        bound=bound(ep_bytes, ep_ops))
    return out


def time_k2(x: dict, s_ticks: int, cfg, with_events: bool,
            reps: int) -> dict:
    """dense_mega_ticks on one real launch input: kernel and plain
    outputs held equal, their times, and the bound, counting this
    launch's deliveries tick by tick (plain S=1 steps)."""
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import (
        dense_mega_ticks, dense_mega_ticks_plain)
    n = x["known"].shape[0]
    kw = dict(n=n, s_ticks=s_ticks, t_remove=cfg.t_remove,
              can_rejoin=cfg.rejoin_after is not None,
              with_events=with_events)
    err = compare_k2(x, (kw,))
    if err != 0:
        raise AssertionError(f"K2 != plain on the launch input: {err}")
    # deliveries per tick of this launch
    t0 = int(x["sp"])
    nnz = 0
    cur = dict(x)
    for s in range(s_ticks):
        t = t0 + s
        a = cur["aux"]
        proc = (t > a[:, 4]) & ~((t > a[:, 5]) & (t <= a[:, 6]))
        nnz += int(((cur["gossip"] > 0) & proc[None, :]).sum())
        o = dense_mega_ticks_plain(
            cur["known"], cur["hb"], cur["ts"], cur["gossip"], a,
            x["gdrop"][s:s + 1], x["qdrop"][s:s + 1], x["pdrop"][s:s + 1],
            t, **{**kw, "s_ticks": 1, "with_events": False})
        cur = dict(known=o[0], hb=o[1], ts=o[2], gossip=o[3], aux=o[4])
    # four i32 planes and aux in and out, the drop stack, sent/recv and
    # the int8 event planes; 3 maxima per (delivery, column) pair
    nbytes = 2 * 16 * n * n + 2 * 32 * n + s_ticks * (n * n + 2 * n) \
        + s_ticks * 8 * n + (2 * s_ticks * n * n if with_events else 0)
    ops = 3 * nnz * n
    return dict(n=n, s_ticks=s_ticks, sp=t0, with_events=with_events,
                deliveries=nnz, max_abs_err=err,
                ms=cuda_ms(lambda: dense_mega_ticks(**x, **kw), reps),
                plain_ms=cuda_ms(lambda: dense_mega_ticks_plain(**x, **kw),
                                 1, warm=0),
                bound=bound(nbytes, ops))


# ------------------------------------------------------ overlay inputs

def overlay_cfg(name: str, **over):
    """The overlay configurations the script drives: BASELINE's three
    (bench.py:319-349, 625-629, 936-937) and two small ones of the JAX
    package's tests (tests/test_overlay_mega.py:27-50)."""
    from gossip_protocol_tpu_torch.config import SimConfig
    kw = {
        "drop4096": dict(max_nnb=4096, single_failure=True, drop_msg=True,
                         msg_drop_prob=0.1, total_ticks=608, fail_tick=304,
                         step_rate=40.0 / 4096),
        "churn65k": dict(max_nnb=65536, single_failure=False,
                         total_ticks=608, churn_rate=0.2, rejoin_after=40,
                         step_rate=64.0 / 65536),
        "powerlaw1m": dict(max_nnb=1 << 20, single_failure=True,
                           total_ticks=272, fail_tick=136,
                           step_rate=40.0 / (1 << 20), topology="powerlaw"),
        "churn64": dict(max_nnb=64, single_failure=False, seed=7,
                        total_ticks=200, churn_rate=0.25, rejoin_after=30,
                        step_rate=40.0 / 64),
        "drop128": dict(max_nnb=128, single_failure=True, drop_msg=True,
                        msg_drop_prob=0.3, seed=5, total_ticks=120,
                        fail_tick=60, step_rate=0.25, drop_open_tick=10,
                        drop_close_tick=100),
    }[name]
    kw.setdefault("seed", 0)
    return SimConfig(model="overlay", **{**kw, **over})


def overlay_state(cfg, t: int, seed: int, device):
    """A random valid overlay state at tick ``t`` (numpy seed): 70% of
    the slots hold entries observed 1 to 25 ticks ago (some stale), and
    random flags."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import resolved_dims
    from gossip_protocol_tpu_torch.ops.overlay_rules import OverlayState
    rng = np.random.default_rng(seed)
    n = cfg.n
    k, f = resolved_dims(cfg)
    ids = rng.integers(0, n, (n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.3] = -1
    occ = ids >= 0
    hb = np.where(occ, rng.integers(0, 300, (n, k)), 0).astype(np.int32)
    ts = np.where(occ, rng.integers(max(t - 25, 0), max(t, 1), (n, k)),
                  0).astype(np.int32)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return OverlayState(
        tick=t, ids=t_(ids), hb=t_(hb), ts=t_(ts),
        in_group=t_(rng.random(n) < 0.9),
        own_hb=t_(rng.integers(0, 300, n).astype(np.int32)),
        send_flags=t_(rng.random((n, f)) < 0.8),
        send_hist=t_(np.zeros((n, f), np.int32)),
        joinreq=t_(rng.random(n) < 0.05), joinrep=t_(rng.random(n) < 0.05))


def k3_launch_input(cfg, state) -> dict:
    """K3's input at ``state``'s next tick, as the tick builds it (the
    tick runs with K3 replaced by a function that keeps its arguments)."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import (
        make_overlay_schedule, make_overlay_tick)
    got = {}

    def keep(idsaux, pw, intro, masks, scalars, **kw):
        got.update(args=(idsaux, pw, intro, list(masks), list(scalars)),
                   kw=kw)
        z = torch.zeros_like(pw)
        return z, z, z, torch.zeros((pw.shape[0], 6), dtype=torch.int32,
                                    device=pw.device)

    make_overlay_tick(cfg, exchange=keep)(state, make_overlay_schedule(cfg))
    return got


def compare_k3(x: dict) -> float:
    """fused_overlay_tick vs its plain version on the same input."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    o_k = fused_overlay_tick(*x["args"], **x["kw"])
    o_p = fused_overlay_tick_plain(*x["args"], **x["kw"])
    return max(max_abs_err(a, b) for a, b in zip(o_k, o_p))


def k4_launch_input(cfg, state, s_ticks: int) -> dict:
    """K4's input for ``s_ticks`` ticks from ``state``, packed as the K4
    route packs it."""
    from gossip_protocol_tpu_torch.models import overlay_mega as om
    from gossip_protocol_tpu_torch.models.overlay import make_overlay_schedule
    sched = make_overlay_schedule(cfg)
    kw = om.mega_kernel_kwargs(cfg, sched)
    return dict(
        st=om._pack_state(cfg, state, sched),
        sp=om._sp_vector(cfg, sched, state.tick, s_ticks, cfg.n,
                         kw["f_rounds"]),
        kw=dict(kw, s_ticks=s_ticks))


def compare_k4(x: dict) -> float:
    """mega_overlay_ticks vs its plain version on the same input."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import (
        mega_overlay_ticks, mega_overlay_ticks_plain)
    o_k = mega_overlay_ticks(x["st"], x["sp"], **x["kw"])
    o_p = mega_overlay_ticks_plain(x["st"], x["sp"], **x["kw"])
    return max(max_abs_err(a, b) for a, b in zip(o_k, o_p))


def grid_cfg(name: str, n: int):
    """One of BASELINE's two K5 configurations at width ``n`` with its
    phase windows kept (start ramp 64 or 40 ticks), so its plan has the
    full-size run's flag combinations."""
    full = overlay_cfg(name)
    return overlay_cfg(name, max_nnb=n, step_rate=full.step_rate * full.n / n)


def k5_launch_input(cfg, lanes, t0: int, s_ticks: int, flags) -> dict:
    """K5's input for an ``s_ticks`` launch at ``t0`` from each (state,
    schedule) lane, built as the K5 route builds it; one lane is a solo
    launch, more a fleet launch."""
    import torch

    from gossip_protocol_tpu_torch.models import overlay_grid as og
    from gossip_protocol_tpu_torch.models.overlay import resolved_dims
    planes = [og.pack_grid_plane(cfg, st) for st, _ in lanes]
    xs = [og.grid_launch_input(cfg, sc, plane, t0, s_ticks, flags.join_live)
          for plane, (_, sc) in zip(planes, lanes)]
    k, f = resolved_dims(cfg)
    kw = dict(og.grid_kernel_kwargs(cfg, k, f), s_ticks=s_ticks,
              **flags.as_kernel_kwargs())
    if len(xs) == 1:
        return dict(plane=planes[0], boot=xs[0][0], sp=xs[0][1], kw=kw)
    return dict(plane=torch.stack(planes),
                boot=torch.stack([x[0] for x in xs]),
                sp=np.stack([x[1] for x in xs]), kw=dict(kw, batch=len(xs)))


def k5_args(x: dict) -> tuple:
    """K5's positional inputs: ``(plane, sp)``, or ``(plane, boot, sp)``
    for a checkout whose K5 takes the boot block."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_overlay_ticks
    if "boot" in inspect.signature(grid_overlay_ticks).parameters:
        return x["plane"], x["boot"], x["sp"]
    return x["plane"], x["sp"]


def compare_k5(x: dict) -> tuple[float, object]:
    """grid_overlay_ticks vs its plain version on the same input; the
    max abs error and the plain version's metric rows."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (
        grid_overlay_ticks, grid_overlay_ticks_plain)
    o_k = grid_overlay_ticks(*k5_args(x), **x["kw"])
    o_p = grid_overlay_ticks_plain(*k5_args(x), **x["kw"])
    return max(max_abs_err(a, b) for a, b in zip(o_k, o_p)), o_p[1]


def k5_cases(cfg) -> list:
    """(t0, s_ticks, flags) of the K5 launches phase 2 checks: the first
    launch of each flag combination of the config's tick-0 plan, an
    all-live S=16 launch at tick 300, one off the slot-epoch grid
    (t0 = 17) and a 12-tick remainder."""
    from gossip_protocol_tpu_torch.models.segments import (ALL_LIVE,
                                                           plan_segments)
    first = {}
    for seg in plan_segments(cfg, cfg.total_ticks, 0, 16):
        first.setdefault(seg.flags, seg.start)
    return [(t0, 16, fl) for fl, t0 in first.items()] + [
        (300, 16, ALL_LIVE), (17, 16, ALL_LIVE), (170, 12, ALL_LIVE)]


def boot_input(cfg, lanes, t0: int) -> dict:
    """The boot pre-pass's input and its plain version's output at tick
    ``t0``: each (state, schedule) lane's plane and ``sp`` row, and
    ``_boot_rows`` (the plain version)."""
    import torch

    from gossip_protocol_tpu_torch.models import overlay_grid as og
    from gossip_protocol_tpu_torch.models.overlay import resolved_dims
    planes = [og.pack_grid_plane(cfg, st) for st, _ in lanes]
    xs = [og.grid_launch_input(cfg, sc, plane, t0, 16)
          for plane, (_, sc) in zip(planes, lanes)]
    kw = dict(n=cfg.n, k=resolved_dims(cfg)[0])
    if len(lanes) == 1:
        return dict(plane=planes[0], sp=xs[0][1], want=xs[0][0], kw=kw)
    return dict(plane=torch.stack(planes), sp=np.stack([x[1] for x in xs]),
                want=torch.stack([x[0] for x in xs]),
                kw=dict(kw, batch=len(lanes)))


def compare_boot(x: dict) -> tuple[float, int]:
    """K5's boot pre-pass vs ``_boot_rows`` on the same plane: the max
    abs error and the number of aggregate slots that hold a JOINREQ."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        grid_boot_rows
    return (max_abs_err(grid_boot_rows(x["plane"], x["sp"], **x["kw"]),
                        x["want"]),
            int((x["want"][..., 1, :] != 0).sum()))


def k3_ops(n: int, k: int, f: int) -> float:
    """Integer operations one K3 tick needs: about 8 per merge candidate
    and 40 per slot for extraction, detection and the subject's fail
    schedule.  Each slot takes F partner entries and the JOINREP
    broadcast entry; the F partner self-entries and the introducer's
    self-entry land in one slot of a row each; the JOINREQ aggregate
    merges into row 0 only."""
    return n * k * ((f + 1) * 8 + 40) + n * (f + 1) * 8 + 8 * k


def k3_bound(n: int, k: int, f: int, recv: int = 0) -> tuple[float, str]:
    """K3's least time: idsaux, pw and intro read once, ids/hb/ts and
    the counters written once, against :func:`k3_ops`.  The partner rows
    a row merges are rows of the same tables, so they are not counted
    again unless ``recv`` (the merges the tick received, its counters'
    first column) is given: then each adds a row of idsaux and pw, as
    K5's needed-bytes bound does."""
    nbytes = 4 * (n * (k + 2 + f) + n * k + 8 * k + 3 * n * k + 6 * n
                  + recv * (2 * k + 2 + f))
    return bound(nbytes, k3_ops(n, k, f))


def k4_bound(n: int, k: int, f: int, s_ticks: int,
             reslots: int) -> tuple[float, str]:
    """K4's least time: the plane read once and written once, the
    metric rows; per tick K3's operations plus about 30 a row for the
    decisions, send flags and joins, and at each re-slot one merge
    candidate (8 operations) per slot: subject ids are unique within a
    row, so the per-slot max is over K entries a row."""
    w = 2 * k + 16
    nbytes = 4 * (2 * n * w + s_ticks * 128 + 14 + s_ticks * f)
    ops = s_ticks * (k3_ops(n, k, f) + 30 * n) + reslots * n * 8 * k
    return bound(nbytes, ops)


def k5_bound(n: int, k: int, met, reslots: int,
             needed: bool = False) -> tuple[float, str]:
    """K5's least time for one call.  Bytes: where the plane's two phases
    (N rows of 128 words each) fit on chip (:data:`ON_CHIP_BYTES`), as at
    N=65,536 (67 MB), the plane and boot block read once and both phases
    written once; where they do not, as at N=2^20 (1.07 GB, twenty times
    the L2), the plane read once and written once per tick.  Plus the
    metric rows.  With ``needed``, also the rows this call's data makes
    it merge: ``recv`` (the received merges in ``met``) times a row's
    2K words, since a partner row is read when its sender flags it, at a
    time no block of the grid order can plan for.  Operations: those
    this call's data needs, per tick 8 per merge candidate of each merge
    it received (``recv``: a partner's K slots and self-entry, the
    JOINREP broadcast) and, per row, 40 a slot for extraction, detection
    and the subject's schedule plus 30 for decisions and sends; at each
    re-slot one candidate (8 operations) a slot."""
    import torch

    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import MET_RECV
    s_ticks = met.shape[0]
    plane = 4 * n * 128
    if 2 * plane <= ON_CHIP_BYTES:
        nbytes = plane + 4 * 8 * 128 + 2 * plane
    else:
        nbytes = 2 * s_ticks * plane
    nbytes += 4 * s_ticks * 128
    recv = int(met[:, MET_RECV].to(torch.int64).sum())
    if needed:
        nbytes += recv * 2 * k * 4
    ops = recv * 8 * (k + 1) + s_ticks * n * (40 * k + 30) \
        + reslots * n * 8 * k
    return bound(nbytes, ops)


def boot_bound(n: int) -> tuple[float, str]:
    """The boot pre-pass's least time: each row's aux word read (4 bytes
    a row), the introducer's row read and the 8-row block written; about
    25 integer operations a row (the flag test, the slot hash, the
    key)."""
    return bound(4 * n + 4 * 128 + 4 * 8 * 128, 25 * n)


def draw_bound(n: int, na: int, drawn_ticks: int,
               s_ticks: int) -> tuple[float, str]:
    """The drop draw's least time: its outputs written once (S (N^2 + 2N)
    bytes; it reads nothing but its arguments) against 70 int32
    operations (threefry-2x32's 20 rounds of add, rotate and xor, and 5
    key injections of two adds; the index split, the mantissa and the
    compare not counted) for each element of the ticks whose window is
    open, (na + 2) na a tick; a closed tick draws nothing."""
    return bound(s_ticks * (n * n + 2 * n), 70 * drawn_ticks * (na + 2) * na)


def draw_timing(dev) -> dict:
    """The dense drop draw as the two dense routes call it, each timed
    (``route_ms``): the per-tick route's ``tick_drop_masks`` at ticks 300
    (the last tick of the drop window) and 699 (window closed) of the
    700-tick bench corner (N=2816), the K2 route's ``drop_stack`` for the
    last full launch of the 200-tick corner (N=896, S=8, ticks 192-199);
    where the checkout has the kernel, also ``drop_masks`` held against
    its plain version on the same inputs, both timed, with the bound."""
    from gossip_protocol_tpu_torch.core.dense_corner import bench_stream_width
    from gossip_protocol_tpu_torch.core.dense_mega import drop_stack
    from gossip_protocol_tpu_torch.ops import drop as drop_ops
    from gossip_protocol_tpu_torch.state import make_schedule_host
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    out = {}
    for key, ticks, t, s_ticks in (("draw_t300", 700, 300, 1),
                                   ("draw_t699", 700, 699, 1),
                                   ("draw_stack", 200, 192, 8)):
        cfg = bench_cfg(ticks)
        a = bench_stream_width(cfg)
        sched = make_schedule_host(cfg)
        rng = prng_key(cfg.seed)
        active = [sched.drop_on(t + i) for i in range(s_ticks)]
        if s_ticks == 1:
            def route():
                return drop_ops.tick_drop_masks(rng, t, a, active[0],
                                                sched.drop_prob, dev)
        else:
            def route():
                return drop_stack(rng, t, s_ticks, a, sched, dev)
        d = dict(n=a, tick=t, s_ticks=s_ticks, drawn_ticks=sum(active),
                 route_ms=cuda_ms(route, 20))
        if "drop_masks" in wrappers():
            args = (rng, t, active, sched.drop_prob, a)
            got = drop_ops.drop_masks(*args, device=dev)
            want = drop_ops.drop_masks_plain(*args, device=dev)
            d.update(max_abs_err=max(max_abs_err(x, y)
                                     for x, y in zip(got, want)),
                     ms=cuda_ms(lambda: drop_ops.drop_masks(
                         *args, device=dev), 50),
                     plain_ms=cuda_ms(lambda: drop_ops.drop_masks_plain(
                         *args, device=dev), 3),
                     bound=draw_bound(a, a, sum(active), s_ticks))
        out[key] = d
    return out


def validate_overlay(res) -> dict:
    """bench.py's validation of an overlay run (bench.py:365-381 and
    _check_recover :255-316): every peer in the group at the end, no
    victim slot and no victim entry left, and every member uncovered at
    the end covered again within SLOT_EPOCH + 1 continuation ticks."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import make_overlay_run
    from gossip_protocol_tpu_torch.ops.overlay_rules import (
        SLOT_EPOCH, covered_histogram)
    cfg, m = res.cfg, res.metrics
    if int(m.in_group[-1]) != cfg.n:
        raise AssertionError("overlay: join/rejoin incomplete")
    if int(m.victim_slots[-1]) != 0:
        raise AssertionError("overlay: victims not purged")
    _, victims_left = res.final_coverage()
    if victims_left:
        raise AssertionError("overlay: victim entries left")
    before = res.uncovered_members()
    if before.size:
        run1 = make_overlay_run(cfg, 1)
        state = res.final_state
        covered = torch.zeros(cfg.n, dtype=torch.bool, device=state.device)
        for _ in range(SLOT_EPOCH + 1):
            state, _ = run1(state, res.sched)
            covered |= covered_histogram(state.ids, cfg.n)
        still = before[~covered.cpu().numpy()[before]]
        if still.size:
            raise AssertionError(
                f"overlay: members {still[:5].tolist()} stayed uncovered "
                f"past the {SLOT_EPOCH + 1}-tick re-cover bound")
    return {"in_group_final": int(m.in_group[-1]),
            "victim_slots_final": int(m.victim_slots[-1]),
            "victim_entries_final": victims_left,
            "uncovered_final_recovered": int(before.size),
            "removals_total": int(m.removals.sum()),
            "false_removals_total": int(m.false_removals.sum())}


def overlay_equal(a, b, ma, mb, skip=()) -> list:
    """Fields of two overlay states / metrics that differ."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import METRIC_FIELDS
    bad = [f for f in ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                       "joinreq", "joinrep")
           if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]
    if a.tick != b.tick:
        bad.append("tick")
    for f in METRIC_FIELDS:
        if f in skip:
            continue
        x, y = getattr(ma, f), getattr(mb, f)
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        y = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
        if not np.array_equal(x, y):
            bad.append(f)
    return bad


# ------------------------------------------------------------- phases

def wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import \
        dense_mega_ticks
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
        fused_overlay_tick
    from gossip_protocol_tpu_torch.ops.cuda import overlay_grid
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import \
        mega_overlay_ticks
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import tick_epilogue
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    out = {"masked_max3": masked_max3, "tick_epilogue": tick_epilogue,
           "dense_mega_ticks": dense_mega_ticks,
           "fused_overlay_tick": fused_overlay_tick,
           "mega_overlay_ticks": mega_overlay_ticks,
           "grid_overlay_ticks": overlay_grid.grid_overlay_ticks}
    # K5's boot pre-pass and the dense drop draw (a checkout before them,
    # timed by --turns, has none)
    if hasattr(overlay_grid, "grid_boot_rows"):
        out["grid_boot_rows"] = overlay_grid.grid_boot_rows
    from gossip_protocol_tpu_torch.ops import drop as drop_ops
    if hasattr(drop_ops, "drop_masks"):
        out["drop_masks"] = drop_ops.drop_masks
    return out


def draw_kernel() -> tuple:
    """The dense paths' drop-draw kernel, where the checkout has one."""
    return ("drop_masks",) if "drop_masks" in wrappers() else ()


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


class MainPath:
    """Drives main-path runs with the launch counters zeroed just before
    each and read just after, and totals them."""

    def __init__(self):
        self.total = dict.fromkeys(wrappers(), 0)

    def drive(self, fn, expect: tuple):
        import torch
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"path did not launch {k}: {counts}")
        for k, v in counts.items():
            self.total[k] += v
        return out, counts


#: the torch operators of utils/threefry.py's draw (its shifts and xors),
#: which no other part of the dense path issues
THREEFRY_OPS = ("aten::__xor__", "aten::__rshift__", "aten::__lshift__")


def profile_run(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: its wall time, the
    device time of every kernel and copy, the device's idle share, the
    ten largest entries by device time, the eight largest host
    operations by their own CPU time, and the calls of the threefry
    draw's torch operators (:data:`THREEFRY_OPS`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, host = [], []
    threefry_ops = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            host.append((e.self_cpu_time_total, e.key, e.count))
            if e.key in THREEFRY_OPS:
                threefry_ops += e.count
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    if not rows:
        return {"wall_s": wall, "device_busy_s": "not measured",
                "threefry_op_calls": threefry_ops}
    busy = sum(r[0] for r in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "threefry_op_calls": threefry_ops,
            "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:10]],
            "top_host": [{"name": k[:60], "self_cpu_ms": us / 1e3,
                          "calls": c} for us, k, c in sorted(host)[::-1][:8]]}


def bench_cfg(ticks: int):
    """BASELINE's dense N=4096 10% drop bench (bench.py:419-434)."""
    from gossip_protocol_tpu_torch.config import SimConfig
    return SimConfig(max_nnb=4096, single_failure=False, drop_msg=True,
                     msg_drop_prob=0.1, seed=0, total_ticks=ticks)


def trace_cfgs() -> dict:
    """The two dense trace runs: N=512 multifailure (K2) and N=1024
    multifailure 10% drop (K1)."""
    from gossip_protocol_tpu_torch.config import SimConfig
    return {"trace_n512_multi": SimConfig(max_nnb=512, single_failure=False,
                                          seed=0),
            "trace_n1024_drop": SimConfig(max_nnb=1024, single_failure=False,
                                          drop_msg=True, msg_drop_prob=0.1,
                                          seed=0)}


def graded_path(main_path) -> dict:
    """Phase 3: the three N=10 testcases on ``cuda``, each run to its logs
    and timed (wall seconds between two synchronizations), then graded:
    the grade must be 90."""
    import torch

    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.sim import run_scenario
    from gossip_protocol_tpu_torch.grader import grade_all
    walls = {}

    def run(conf: str, wd: str) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_scenario(SimConfig.from_conf(conf), outdir=wd, device="cuda")
        torch.cuda.synchronize()
        walls[os.path.basename(conf)[:-len(".conf")]] = \
            time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as wd:
        res, counts = main_path.drive(
            lambda: grade_all(run, os.path.join(REPO, "testcases"), wd),
            ("masked_max3", "tick_epilogue") + draw_kernel())
    if res["total"] != 90:
        raise AssertionError(f"grade {res['total']} != 90")
    say(f"phase 3: testcases on cuda graded {res['total']}/90; walls "
        f"{json.dumps(walls)}; launches {counts}")
    return {"grade": res["total"], "launches": counts, "wall_s": walls}


def dense_runs(main_path) -> dict:
    """Phases 5a-c: the N=512 multifailure trace (K2) and the N=1024 10%
    drop trace (K1) held to their oracles, and the N=4096 10% drop bench
    at 700 ticks (corner 2816, K1) and 200 ticks (corner 896, K2), each
    after an untimed run."""
    from gossip_protocol_tpu_torch.core.sim import Simulation
    runs = {}
    traces = trace_cfgs()
    draw = draw_kernel()
    for key, exact, expect, label in (
            ("trace_n512_multi", True, ("dense_mega_ticks",) + draw,
             "5a: N=512 multifailure trace, 700 ticks (K2)"),
            ("trace_n1024_drop", False,
             ("masked_max3", "tick_epilogue") + draw,
             "5b: N=1024 multifailure 10% drop trace, 700 ticks (K1)")):
        cfg = traces[key]
        (r, counts) = main_path.drive(
            lambda: Simulation(cfg, device="cuda").run(), expect)
        o = oracle_trace(r, exact_removal=exact)
        runs[key] = dict(wall_s=r.wall_seconds, launches=counts, **o)
        say(f"phase {label}: {o}; wall {r.wall_seconds:.3f} s; "
            f"launches {counts}")
        del r
    for ticks, expect in ((700, ("masked_max3", "tick_epilogue") + draw),
                          (200, ("dense_mega_ticks",) + draw)):
        sim = Simulation(bench_cfg(ticks), device="cuda")
        sim.run_bench(warmup=False)     # untimed warm-up, not counted
        (r, counts) = main_path.drive(lambda: sim.run_bench(warmup=False),
                                      expect)
        o = oracle_bench(r)
        runs[f"bench_n4096_t{ticks}"] = dict(
            corner=r.counter_stream_width, wall_s=r.wall_seconds,
            node_ticks_per_s=r.node_ticks_per_second, launches=counts, **o)
        idle = ""
        if ticks == 200:   # one more run, profiled (not counted)
            prof = profile_run(lambda: sim.run_bench(warmup=False))
            runs["bench_n4096_t200"]["idle_share"] = prof.get("idle_share")
            idle = f", device idle {prof.get('idle_share')} (profiled run)"
        say(f"phase 5c: bench N=4096 10% drop, {ticks} ticks, corner "
            f"{r.counter_stream_width}: {r.node_ticks_per_second:.1f} "
            f"node-ticks/s (wall {r.wall_seconds:.3f} s{idle}); {o}; "
            f"launches {counts}")
        del r, sim
    return runs


def overlay_runs(main_path):
    """Phase 5e: BASELINE's three overlay configurations at full width,
    each timed and held to bench.py's validation; K4 at N=4096, K5 above
    (with its boot pre-pass where the checkout has one), never K3.
    Returns the configurations, the results and the phase's numbers."""
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    ocfg = {name: overlay_cfg(name)
            for name in ("drop4096", "churn65k", "powerlaw1m")}
    k5 = ("grid_overlay_ticks",)
    ores, runs = {}, {}
    for name, expect in (("drop4096", ("mega_overlay_ticks",)),
                         ("churn65k", k5 + (("grid_boot_rows",)
                                            if "grid_boot_rows" in wrappers()
                                            else ())),
                         ("powerlaw1m", k5)):
        cfg = ocfg[name]
        (r, counts) = main_path.drive(
            lambda: OverlaySimulation(cfg, device="cuda").run(), expect)
        if counts["fused_overlay_tick"]:
            raise AssertionError(f"overlay {name} took the per-tick K3 route")
        o = validate_overlay(r)
        ores[name] = r
        runs[f"overlay_{name}"] = dict(
            n=cfg.n, ticks=cfg.total_ticks, wall_s=r.wall_seconds,
            node_ticks_per_s=r.node_ticks_per_second, launches=counts, **o)
        idle = ""
        if name == "drop4096":   # one more run, profiled (not counted)
            prof = profile_run(
                lambda: OverlaySimulation(cfg, device="cuda").run())
            runs["overlay_drop4096"]["idle_share"] = prof.get("idle_share")
            idle = f", device idle {prof.get('idle_share')} (profiled run)"
        say(f"phase 5e: overlay {name} N={cfg.n}, {cfg.total_ticks} ticks: "
            f"{r.node_ticks_per_second:.1f} node-ticks/s (wall "
            f"{r.wall_seconds:.3f} s{idle}); {o}; launches {counts}")
    return ocfg, ores, runs


def dense_timing(dev, describe: bool) -> dict:
    """Phase 6's dense kernels, each held against its plain version and
    timed on the input of a launch the main path makes: masked_max3 and
    tick_epilogue at tick 699 of the N=4096 700-tick bench corner
    (N=2816), of the N=1024 drop trace and of the N=10 multifailure
    testcase (the last two with events, as those runs launch them); K2
    on its last full launch of the 200-tick bench corner (N=896, S=8),
    of the N=512 trace and of phase 4's N=64 multifailure run (S=16,
    events); the drop draw (:func:`draw_timing`).  ``describe`` as in
    :func:`time_k1`."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.dense_corner import bench_stream_width
    traces = trace_cfgs()
    multi10 = SimConfig.from_conf(os.path.join(REPO, "testcases",
                                               "multifailure.conf"))
    timing = {}
    for key, cfg, a, ev, reps in (
            ("k1", bench_cfg(700), bench_stream_width(bench_cfg(700)),
             False, 20),
            ("k1_n1024", traces["trace_n1024_drop"], 1024, True, 50),
            ("k1_n10", multi10, 10, True, 200)):
        timing[key] = time_k1(k1_launch_input(cfg, a, dev), cfg.t_remove,
                              with_events=ev, reps=reps, describe=describe)
    for key, cfg, a, ev in (
            ("k2", bench_cfg(200), bench_stream_width(bench_cfg(200)), False),
            ("k2_trace512", traces["trace_n512_multi"], 512, True),
            ("k2_n64", SimConfig(max_nnb=64, single_failure=False, seed=3),
             64, True)):
        x, s = k2_launch_input(cfg, a, dev)
        timing[key] = time_k2(x, s, cfg, with_events=ev, reps=10)
        del x
    timing.update(draw_timing(dev))
    return timing


def overlay_timing(ocfg) -> tuple[dict, dict]:
    """Phase 6's overlay kernels, each held against its plain version and
    timed on the input of a launch the main path makes (the run stopped
    there): K3 at the last tick of the N=65,536 churn and N=4096 drop
    runs and at tick 136 of the N=2^20 power-law run (the per-tick
    cross-check's launches at those widths), K4 at the last full launch
    of the N=4096 drop run, K5 at the last full launches of the N=65,536
    and 2^20 runs (its boot pre-pass inside the call, as the route calls
    it, where the checkout has one), with both bounds, and the boot
    pre-pass at tick 16 of both K5 runs; K5 with its resident blocks an
    SM.  Returns the timings and each kernel's max abs error."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import (
        OverlaySimulation, make_overlay_schedule, resolved_dims)
    from gossip_protocol_tpu_torch.ops.cuda import overlay_grid as ogk
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    from gossip_protocol_tpu_torch.ops.cuda.overlay_mega import (
        MEGA_TICKS, mega_overlay_ticks, mega_overlay_ticks_plain)
    timing, errs = {}, {}
    for key, name, tick, reps in (("k3", "churn65k", None, 50),
                                  ("k3_drop4096", "drop4096", None, 50),
                                  ("k3_powerlaw1m", "powerlaw1m", 136, 20)):
        cfg = ocfg[name]
        tick = cfg.total_ticks - 1 if tick is None else tick
        x = k3_launch_input(cfg, OverlaySimulation(cfg, device="cuda").run(
            ticks=tick).final_state)
        k, f = resolved_dims(cfg)
        recv = int(fused_overlay_tick(*x["args"], **x["kw"])[3][:, 0]
                   .to(torch.int64).sum())
        timing[key] = dict(
            n=cfg.n, k=k, f=f, tick=tick, recv=recv,
            max_abs_err=compare_k3(x),
            ms=cuda_ms(lambda: fused_overlay_tick(*x["args"], **x["kw"]),
                       reps),
            plain_ms=cuda_ms(
                lambda: fused_overlay_tick_plain(*x["args"], **x["kw"]), 3),
            bound=k3_bound(cfg.n, k, f),
            bound_needed=k3_bound(cfg.n, k, f, recv))
        errs["fused_overlay_tick"] = max(errs.get("fused_overlay_tick", 0.0),
                                         timing[key]["max_abs_err"])
        del x
    cfg = ocfg["drop4096"]
    t0 = (cfg.total_ticks // MEGA_TICKS - 1) * MEGA_TICKS
    x = k4_launch_input(cfg, OverlaySimulation(cfg, device="cuda").run(
        ticks=t0).final_state, MEGA_TICKS)
    k, f = resolved_dims(cfg)
    timing["k4"] = dict(
        n=cfg.n, k=k, f=f, s_ticks=MEGA_TICKS, sp=t0,
        max_abs_err=compare_k4(x),
        ms=cuda_ms(lambda: mega_overlay_ticks(x["st"], x["sp"], **x["kw"]),
                   20),
        plain_ms=cuda_ms(lambda: mega_overlay_ticks_plain(
            x["st"], x["sp"], **x["kw"]), 1, warm=0),
        bound=k4_bound(cfg.n, k, f, MEGA_TICKS, reslots=1))
    errs["mega_overlay_ticks"] = timing["k4"]["max_abs_err"]
    del x
    for key, name, reps in (("k5_churn65k", "churn65k", 20),
                            ("k5_powerlaw1m", "powerlaw1m", 5)):
        cfg = ocfg[name]
        x, meta = k5_timing_input(cfg)
        err, met = compare_k5(x)
        k, f = resolved_dims(cfg)
        timing[key] = dict(
            n=cfg.n, k=k, f=f, **meta, max_abs_err=err,
            recv=int(met[:, 7].sum()),
            ms=cuda_ms(lambda: ogk.grid_overlay_ticks(*k5_args(x), **x["kw"]),
                       reps),
            plain_ms=cuda_ms(lambda: ogk.grid_overlay_ticks_plain(
                *k5_args(x), **x["kw"]), 1, warm=0),
            bound=k5_bound(cfg.n, k, met, meta["reslots"]),
            bound_needed=k5_bound(cfg.n, k, met, meta["reslots"],
                                  needed=True),
            blocks_per_sm=k5_blocks_per_sm(f, meta["flag_bits"]))
        errs["grid_overlay_ticks"] = max(errs.get("grid_overlay_ticks", 0.0),
                                         err)
        del x, met
        if "grid_boot_rows" in wrappers():
            sched = make_overlay_schedule(cfg)
            st = OverlaySimulation(cfg, device="cuda").run(
                ticks=16).final_state
            xb = boot_input(cfg, [(st, sched)], 16)
            del st
            e, used = compare_boot(xb)
            timing[f"boot_{name}"] = dict(
                n=cfg.n, tick=16, max_abs_err=e, slots_used=used,
                ms=cuda_ms(lambda: ogk.grid_boot_rows(xb["plane"], xb["sp"],
                                                      **xb["kw"]), 50),
                plain_ms=cuda_ms(lambda: ogk.grid_boot_rows_plain(
                    xb["plane"], xb["sp"], **xb["kw"]), 5),
                bound=boot_bound(cfg.n))
            errs["grid_boot_rows"] = max(errs.get("grid_boot_rows", 0.0), e)
            del xb
        torch.cuda.empty_cache()
    return timing, errs


def k5_timing_input(cfg) -> tuple[dict, dict]:
    """The input of the last full K5 launch of ``cfg``'s run (the run
    stopped there), and that launch's tick, flags and re-slots."""
    from gossip_protocol_tpu_torch.models.overlay import (
        OverlaySimulation, make_overlay_schedule)
    from gossip_protocol_tpu_torch.models.segments import plan_segments
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import GRID_TICKS
    from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import \
        _FLAG_BITS as flag_bits
    gt = GRID_TICKS
    t0 = (cfg.total_ticks // gt - 1) * gt
    flags = plan_segments(cfg, gt, t0, gt)[0].flags
    st = OverlaySimulation(cfg, device="cuda").run(ticks=t0).final_state
    x = k5_launch_input(cfg, [(st, make_overlay_schedule(cfg))], t0, gt,
                        flags)
    live = flags.as_kernel_kwargs()
    return x, dict(s_ticks=gt, sp=t0, flags=flags.tag,
                   flag_bits=sum(b for name, b in flag_bits if live[name]),
                   reslots=sum((t + 1) % 16 == 0 for t in range(t0, t0 + gt)))


def k5_blocks_per_sm(f: int, flags: int):
    """Resident blocks an SM holds of K5's variant ``flags`` at F, as its
    persistent grid is sized; None for a checkout without the query."""
    from gossip_protocol_tpu_torch.ops.cuda import _build
    if "gp_grid_blocks_per_sm" not in _build.SOURCES["overlay_tick.cu"]:
        return None
    return _build.library("overlay_tick.cu").gp_grid_blocks_per_sm(f, flags)


#: K5's measurement variants (csrc/overlay_tick.cu K5_VARIANT), built in
#: phase 1 beside the kernel as used: (source, defines)
K5_VARIANTS = tuple(("overlay_tick.cu", (f"-DK5_VARIANT={v}",))
                    for v in (1, 2))
K5_VARIANT_NAMES = {0: "as used", 1: "no partner row loaded",
                    2: "loads alone"}


@contextlib.contextmanager
def k5_variant(v: int):
    """Route ``grid_overlay_ticks`` through K5 variant ``v`` (0: the
    kernel as used) while the block runs."""
    from gossip_protocol_tpu_torch.ops.cuda import _build
    lib = _build.library("overlay_tick.cu")
    _build._libs["overlay_tick.cu"] = _build.library(
        "overlay_tick.cu", K5_VARIANTS[v - 1][1]) if v else lib
    try:
        yield
    finally:
        _build._libs["overlay_tick.cu"] = lib


def k5_variant_timing(ocfg, rounds: int = 2) -> dict:
    """Phase 6's two K5 inputs through each K5 variant in turns (as used,
    1, 2, ``rounds`` times; ms a call, CUDA-event means): what the
    partner loads and the loads as a whole cost (the variants compute
    wrong results by design, so only their times are read)."""
    import torch

    from gossip_protocol_tpu_torch.ops.cuda import overlay_grid as ogk
    out = {}
    for name, reps in (("churn65k", 20), ("powerlaw1m", 5)):
        x, meta = k5_timing_input(ocfg[name])
        ms = {v: [] for v in K5_VARIANT_NAMES}
        for _ in range(rounds):
            for v in K5_VARIANT_NAMES:
                with k5_variant(v):
                    ms[v].append(cuda_ms(lambda: ogk.grid_overlay_ticks(
                        *k5_args(x), **x["kw"]), reps))
        out[name] = dict(n=ocfg[name].n, tick=meta["sp"], flags=meta["flags"],
                         ms={K5_VARIANT_NAMES[v]: t for v, t in ms.items()})
        del x
        torch.cuda.empty_cache()
    return out


def dense_numbers(details: dict) -> dict:
    """The walls and dense kernel times of one run, flat."""
    out = {f"testcase_{k}_wall_s": v
           for k, v in details["phase3"]["wall_s"].items()}
    out.update({f"{k}_wall_s": v["wall_s"]
                for k, v in details["phase5"].items() if "wall_s" in v})
    for key, v in details["timing"].items():
        if key.startswith("k1"):
            for name in ("masked_max3", "tick_epilogue"):
                out[f"{name}_n{v['n']}_ms"] = v[name]["ms"]
        elif key.startswith("k2"):
            out[f"dense_mega_ticks_n{v['n']}_ms"] = v["ms"]
        elif key.startswith("draw"):
            out[f"{key}_n{v['n']}_route_ms"] = v["route_ms"]
    out.update({f"{k}_idle_share": v["idle_share"]
                for k, v in details["phase5"].items() if "idle_share" in v})
    return out


def overlay_numbers(details: dict) -> dict:
    """The overlay walls and kernel times (with their bounds) of one run,
    flat."""
    out = {f"{k}_wall_s": v["wall_s"]
           for k, v in details["phase5"].items() if k.startswith("overlay")}
    out.update({f"{k}_idle_share": v["idle_share"]
                for k, v in details["phase5"].items() if "idle_share" in v})
    for key, v in details["timing"].items():
        if key.startswith(("k3", "k4", "k5", "boot")):
            out[f"{key}_n{v['n']}_ms"] = v["ms"]
            out[f"{key}_n{v['n']}_bound_ms"] = v["bound"][0]
            if "bound_needed" in v:
                out[f"{key}_n{v['n']}_needed_bound_ms"] = v["bound_needed"][0]
    return out


def turns(other: str, path: str = "dense", rounds: int = 2) -> dict:
    """One path of the checkout at ``other`` and of this one in turns:
    other, this, this, other, ``rounds`` times, each run a process of its
    own with its tree's package first on the path: ``--dense-only``
    (``path`` "dense", :func:`dense_numbers`) or ``--overlay-only``
    ("overlay", :func:`overlay_numbers`).  Returns the order and every
    metric as a list in that order (None where a tree has no such
    number)."""
    me = os.path.abspath(__file__)
    flag, numbers_of = {"dense": ("--dense-only", dense_numbers),
                        "overlay": ("--overlay-only", overlay_numbers)}[path]
    order, numbers = [], []
    with tempfile.TemporaryDirectory() as td:
        for i, tree in enumerate((other, REPO, REPO, other) * rounds):
            tree = os.path.abspath(tree)
            out = os.path.join(td, f"{i}.json")
            proc = subprocess.run(
                [sys.executable, me, flag, tree, "--details", out],
                capture_output=True, text=True, cwd=tree)
            if proc.returncode != 0:
                raise RuntimeError(f"{flag} of {tree} failed:\n"
                                   f"{proc.stdout[-4000:]}\n"
                                   f"{proc.stderr[-4000:]}")
            with open(out) as f:
                numbers.append(numbers_of(json.load(f)))
            order.append("this" if tree == REPO else "other")
    keys = list(dict.fromkeys(k for n in numbers for k in n))
    return {"path": path, "order": order,
            "metrics": {k: [n.get(k) for n in numbers] for k in keys}}


def write_details(path: str, details: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(details, f, indent=1, default=str)


def read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--details", default=None,
                    help="also write every measured number to this JSON")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more run of each phase-5 "
                         "configuration, overlay runs included (device "
                         "busy share, kernels by device time) into the "
                         "details")
    ap.add_argument("--dense-only", default=None, metavar="TREE",
                    help="run only the dense path of the package in the "
                         "checkout at TREE (this one: .): phase 6's dense "
                         "kernels (first, which warms the card), then "
                         "phases 3 and 5a-c; no kernels line and no "
                         "result line")
    ap.add_argument("--overlay-only", default=None, metavar="TREE",
                    help="run only the overlay path of the package in the "
                         "checkout at TREE (this one: .): phase 6's "
                         "overlay kernels, then phase 5e's three runs with "
                         "their walls; no kernels line and no result line")
    ap.add_argument("--turns", default=None, metavar="TREE",
                    help="run --dense-only (or, with --turns-path overlay, "
                         "--overlay-only) for the checkout at TREE and this "
                         "one in turns: TREE, this, this, TREE, twice")
    ap.add_argument("--turns-path", default="dense",
                    choices=("dense", "overlay"),
                    help="the path --turns measures")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    only = args.dense_only or args.overlay_only
    sys.path.insert(0, os.path.abspath(only or REPO))
    import gossip_protocol_tpu_torch  # noqa: F401  (fails alone)
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.sim import Simulation
    from gossip_protocol_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda")
    details = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t_start = time.perf_counter()

    # ---- phase 1: card and build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    details["nvidia_smi"] = smi
    tb = time.perf_counter()
    # K5's measurement variants only for this checkout's own full run
    build_kw = {} if args.turns or only else {"variants": K5_VARIANTS}
    libs = _build.build(verbose=True, **build_kw)
    for source in _build.SOURCES:
        _build.library(source)
    build_s = time.perf_counter() - tb
    details["build_s"] = build_s
    say(f"phase 1: {torch.cuda.get_device_name(0)} (torch {torch.__version__},"
        f" CUDA {torch.version.cuda}); kernels built in {build_s:.1f} s "
        f"-> {', '.join(os.path.relpath(p, REPO) for p in libs)}")
    if args.turns:
        details["turns"] = turns(args.turns, args.turns_path)
        say(json.dumps(details["turns"]))
    if args.dense_only:
        main_path = MainPath()
        details["timing"] = dense_timing(dev, describe=False)
        details["phase3"] = graded_path(main_path)
        details["phase5"] = dense_runs(main_path)
        say(json.dumps(dense_numbers(details)))
    if args.overlay_only:
        ocfg = {name: overlay_cfg(name)
                for name in ("drop4096", "churn65k", "powerlaw1m")}
        details["timing"], errs = overlay_timing(ocfg)
        if any(errs.values()):
            raise AssertionError(f"overlay kernel != plain: {errs}")
        details["phase5"] = overlay_runs(MainPath())[2]
        say(json.dumps(overlay_numbers(details)))
    if args.turns or only:
        if args.details:
            write_details(args.details, details)
        return 0

    # ---- phase 2: kernel vs plain on the card ------------------------
    errs = dict.fromkeys(wrappers(), 0.0)
    for n in (10, 64, 1024, 2816):
        for sparse in (False, True):
            e = compare_k1(k1_inputs(n, n, dev, sparse=sparse), t_remove=20)
            for k, v in e.items():
                errs[k] = max(errs[k], v)
    for n, s in ((64, 16), (512, 16), (896, 8)):
        kws = [dict(n=n, s_ticks=s, t_remove=20, can_rejoin=rejoin,
                    with_events=ev)
               for ev, rejoin in ((True, True), (False, False))]
        errs["dense_mega_ticks"] = max(
            errs["dense_mega_ticks"],
            compare_k2(k2_inputs(n, s, n, dev), kws))
    # the drop draw at the dense widths (N=10 testcases, N=64, the corners
    # 896 and 2816), one launch of S ticks with the window closed at every
    # fourth, at full width and embedded at 3/4 of it
    if "drop_masks" in wrappers():
        from gossip_protocol_tpu_torch.ops.drop import (drop_masks,
                                                        drop_masks_plain)
        from gossip_protocol_tpu_torch.utils.threefry import prng_key
        for n in (10, 64, 896, 2816):
            for s in (1, 8, 16):
                for na in (n, n * 3 // 4):
                    draw = (prng_key(n + s), 51,
                            [s == 1 or i % 4 != 0 for i in range(s)],
                            np.float32(0.1), n)
                    got = drop_masks(*draw, n_active=na, device=dev)
                    want = drop_masks_plain(*draw, na, dev)
                    errs["drop_masks"] = max(
                        errs["drop_masks"],
                        max(max_abs_err(a, b) for a, b in zip(got, want)))
    # K3 on random valid states, built by the tick's own code
    # (churn at tick 300: wipes and rejoins; drop at tick 100: drops)
    for name, n, t in (("churn64", 64, 150), ("drop4096", 4096, 100),
                       ("churn65k", 65536, 300)):
        cfg = overlay_cfg(name, max_nnb=n) if name == "churn64" \
            else overlay_cfg(name)
        x = k3_launch_input(cfg, overlay_state(cfg, t, n, dev))
        errs["fused_overlay_tick"] = max(errs["fused_overlay_tick"],
                                         compare_k3(x))
    # K4 at N=64 and 4096 (S=16, a re-slot inside the launch) and a
    # 12-tick remainder launch; churn, drop and power-law degrees
    for name, over, t, s in (
            ("churn64", {}, 60, 16),
            ("churn65k", dict(max_nnb=4096, step_rate=40.0 / 4096), 300, 16),
            ("drop4096", {}, 100, 12),
            ("churn64", dict(topology="powerlaw", fanout=5), 60, 16)):
        cfg = overlay_cfg(name, **over)
        x = k4_launch_input(cfg, overlay_state(cfg, t, cfg.n + t, dev), s)
        errs["mega_overlay_ticks"] = max(errs["mega_overlay_ticks"],
                                         compare_k4(x))
    # K5 on random valid states at N=64, 4096 and 65,536: each flag
    # combination the two K5 configurations' plans use (random join bits
    # only where the join phase is live), all-live launches on and off the
    # slot-epoch grid, a 12-tick remainder, and a B=2 fleet launch
    from gossip_protocol_tpu_torch.models.overlay import make_overlay_schedule
    from gossip_protocol_tpu_torch.models.segments import ALL_LIVE
    errs["grid_overlay_ticks"] = 0.0
    k5_checked = 0
    for n in (64, 4096, 65536):
        for name in ("churn65k", "powerlaw1m"):
            cfg = grid_cfg(name, n)
            sched = make_overlay_schedule(cfg)
            for i, (t0, s, flags) in enumerate(k5_cases(cfg)):
                st = overlay_state(cfg, t0, n + i, dev)
                if not flags.join_live:
                    st.joinreq.zero_()
                    st.joinrep.zero_()
                e, _ = compare_k5(k5_launch_input(cfg, [(st, sched)], t0, s,
                                                  flags))
                errs["grid_overlay_ticks"] = max(errs["grid_overlay_ticks"],
                                                 e)
                k5_checked += 1
        cfg = grid_cfg("churn65k", n)
        lanes = [(overlay_state(cfg, 160, n + b, dev),
                  make_overlay_schedule(cfg.replace(seed=b))) for b in (1, 2)]
        e, _ = compare_k5(k5_launch_input(cfg, lanes, 160, 16, ALL_LIVE))
        errs["grid_overlay_ticks"] = max(errs["grid_overlay_ticks"], e)
        k5_checked += 1
    # K5's boot pre-pass against _boot_rows on join-live launches: the real
    # states at ticks 16 and 20 (start ramp, JOINREQs in flight) of the
    # power-law shape at N=64, 4096, 65,536 and 2^20, and a B=2 fleet of
    # the churn shape at N=4096 whose lanes have seeds 0 and 1
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    errs["grid_boot_rows"] = 0.0
    boot_slots = {}
    for n in (64, 4096, 65536, 1 << 20):
        cfg = grid_cfg("powerlaw1m", n)
        sched = make_overlay_schedule(cfg)
        for t0 in (16, 20):
            st = OverlaySimulation(cfg, device="cuda").run(
                ticks=t0).final_state
            e, used = compare_boot(boot_input(cfg, [(st, sched)], t0))
            errs["grid_boot_rows"] = max(errs["grid_boot_rows"], e)
            boot_slots[f"n{n}_t{t0}"] = used
            del st
        if not boot_slots[f"n{n}_t16"] + boot_slots[f"n{n}_t20"]:
            raise AssertionError(f"boot check at N={n} without a JOINREQ")
    cfg = grid_cfg("churn65k", 4096)
    lanes = []
    for seed in (0, 1):
        c = cfg.replace(seed=seed)
        lanes.append((OverlaySimulation(c, device="cuda").run(
            ticks=16).final_state, make_overlay_schedule(c)))
    e, used = compare_boot(boot_input(cfg, lanes, 16))
    if not used:
        raise AssertionError("fleet boot check without a JOINREQ")
    errs["grid_boot_rows"] = max(errs["grid_boot_rows"], e)
    boot_slots["fleet_n4096_t16"] = used
    details["boot_slots_phase2"] = boot_slots
    del lanes
    # K3 at N=2^20, F=8 on a real mid-run state (tick 136, the fail tick)
    cfg1m = overlay_cfg("powerlaw1m")
    mid = OverlaySimulation(cfg1m, device="cuda").run(ticks=136)
    errs["fused_overlay_tick"] = max(
        errs["fused_overlay_tick"],
        compare_k3(k3_launch_input(cfg1m, mid.final_state)))
    del mid
    torch.cuda.synchronize()
    if any(v != 0 for v in errs.values()):
        raise AssertionError(f"kernel != plain version: {errs}")
    say(f"phase 2: kernels == plain versions bit for bit "
        f"(max abs err {errs}; {k5_checked} K5 launches; boot pre-pass "
        f"aggregate slots checked {boot_slots})")
    details["max_abs_err_phase2"] = dict(errs)

    main_path = MainPath()
    # ---- phase 3: graded path on the card ----------------------------
    details["phase3"] = graded_path(main_path)

    # ---- phase 4: card vs CPU, byte-identical logs -------------------
    out4 = {}
    for name, kw in (("multi64", dict(single_failure=False)),
                     ("drop64", dict(single_failure=True, drop_msg=True,
                                     msg_drop_prob=0.1))):
        cfg = SimConfig(max_nnb=64, seed=3, **kw)
        with tempfile.TemporaryDirectory() as wd:
            (r_gpu, counts) = main_path.drive(
                lambda: Simulation(cfg, device="cuda").run(),
                ("dense_mega_ticks",) + draw_kernel())
            r_cpu = Simulation(cfg, device="cpu").run()
            logs = {}
            for tag, r in (("cuda", r_gpu), ("cpu", r_cpu)):
                d = os.path.join(wd, tag)
                os.makedirs(d)
                r.write_logs(d)
                logs[tag] = [read_file(os.path.join(d, f)) for f in
                             ("dbg.log", "msgcount.log", "stats.log")]
            if logs["cuda"] != logs["cpu"]:
                raise AssertionError(f"{name}: cuda logs != cpu logs")
        out4[name] = {"dbg_bytes": len(logs["cuda"][0]), "launches": counts}
    say(f"phase 4: N=64 multifailure and drop logs byte-identical on "
        f"cuda and cpu {out4}")
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    for name in ("churn64", "drop128"):
        cfg = overlay_cfg(name)
        (r_gpu, counts) = main_path.drive(
            lambda: OverlaySimulation(cfg, device="cuda").run(),
            ("mega_overlay_ticks",))
        r_cpu = OverlaySimulation(cfg, device="cpu").run()
        bad = overlay_equal(r_gpu.final_state, r_cpu.final_state,
                            r_gpu.metrics, r_cpu.metrics)
        if bad:
            raise AssertionError(f"overlay {name}: cuda != cpu in {bad}")
        out4[f"overlay_{name}"] = {
            "ticks": cfg.total_ticks, "launches": counts,
            "removals_total": int(r_gpu.metrics.removals.sum())}
    say(f"phase 4: overlay N=64 churn (200 ticks) and N=128 drop (120 "
        f"ticks): final state and every metric equal on cuda and cpu "
        f"{ {k: v for k, v in out4.items() if k.startswith('overlay')} }")
    details["phase4"] = out4

    # ---- phase 5: full-width runs -------------------------------------
    runs = dense_runs(main_path)

    ocfg, ores, oruns = overlay_runs(main_path)
    runs.update(oruns)
    # cross-paths on the card: the per-tick K3 route (driven as a main
    # path: K3's launches are counted here) equals K4 over the whole
    # N=4096 run and K5 over the whole N=65,536 and 2^20 runs
    # (live_uncovered is -1 on the K4 and K5 routes); K3 == the plain
    # per-tick path over the first 48 ticks of the N=65,536 churn run; a
    # B=4 K5 fleet of the N=65,536 churn run (seeds 0-3, 64 ticks) equals
    # its lanes' solo K5 runs
    from gossip_protocol_tpu_torch.models.overlay import (
        init_overlay_state, make_overlay_run, make_overlay_schedule)
    cross = {}
    for name, other in (("drop4096", "K4"), ("churn65k", "K5"),
                        ("powerlaw1m", "K5")):
        cfg = ocfg[name]
        (f_k3, m_k3), counts = main_path.drive(
            lambda: make_overlay_run(cfg, mega=False, grid=False)(
                init_overlay_state(cfg, dev), make_overlay_schedule(cfg)),
            ("fused_overlay_tick",))
        r = ores[name]
        bad = overlay_equal(r.final_state, f_k3, r.metrics, m_k3,
                            skip=("live_uncovered",))
        if bad:
            raise AssertionError(f"overlay {name}: {other} != per-tick K3 "
                                 f"in {bad}")
        cross[name] = {"ticks": cfg.total_ticks, "launches": counts}
        del f_k3, m_k3, r
    cfg = ocfg["churn65k"]
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    outs = [make_overlay_run(cfg, 48, grid=False, exchange=k3)(
        init_overlay_state(cfg, dev), make_overlay_schedule(cfg))
        for k3 in (fused_overlay_tick, fused_overlay_tick_plain)]
    bad = overlay_equal(outs[0][0], outs[1][0], outs[0][1], outs[1][1])
    if bad:
        raise AssertionError(f"overlay N=65536: K3 != plain in {bad}")
    del outs
    from gossip_protocol_tpu_torch.models import overlay_grid as og
    scheds = [make_overlay_schedule(cfg.replace(seed=s)) for s in range(4)]
    (fleet, fmet), counts = main_path.drive(
        lambda: og.make_grid_fleet_run(cfg, 64, 4)(
            og.stack_states([init_overlay_state(cfg, dev)] * 4), scheds),
        ("grid_overlay_ticks",))
    for b, sc in enumerate(scheds):
        solo, smet = og.make_grid_run(cfg, 64, start_tick=0)(
            init_overlay_state(cfg, dev), sc)
        lane_met = type(smet)(**{f: getattr(fmet, f)[b]
                                 for f in vars(smet)})
        bad = overlay_equal(og.lane_state(fleet, b), solo, lane_met, smet)
        if bad:
            raise AssertionError(f"K5 fleet lane {b} != its solo run in "
                                 f"{bad}")
    cross["fleet_churn65k_b4"] = {"ticks": 64, "launches": counts}
    del fleet, fmet, solo, smet
    say("phase 5f: overlay cross-paths on cuda: per-tick K3 == K4 (N=4096 "
        "drop, 608 ticks) and == K5 (N=65536 churn, 608 ticks; N=2^20 "
        "power-law, 272 ticks); N=65536 churn K3 == plain (48 ticks); B=4 "
        f"K5 fleet lanes == solo K5 runs (64 ticks) {cross}")
    runs["cross_paths"] = cross
    details["phase5"] = runs
    if args.profile:
        prof = {key: profile_run(lambda: Simulation(cfg, device="cuda").run())
                for key, cfg in trace_cfgs().items()}
        for ticks in (700, 200):
            prof[f"bench_n4096_t{ticks}"] = profile_run(
                lambda: Simulation(bench_cfg(ticks), device="cuda")
                .run_bench(warmup=False))
        for name, cfg in ocfg.items():
            prof[f"overlay_{name}"] = profile_run(
                lambda: OverlaySimulation(cfg, device="cuda").run())
        details["profile"] = prof
        say("phase 5d: profiled; device idle share " + json.dumps(
            {k: v.get("idle_share") for k, v in prof.items()})
            + "; threefry torch operator calls " + json.dumps(
                {k: v["threefry_op_calls"] for k, v in prof.items()}))
        if draw_kernel() and any(prof[k]["threefry_op_calls"]
                                 for k in prof if not k.startswith("overlay")):
            raise AssertionError("a dense cuda run issued threefry torch "
                                 "operators")
    details["main_path_launches"] = main_path.total

    # ---- phase 6: kernel times on real launch inputs ------------------
    # Each kernel is timed, and held against its plain version, on the
    # input of a launch the main path makes: the run is stopped one
    # launch early and the next launch's input is built as the run
    # builds it.
    timing = dense_timing(dev, describe=True)
    otiming, oerrs = overlay_timing(ocfg)
    timing.update(otiming)
    for name, e in oerrs.items():
        errs[name] = max(errs[name], e)
    if any(oerrs.values()):
        raise AssertionError(f"overlay kernel != plain on a launch input: "
                             f"{errs}")
    details["k5_variants"] = k5_variant_timing(ocfg)
    say("phase 6: K5 variants (ms a call, in turns): "
        + json.dumps(details["k5_variants"]))
    for key in ("k1", "k1_n1024", "k1_n10"):
        for name in ("masked_max3", "tick_epilogue"):
            errs[name] = max(errs[name], timing[key]["max_abs_err"][name])
    errs["dense_mega_ticks"] = max(errs["dense_mega_ticks"],
                                   timing["k2"]["max_abs_err"],
                                   timing["k2_trace512"]["max_abs_err"],
                                   timing["k2_n64"]["max_abs_err"])
    errs["drop_masks"] = max(errs["drop_masks"],
                             *(timing[k]["max_abs_err"] for k in
                               ("draw_t300", "draw_t699", "draw_stack")))
    if any(v != 0 for v in errs.values()):
        raise AssertionError(f"kernel != plain on a launch input: {errs}")
    details["timing"] = timing
    details["max_abs_err"] = errs
    src = "gossip_protocol_tpu_torch/csrc/dense_tick.cu"
    osrc = "gossip_protocol_tpu_torch/csrc/overlay_tick.cu"
    kernels = []
    for name, replaces, tm, shape in (
            ("masked_max3", "gossip_protocol_tpu/ops/merge.py:179",
             timing["k1"]["masked_max3"], {"n": timing["k1"]["n"]}),
            ("tick_epilogue",
             "gossip_protocol_tpu/ops/pallas/tickfused.py:137",
             timing["k1"]["tick_epilogue"], {"n": timing["k1"]["n"]}),
            ("dense_mega_ticks",
             "gossip_protocol_tpu/ops/pallas/dense_mega.py:302",
             timing["k2"], {"n": timing["k2"]["n"],
                            "s_ticks": timing["k2"]["s_ticks"]}),
            ("fused_overlay_tick",
             "gossip_protocol_tpu/ops/pallas/overlay_exchange.py:267",
             timing["k3"], {k: timing["k3"][k] for k in ("n", "k", "f")}),
            ("mega_overlay_ticks",
             "gossip_protocol_tpu/ops/pallas/overlay_mega.py:456",
             timing["k4"], {k: timing["k4"][k]
                            for k in ("n", "k", "f", "s_ticks")}),
            ("grid_overlay_ticks",
             "gossip_protocol_tpu/ops/pallas/overlay_grid.py:710",
             timing["k5_powerlaw1m"],
             {k: timing["k5_powerlaw1m"][k]
              for k in ("n", "k", "f", "s_ticks", "flags")}),
            ("grid_boot_rows",
             "gossip_protocol_tpu/models/overlay_grid.py:147",
             timing["boot_powerlaw1m"],
             {k: timing["boot_powerlaw1m"][k] for k in ("n", "tick")}),
            ("drop_masks", "gossip_protocol_tpu/ops/drop.py:26",
             timing["draw_t300"],
             {k: timing["draw_t300"][k] for k in ("n", "tick", "s_ticks")})):
        kernels.append({
            "name": name, "route": "cuda",
            "source": {"masked_max3": src, "tick_epilogue": src,
                       "dense_mega_ticks": src,
                       "drop_masks": "gossip_protocol_tpu_torch/csrc/drop.cu"
                       }.get(name, osrc),
            "replaces": replaces, "launches": main_path.total[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None, "shape": shape})
        if "bound_needed" in tm:
            kernels[-1]["needed_bytes_bound_ms"] = tm["bound_needed"][0]
    for key in ("k1", "k1_n1024", "k1_n10"):
        t = timing[key]
        say(f"phase 6: masked_max3 at N={t['n']}, tick {t['tick']}: "
            f"{json.dumps(t['merge_stats'])}")
    say("phase 6: overlay kernels (ms; bound ms): " + json.dumps(
        overlay_numbers({"timing": timing, "phase5": {}})))
    say(f"phase 6: timed {len(kernels)} kernels on real launch inputs; "
        f"details {json.dumps(timing)}")
    say(json.dumps({"kernels": kernels}))
    details["kernels"] = kernels

    details["seconds"] = time.perf_counter() - t_start
    if args.details:
        write_details(args.details, details)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

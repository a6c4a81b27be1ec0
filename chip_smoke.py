#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (gossip_protocol_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``gossip_protocol_tpu_torch/csrc/``,
holds each kernel against its plain PyTorch version on the card, drives
the port's dense main path at full width, checks the results, times
every kernel, and prints one line per phase:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. kernel vs plain version on the card, bit-exact, on random inputs:
   ``masked_max3`` + ``tick_epilogue`` at N in {64, 1024, 2816}, dense
   and sparse (empty delivery slabs); ``dense_mega_ticks`` at N in
   {64, 512} (S=16) and N=896 (S=8);
3. the graded path: the three N=10 testcases on ``cuda`` must grade 90;
4. card vs CPU: N=64 multifailure and N=64 drop, 700 ticks — the
   ``dbg.log`` and ``msgcount.log`` bytes of a ``cuda`` run must equal
   those of the port's own ``cpu`` run;
5. full-width runs with closed-form oracles: N=512 multifailure trace
   (K2), N=1024 multifailure 10% drop trace (K1 at full width), and
   bench N=4096 10% drop at 700 ticks (corner 2816, K1) and 200 ticks
   (corner 896, K2), with node-ticks/s;
6. each kernel held against its plain version and timed on the input
   of a launch the main path makes (the run stopped one launch early:
   tick 699 of the 700-tick corner for K1, the last full K2 launch of
   the 200-tick corner and of the N=512 trace), then a ``kernels`` JSON
   line: per kernel its launches on the main path (phases 3-5, counters
   zeroed before each path and read after it, bench warm-ups not
   counted), its time, its plain version's time, and the least time
   the card could take (bytes over 3.35 TB/s or int32 operations over
   the card's int32 rate, whichever is larger).

Any failure raises and exits non-zero; no phase catches and continues.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
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


def time_k1(x: dict, t_remove: int, with_events: bool, reps: int) -> dict:
    """masked_max3 and tick_epilogue on one real launch input: kernel and
    plain outputs held equal, their times (ms) and bounds."""
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
    # masked_max3: reads gossip/known (1 B) + hb/ts (4 B) per cell and
    # proc, writes three i32 planes; this input's work is 3 maxima per
    # (delivery, column) pair
    mm_bytes = n * n * (1 + 1 + 4 + 4 + 12) + n
    mm_ops = 3 * nnz * n
    out["masked_max3"] = dict(
        ms=cuda_ms(lambda: masked_max3(*args, t_remove=t_remove), reps),
        plain_ms=cuda_ms(
            lambda: masked_max3_plain(*args, t_remove=t_remove), 2),
        bound=bound(mm_bytes, mm_ops))
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


# ------------------------------------------------------------- phases

def reset_counts():
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import \
        dense_mega_ticks
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import tick_epilogue
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    for fn in (masked_max3, tick_epilogue, dense_mega_ticks):
        fn.launches = 0


def read_counts() -> dict:
    from gossip_protocol_tpu_torch.ops.cuda.dense_mega import \
        dense_mega_ticks
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import tick_epilogue
    from gossip_protocol_tpu_torch.ops.merge import masked_max3
    return {"masked_max3": masked_max3.launches,
            "tick_epilogue": tick_epilogue.launches,
            "dense_mega_ticks": dense_mega_ticks.launches}


class MainPath:
    """Drives main-path runs with the launch counters zeroed just before
    each and read just after, and totals them."""

    def __init__(self):
        self.total = {"masked_max3": 0, "tick_epilogue": 0,
                      "dense_mega_ticks": 0}

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


def profile_run(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: its wall time, the
    device time of every kernel and copy, the device's idle share, and
    the ten largest entries by device time."""
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
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    if not rows:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    busy = sum(r[0] for r in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "top": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:10]]}


def read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--details", default=None,
                    help="also write every measured number to this JSON")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more run of each phase-5 "
                         "configuration (device busy share, kernels by "
                         "device time) into the details")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
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
    lib = _build.build(verbose=True)
    _build.library()
    build_s = time.perf_counter() - tb
    details["build_s"] = build_s
    say(f"phase 1: {torch.cuda.get_device_name(0)} (torch {torch.__version__},"
        f" CUDA {torch.version.cuda}); kernels built in {build_s:.1f} s "
        f"-> {os.path.relpath(lib, REPO)}")

    # ---- phase 2: kernel vs plain on the card ------------------------
    errs = {"masked_max3": 0.0, "tick_epilogue": 0.0, "dense_mega_ticks": 0.0}
    for n in (64, 1024, 2816):
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
    torch.cuda.synchronize()
    if any(v != 0 for v in errs.values()):
        raise AssertionError(f"kernel != plain version: {errs}")
    say(f"phase 2: kernels == plain versions bit for bit "
        f"(max abs err {errs})")
    details["max_abs_err_phase2"] = dict(errs)

    main_path = MainPath()
    # ---- phase 3: graded path on the card ----------------------------
    from gossip_protocol_tpu_torch.grader import grade_all
    with tempfile.TemporaryDirectory() as wd:
        res, counts = main_path.drive(
            lambda: grade_all(None, os.path.join(REPO, "testcases"), wd,
                              device="cuda"),
            ("masked_max3", "tick_epilogue"))
    if res["total"] != 90:
        raise AssertionError(f"grade {res['total']} != 90")
    say(f"phase 3: testcases on cuda graded {res['total']}/90; "
        f"launches {counts}")
    details["phase3"] = {"grade": res["total"], "launches": counts}

    # ---- phase 4: card vs CPU, byte-identical logs -------------------
    out4 = {}
    for name, kw in (("multi64", dict(single_failure=False)),
                     ("drop64", dict(single_failure=True, drop_msg=True,
                                     msg_drop_prob=0.1))):
        cfg = SimConfig(max_nnb=64, seed=3, **kw)
        with tempfile.TemporaryDirectory() as wd:
            (r_gpu, counts) = main_path.drive(
                lambda: Simulation(cfg, device="cuda").run(),
                ("dense_mega_ticks",))
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
    details["phase4"] = out4

    # ---- phase 5: full-width runs -------------------------------------
    runs = {}
    cfg512 = SimConfig(max_nnb=512, single_failure=False, seed=0)
    (r, counts) = main_path.drive(
        lambda: Simulation(cfg512, device="cuda").run(),
        ("dense_mega_ticks",))
    o = oracle_trace(r, exact_removal=True)
    runs["trace_n512_multi"] = dict(wall_s=r.wall_seconds, launches=counts,
                                    **o)
    say(f"phase 5a: N=512 multifailure trace, 700 ticks (K2): {o}; "
        f"wall {r.wall_seconds:.3f} s; launches {counts}")
    del r

    cfg1k = SimConfig(max_nnb=1024, single_failure=False, drop_msg=True,
                      msg_drop_prob=0.1, seed=0)
    (r, counts) = main_path.drive(
        lambda: Simulation(cfg1k, device="cuda").run(),
        ("masked_max3", "tick_epilogue"))
    o = oracle_trace(r, exact_removal=False)
    runs["trace_n1024_drop"] = dict(wall_s=r.wall_seconds, launches=counts,
                                    **o)
    say(f"phase 5b: N=1024 multifailure 10% drop trace, 700 ticks "
        f"(K1): {o}; wall {r.wall_seconds:.3f} s; launches {counts}")
    del r

    def bench_cfg(ticks):
        return SimConfig(max_nnb=4096, single_failure=False, drop_msg=True,
                         msg_drop_prob=0.1, seed=0, total_ticks=ticks)

    corner = {}
    for ticks, expect in ((700, ("masked_max3", "tick_epilogue")),
                          (200, ("dense_mega_ticks",))):
        sim = Simulation(bench_cfg(ticks), device="cuda")
        sim.run_bench(warmup=False)     # untimed warm-up, not counted
        (r, counts) = main_path.drive(lambda: sim.run_bench(warmup=False),
                                      expect)
        o = oracle_bench(r)
        corner[ticks] = r.counter_stream_width
        runs[f"bench_n4096_t{ticks}"] = dict(
            corner=r.counter_stream_width, wall_s=r.wall_seconds,
            node_ticks_per_s=r.node_ticks_per_second, launches=counts, **o)
        say(f"phase 5c: bench N=4096 10% drop, {ticks} ticks, corner "
            f"{r.counter_stream_width}: {r.node_ticks_per_second:.1f} "
            f"node-ticks/s (wall {r.wall_seconds:.3f} s); {o}; "
            f"launches {counts}")
        del r
    details["phase5"] = runs
    if args.profile:
        prof = {
            "trace_n512_multi": profile_run(
                lambda: Simulation(cfg512, device="cuda").run()),
            "trace_n1024_drop": profile_run(
                lambda: Simulation(cfg1k, device="cuda").run())}
        for ticks in (700, 200):
            prof[f"bench_n4096_t{ticks}"] = profile_run(
                lambda: Simulation(bench_cfg(ticks), device="cuda")
                .run_bench(warmup=False))
        details["profile"] = prof
        say("phase 5d: profiled; device idle share " + json.dumps(
            {k: v.get("idle_share") for k, v in prof.items()}))
    details["main_path_launches"] = main_path.total

    # ---- phase 6: kernel times on real launch inputs ------------------
    # Each kernel is timed, and held against its plain version, on the
    # input of a launch the main path makes: the run is stopped one
    # launch early and the next launch's input is built as the run
    # builds it.
    timing = {
        "k1": time_k1(k1_launch_input(bench_cfg(700), corner[700], dev),
                      bench_cfg(700).t_remove, with_events=False, reps=10)}
    x, s = k2_launch_input(bench_cfg(200), corner[200], dev)
    timing["k2"] = time_k2(x, s, bench_cfg(200), with_events=False, reps=10)
    x, s = k2_launch_input(cfg512, cfg512.n, dev)
    timing["k2_trace512"] = time_k2(x, s, cfg512, with_events=True, reps=10)
    del x
    errs["masked_max3"] = max(errs["masked_max3"],
                              timing["k1"]["max_abs_err"]["masked_max3"])
    errs["tick_epilogue"] = max(errs["tick_epilogue"],
                                timing["k1"]["max_abs_err"]["tick_epilogue"])
    errs["dense_mega_ticks"] = max(errs["dense_mega_ticks"],
                                   timing["k2"]["max_abs_err"],
                                   timing["k2_trace512"]["max_abs_err"])
    details["timing"] = timing
    details["max_abs_err"] = errs
    src = "gossip_protocol_tpu_torch/csrc/dense_tick.cu"
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
                            "s_ticks": timing["k2"]["s_ticks"]})):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_path.total[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None, "shape": shape})
    say(f"phase 6: timed {len(kernels)} kernels on real launch inputs; "
        f"details {json.dumps(timing)}")
    say(json.dumps({"kernels": kernels}))
    details["kernels"] = kernels

    details["seconds"] = time.perf_counter() - t_start
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1, default=str)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (gossip_protocol_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``gossip_protocol_tpu_torch/csrc/`` (one
nvcc per source, in parallel), holds each kernel against its plain
PyTorch version on the card, drives the port's dense and overlay main
paths at full width, checks the results, times every kernel, and prints
one line per phase:

1. the card (``nvidia-smi`` name and power limit), the kernel build, and
   the native C++ engine (``libgossip_native.so``, built with ``make``
   through ``compat/native.py require``; a failed build fails the run);
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
   full width and embedded at 3/4 of it, and with the worlds' inputs
   (the asym world's per-link thresholds, partition groups, both) at
   N in {10, 64, 1024, 4096}: S=8 launches in which the drop window and
   the partition are each open and closed in all four combinations, and
   S=1 launches with the window open, or closed and the partition open;
   the fleet's lane axis: ``masked_max3`` and ``tick_epilogue`` as one
   launch each for B lanes at (B, N) = (3, 10), (4, 64), (8, 512) and
   (4, 2816), each lane the real input of its own seed at its own tick
   (one lane at tick 0, with no sender in flight), and the lane-axis
   draw (``drop_masks_lanes``) at B=3 N=10 with one lane's window open,
   B=4 N=896 embedded at 672, B=2 N=4096 with per-link thresholds and
   with partition groups;
3. the graded path: the three N=10 testcases on ``cuda``, each timed,
   must grade 90;
4. card vs CPU: N=64 multifailure and N=64 drop, 700 ticks — the
   ``dbg.log`` and ``msgcount.log`` bytes of a ``cuda`` run must equal
   those of the port's own ``cpu`` run; overlay N=64 churn (200 ticks)
   and N=128 drop (120 ticks) through ``OverlaySimulation``: final state
   and every metric equal on ``cuda`` and ``cpu``; then every family of
   the scenario catalog (``models/scenarios.py``, 15 dense and 10
   overlay, seed 1000, catalog size) on ``cuda`` and ``cpu``: final
   state, events or metrics, lane digest and oracle verdict (a pass)
   equal, dense ``dbg.log`` and ``msgcount.log`` bytes too, each run on
   its route (the draw and the K1 pair, K2 for the wave, ``masked_max3``
   on the zombie / byz / latency route, no K3/K4/K5 on the overlay);
   4b. ``cuda`` runs against engines that are neither the JAX package
   nor the port's tick (``testing/checks.py``, the rules of the JAX
   package's own parity tests): the message-level dense oracle
   (``testing/oracle.py``, dropsync's masks under drop) on the three
   testcases, a churn N=32, a drop N=48 and two world (partition, flap)
   N=24 runs; the overlay oracle on N=64 churn and N=128 drop; the
   native engine's join / removal event sets (N=10 single and multi,
   N=24 start-after-fail, N=16 churn with rejoin 10 and 25);
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
   the worlds at full width (5g): ``asym4096``, BASELINE's dense N=4096
   10% drop bench with per-link drop (700 ticks, no corner: the K1 pair
   and the threshold draw at N=4096), and every dense family at N=1024
   in trace mode (``dense_wave`` at 512, through K2), each graded by its
   family's oracle; the overlay families at N=4096 and
   ``overlay_asym_drop`` and ``overlay_partition_heal`` at N=65,536 with
   BASELINE's 65k join ramp (5h), each graded by its oracle and the
   overlay validation, none launching K3, K4 or K5; each with its
   node-ticks/s (a family the JAX package itself fails at that width is
   left out, ``WIDE_LEFT_OUT``); the fleets (5i, ``core/fleet.py``), each
   lane held equal to its solo ``cuda`` run on every state field,
   counter and event or metric, with the fleet's wall, aggregate
   node-ticks/s and the solo walls' sum: ``grade_all_fleet`` (B=3, grade
   90, one draw, merge and epilogue launch a tick), BASELINE's N=4096
   10% drop bench at B=4 (seeds 0-3, corner 2816, its device idle share
   from one more profiled run), the same launch deferred, started and
   polled under ``set_sync_debug_mode("error")``, the N=512
   multifailure trace at B=8 (removals at t=121/122) and again with
   ``n_real=6``, BASELINE's overlay N=65,536 20% churn
   (``bench_overlay_fleet``) and N=4096 drop at B=8 (seeds 101-108, 38
   K5 calls each, ``validate_overlay`` on every lane, the 65,536 fleet's
   idle share profiled), the B=8 N=512 trace and N=65,536 fleets cut at
   a legal segment tick into two legs and finished with ``finish_lane``,
   and ``dense_zombie`` at N=1024, B=4 (its lanes through the counted
   composable lane loop, each graded by its family's oracle);
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
   S=8); the threshold draw and the K1 pair at N=4096 on the ``asym4096``
   run's ticks 300 and 699, in rows of their own; the lane-axis kernels
   in ``/fleet`` rows: the merge and the epilogue at tick 699 and the
   draw at tick 300 of the B=4 N=4096 bench fleet, K5 on the last full
   call of the B=8 N=65,536 fleet, each bound B times the per-lane one,
   the data-dependent terms summed over the lanes), then a ``kernels``
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
   and both bounds;
7. the fleet service (``service/``, ``store/``), after phase 6's timing
   and before its kernels line, every path driven as a main path:
   7a ``grade_all_service`` on ``cuda`` (90); 7b the acceptance replay
   (``grader_templates() + overlay_templates(n=512, ticks=96)``, its
   first 17 of 34 seeds, 102 requests, ``max_batch=8``) with per-request parity
   against the sequential ``solo_execute`` leg, requests/s, aggregate
   against sequential node-ticks/s, occupancy, p50/p99 latency and the
   pack / device-wait / fetch split; 7c full-width serving (4 seeds of
   the dense N=4096 10% drop bench, 8 of the overlay N=65,536 churn run,
   2 of the N=2^20 power-law run, interleaved, ``pad_policy="pow2"``):
   three buckets, every digest equal to its solo ``cuda`` run, the dense
   bucket on the K1 lane axis with 700 lane draws and the overlay ones
   on K5's lane axis (55 calls, no K3), with the wall, aggregate
   node-ticks/s, the solo walls' sum and (``--profile``) the idle
   share; 7d a canonical bucket at width (``canonicalize=True``: asym
   drop at real N=1000 in rung 1024, B=4; partition with 10% drop at
   real N=900, B=2; 300-tick traces), every lane equal to its exact solo
   run, and the corner draw (``drop_masks_lanes`` at N=1024, na=1000,
   thresholds) held against its plain version and timed; 7e
   ``chaos_replay`` of 7b's stream at fault rate 0.12, seed 0, twice (every request
   terminal, parity, equal digests, every failure injected); 7f
   ``kill_restart_replay`` (34 seeds, the doomed child on ``cuda``) at
   one kill point; 7g the scenario ``sweep`` (``--sweep-seeds``,
   default 2: 50 variants, a dispatch carrying a family's seeds) and
   its rerun in a second process started before 7f (all oracles green,
   equal digests).  7a-d and 7g must end with zero retries, degraded
   requests and breaker opens;
8. multi-device execution on a mesh of one process, every entry
   ``cuda:0`` (P shards take turns on the card; their walls are not a
   multi-card speed): 8a the rectangular ``masked_max3`` at (R, S, C) =
   1024x1024x4096, 512x512x4096, 128x128x1024 and 5x5x10, each also with
   a B=2 lane axis, and K3's sharded contract (``masks_local``,
   ``row_start``, the round planes) on every shard of the real tick-136
   state of the N=2^20 power-law run over 4 shards and of tick 300 of the
   N=65,536 churn run over 8, each equal to its plain version and to the
   single-device kernel's rows; 8b ``make_sharded_run`` over 4 entries:
   the N=4096 10% drop bench (700 ticks, final state and counters equal
   to the single-device K1 route; the last ring-step merge timed), the
   N=1024 10% drop trace (every event mask equal, the dense oracle) and
   the three testcases over 2 entries; 8c ``make_sharded_overlay_run``
   (per-tick K3, sharded contract): N=2^20 power-law over 4 entries and
   N=65,536 churn over 8, equal to the single-device runs and validated
   as bench.py validates; 8d ``MeshFleetSimulation``: the B=4 N=4096
   bench on 2 lane entries launched under ``set_sync_debug_mode("error")``,
   the B=8 N=65,536 churn fleet on 2 lane entries and a B=4 N=1024 trace
   on a 2x2 lanes x peers mesh, every lane equal to its solo run; 8e
   the first 8 seeds of 7b's replay served from a 2-entry lane mesh
   (parity with 7b's sequential leg), ``elastic_replay`` on 4 entries
   (one loss, one return; its gate) and ``load_openloop_bench(smoke=True)``
   with its lane-mesh point, run in a second process started when
   phase 8 starts; 8f the overlay worlds peer-sharded at full width
   (5h's two N=65,536 runs over 4 entries, its N=4096 runs over 2), each
   equal to its single-device run in every state field and metric and
   passing its family oracle and the overlay validation, with its wall
   and node-ticks/s.  The kernels line gains the ``masked_max3/rect``
   and ``fused_overlay_tick/sharded`` rows.
9. the port's analysis (``gossip_protocol_tpu_torch/analysis/``) on the
   card: the source pass over the tree, the runtime pass's registered
   runs on ``cuda`` (the solo tick loops under
   ``set_sync_debug_mode("error")``) and the guard pass (a warmed fleet
   lap builds no run and starts no nvcc; a launched fleet's wait and
   resolve under the sync-debug mode "error"); any finding fails the run.

``--serving-only`` runs phase 1 and phase 7 alone; ``--mesh-only``
phase 1, phase 8 and phase 9 (8e's replay then serves 8 seeds a
template with a sequential leg of its own, 8f runs its single-device
runs itself).
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


#: seconds since the start of the run at each phase's end (``mark``)
PHASE_SECONDS: dict = {}


def mark(phase: str, t_start: float) -> None:
    """Record and print the seconds since ``t_start`` at a phase's end."""
    PHASE_SECONDS[phase] = round(time.perf_counter() - t_start, 1)
    say(f"elapsed after phase {phase}: {PHASE_SECONDS[phase]} s")


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
    masks (the asym world's thresholds included) and vector decisions,
    as ``make_tick`` builds them."""
    from gossip_protocol_tpu_torch.core.tick import make_tick_run
    from gossip_protocol_tpu_torch.ops.drop import tick_drop_masks
    from gossip_protocol_tpu_torch.ops.vector import vector_step
    t = cfg.total_ticks - 1
    st, sched = corner_start(cfg, a, dev)
    st, _ = make_tick_run(cfg.replace(max_nnb=a, total_ticks=t),
                          with_events=False)(st, sched)
    gdrop, qdrop, pdrop = tick_drop_masks(
        st.rng, t, a, sched.drop_on(t), sched.drop_prob, dev,
        link_prob=sched.link_prob if cfg.asym_drop else None)
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


#: the catalog seed every world run of the script uses
WORLD_SEED = 1000
#: phase 5g's dense families and their widths: N=1024, except the wave
#: at N=512 (inside K2's trace envelope, so it takes the K2 route)
DENSE_WIDE = 1024
DENSE_WAVE_WIDE = 512
#: phase 5h's overlay runs: every family at N=4096, and these two at
#: N=65,536 with BASELINE's 65k join ramp (bench.py:345-349)
OVERLAY_WIDE = 4096
OVERLAY_65K = ("overlay_asym_drop", "overlay_partition_heal")
#: families left out of phases 5g / 5h: the JAX package's own verdict at
#: that width is not a pass (PERF.md says why)
WIDE_LEFT_OUT = {
    ("overlay_flapping", 4096): "the family oracle fails in the JAX "
    "package: live members uncovered for 79 consecutive ticks",
    ("overlay_composed_gauntlet", 4096): "validate_overlay fails in the "
    "JAX package: a victim slot and entry left, 4091 of 4096 in the group",
}
#: runs whose world drops join traffic inside the join ramp, in the JAX
#: package too (the reference sends each JOINREQ once): validate_overlay's
#: join clause does not apply; its purge and re-cover clauses do
JOINS_LOST = (("overlay_asym_drop", 65536), ("overlay_partition_heal", 65536))


def wide_family_cfg(name: str, n: int):
    """A catalog family's config (seed ``WORLD_SEED``) at width ``n``,
    its other knobs kept.  The start ramp keeps its length in ticks (the
    builder's ``step_rate`` scaled by N_catalog / n), so every window of
    the family meets the group it met at catalog size; at N=65,536 the
    ramp is BASELINE's 65k one, 64 / 65,536."""
    from gossip_protocol_tpu_torch.models.scenarios import CATALOG
    cfg = CATALOG[name].build(WORLD_SEED)
    step = 64.0 / 65536 if n == 65536 else cfg.step_rate * cfg.n / n
    return cfg.replace(max_nnb=n, step_rate=step)


def wide_runs() -> list:
    """(family, N) of phases 5g and 5h, before the left-out ones go."""
    from gossip_protocol_tpu_torch.models.scenarios import CATALOG
    runs = [(name, DENSE_WAVE_WIDE if name == "dense_wave" else DENSE_WIDE)
            for name in sorted(CATALOG) if name.startswith("dense")]
    runs += [(name, OVERLAY_WIDE) for name in sorted(CATALOG)
             if name.startswith("overlay")]
    return runs + [(name, 65536) for name in OVERLAY_65K]


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
    """K5's least time for one call: :func:`k5_work` over the card's
    rates."""
    return bound(*k5_work(n, k, met, reslots, needed))


def k5_work(n: int, k: int, met, reslots: int,
            needed: bool = False) -> tuple[float, float]:
    """The bytes and operations of one K5 call.  Bytes: where the plane's
    two phases (N rows of 128 words each) fit on chip (:data:`ON_CHIP_BYTES`), as at
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
    return nbytes, ops


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


def validate_overlay(res, join_complete: bool = True) -> dict:
    """bench.py's validation of an overlay run (bench.py:365-381 and
    _check_recover :255-316): every peer in the group at the end, no
    victim slot and no victim entry left, and every member uncovered at
    the end covered again within SLOT_EPOCH + 1 continuation ticks.
    ``join_complete=False`` leaves out the first clause, for a world
    whose drop or partition window covers the join ramp (the reference
    sends each JOINREQ once, so a lost join stays lost)."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import make_overlay_run
    from gossip_protocol_tpu_torch.ops.overlay_rules import (
        SLOT_EPOCH, covered_histogram)
    cfg, m = res.cfg, res.metrics
    if join_complete and int(m.in_group[-1]) != cfg.n:
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


# ------------------------------------------- fleets and independent engines

@contextlib.contextmanager
def capture_calls(module, name: str, keep=None):
    """Record the ``(args, kwargs)`` of the calls of ``module.name`` for
    which ``keep(args, kwargs)`` holds (all without ``keep``), the
    function still running; restored on exit."""
    orig = getattr(module, name)
    seen = []

    def spy(*a, **k):
        if keep is None or keep(a, k):
            seen.append((a, k))
        return orig(*a, **k)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def lane_k1_inputs(n: int, lanes, dev) -> dict:
    """Real K1 launch inputs of B lanes at width ``n``: lane b is tick
    ``t_b`` of the 10% drop multifailure run with seed ``s_b`` on the
    per-tick route, captured where the tick calls the epilogue; a lane at
    tick 0 has no sender in flight.  ``lanes`` holds the (seed, tick)
    pairs; the shared clock of the lane-axis launch is the largest tick."""
    import torch

    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core import tick as tick_mod
    from gossip_protocol_tpu_torch.state import init_state, make_schedule
    per_lane = []
    for seed, t in lanes:
        cfg = SimConfig(max_nnb=n, single_failure=False, drop_msg=True,
                        msg_drop_prob=0.1, seed=seed, total_ticks=700)
        tick = tick_mod.make_tick(cfg)
        st, sc = init_state(cfg, dev), make_schedule(cfg, dev)
        for _ in range(t):
            st, _ = tick(st, sc)
        with capture_calls(tick_mod, "tick_epilogue") as seen:
            tick(st, sc)
        per_lane.append(seen[0][0])
    names = ("gossip", "proc", "known", "hb", "ts", "gdrop", "ops", "jrep",
             "jreq", "live_hold")
    x = {k: torch.stack([a[3 + i] for a in per_lane]).contiguous()
         for i, k in enumerate(names)}
    x["t"] = max(t for _, t in lanes)
    x["lanes"] = [{"seed": s, "tick": t} for s, t in lanes]
    return x


def compare_lane_k1(x: dict, t_remove: int) -> dict:
    """The lane-axis ``masked_max3`` and ``tick_epilogue`` (one launch
    each) against their plain versions, the epilogue with and without
    events; returns max abs errors and each lane's deliveries."""
    import torch

    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_lanes_plain)
    from gossip_protocol_tpu_torch.ops.merge import (
        masked_max3, masked_max3_lanes_plain)
    args = (x["gossip"], x["proc"], x["known"], x["hb"], x["ts"], x["t"])
    before = masked_max3.launches
    m = masked_max3(*args, t_remove=t_remove)
    if masked_max3.launches != before + 1:
        raise AssertionError("lane-axis masked_max3 was not one launch")
    want = masked_max3_lanes_plain(*args, t_remove=t_remove)
    err = {"masked_max3": max(max_abs_err(a, b) for a, b in zip(m, want)),
           "tick_epilogue": 0.0}
    for ev in (True, False):
        e_args = (*m, x["gossip"], x["proc"], x["known"], x["hb"], x["ts"],
                  x["gdrop"], x["ops"], x["jrep"], x["jreq"], x["live_hold"],
                  x["t"])
        before = tick_epilogue.launches
        got = tick_epilogue(*e_args, t_remove=t_remove, with_events=ev)
        if tick_epilogue.launches != before + 1:
            raise AssertionError("lane-axis tick_epilogue was not one launch")
        want = tick_epilogue_lanes_plain(*e_args, t_remove=t_remove,
                                         with_events=ev)
        err["tick_epilogue"] = max(
            err["tick_epilogue"],
            max(max_abs_err(a, b) for a, b in zip(got, want)
                if a is not None))
    torch.cuda.synchronize()
    deliveries = (x["gossip"] & x["proc"][:, None, :]).sum((1, 2))
    return {"err": err, "deliveries": deliveries.tolist()}


#: phase 2's lane-axis K1 shapes: (B, N) and each lane's (seed, tick)
LANE_K1_CASES = (
    (3, 10, ((0, 0), (1, 30), (2, 400))),
    (4, 64, ((3, 0), (4, 12), (5, 150), (6, 650))),
    (8, 512, tuple(zip(range(7, 15), (0, 5, 40, 121, 122, 200, 400, 699)))),
    (4, 2816, ((15, 0), (16, 100), (17, 300), (18, 699))))


def lane_draw_checks(dev) -> tuple[float, int]:
    """Phase 2's lane-axis draws against their plain version: B=3 N=10
    with one lane's window open, B=4 N=896 embedded at 672 with a
    probability a lane, B=2 N=4096 with per-link thresholds and with
    partition groups (lane 1's partition open, lane 0's closed), at a
    tick with the windows open and one past them."""
    import torch

    from gossip_protocol_tpu_torch.ops.drop import (
        LaneDrop, drop_masks_lanes, drop_masks_lanes_plain)
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    err, checked = 0.0, 0
    for b, n, na, world in ((3, 10, 10, None), (4, 896, 672, None),
                            (2, 4096, 4096, "thresholds"),
                            (2, 4096, 4096, "groups")):
        rng = np.random.default_rng(b * n + len(world or ""))
        active = np.zeros((b, 400), bool)
        active[:, 50:300] = True
        if n == 10:
            active[:2] = False
        part = link = group = None
        if world == "thresholds":
            link = torch.from_numpy(
                rng.random((b, n, n), np.float32) * 0.3).to(dev)
        if world == "groups":
            group = torch.from_numpy(rng.integers(
                0, 3, (b, n), dtype=np.int32)).to(dev)
            part = np.zeros((b, 400), bool)
            part[1, 100:350] = True
        plan = LaneDrop(np.stack([prng_key(n + i) for i in range(b)]),
                        np.float32([0.1, 0.2, 0.3, 0.4][:b]), active, part)
        for t in (120, 320):
            before = drop_masks_lanes.launches
            got = drop_masks_lanes(plan, t, n, na, dev, link, group)
            if drop_masks_lanes.launches != before + 1:
                raise AssertionError("lane-axis draw was not one launch")
            want = drop_masks_lanes_plain(plan, t, n, na, dev, link, group)
            err = max(err, max(max_abs_err(a, c) for a, c in zip(got, want)))
            if n == 10 and t == 120 and (got[0][:2].any()
                                         or not got[0][2].any()):
                raise AssertionError("B=3 draw: closed lanes drew or the "
                                     "open lane did not")
            checked += 1
    torch.cuda.synchronize()
    return err, checked


def independent_engines(main_path) -> dict:
    """Phase 4b: ``cuda`` runs held against engines that are neither the
    JAX package nor the port's tick: the dense message-level oracle
    (``testing/oracle.py``, with dropsync's masks), the overlay oracle
    (``testing/overlay_oracle.py``) and the native C++ engine built in
    phase 1 (``compat/native.py``), by the rules of the JAX package's own
    tests (``testing/checks.py``)."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.sim import Simulation
    from gossip_protocol_tpu_torch.grader import SCENARIOS
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    from gossip_protocol_tpu_torch.testing import checks
    out = {}

    def drive(fn):
        res, counts = main_path.drive(fn, ())
        if not any(counts.values()):
            raise AssertionError("phase 4b run launched no kernel")
        return res, {k: v for k, v in counts.items() if v}

    dense = {s: SimConfig.from_conf(os.path.join(REPO, "testcases",
                                                 f"{s}.conf"))
             for s in SCENARIOS}
    dense.update({
        "churn_n32": SimConfig(max_nnb=32, single_failure=True, seed=4,
                               total_ticks=200, fail_tick=60,
                               rejoin_after=25),
        "drop_n48": SimConfig(max_nnb=48, single_failure=False,
                              drop_msg=True, msg_drop_prob=0.1, seed=5,
                              total_ticks=200, fail_tick=60,
                              drop_open_tick=20, drop_close_tick=150),
        "partition_n24": SimConfig(max_nnb=24, single_failure=True, seed=2,
                                   total_ticks=120, fail_tick=40,
                                   partition_groups=2,
                                   partition_open_tick=30,
                                   partition_close_tick=70),
        "flap_n24": SimConfig(max_nnb=24, single_failure=True, seed=2,
                              total_ticks=120, fail_tick=10_000,
                              flap_rate=0.4, flap_period=24, flap_down=6)})
    for name, cfg in dense.items():
        r, counts = drive(lambda: Simulation(cfg, device="cuda").run())
        out[name] = dict(checks.check_dense_oracle(r), launches=counts)
    for name in ("churn64", "drop128"):
        cfg = overlay_cfg(name)
        r, counts = drive(lambda: OverlaySimulation(cfg, device="cuda").run())
        out[f"overlay_{name}"] = dict(checks.check_overlay_oracle(r),
                                      launches=counts)
    for case in checks.NATIVE_CASES:
        o, counts = drive(lambda: checks.check_native_case(case, "cuda"))
        out[f"native_{case[0]}"] = dict(o, launches=counts)
    say("phase 4b: cuda runs == independent engines: the dense oracle "
        "(three testcases, churn N=32, drop N=48, partition and flap "
        "N=24), the overlay oracle (N=64 churn, N=128 drop), the native "
        "engine's event sets (N=10 single and multi, N=24 start-after-"
        f"fail, N=16 churn rejoin 10 and 25) {json.dumps(out)}")
    return out


def dense_lane_diff(a, b, bench: bool = False) -> list:
    """Fields of two dense results that differ."""
    import torch
    bad = [f for f in ("sent", "recv") + (() if bench else
                                          ("added", "removed"))
           if not np.array_equal(getattr(a, f), getattr(b, f))]
    bad += [f for f in ("in_group", "own_hb", "known", "hb", "ts", "gossip",
                        "gossip_age", "joinreq", "joinrep")
            if not torch.equal(getattr(a.final_state, f).cpu(),
                               getattr(b.final_state, f).cpu())]
    if int(a.final_state.tick) != int(b.final_state.tick):
        bad.append("tick")
    return bad


def victim_removal_ticks(res) -> dict:
    """{tick: removals} of the victims by the live members of a trace
    run."""
    from gossip_protocol_tpu_torch.state import NEVER
    victims = res.fail_tick != NEVER
    members = ~victims & res.final_state.in_group.cpu().numpy()
    per_tick = res.removed[:, members][:, :, victims].sum((1, 2))
    return {int(t): int(c) for t, c in enumerate(per_tick) if c}


#: the dense fleet's lane-axis kernels (one launch a tick for the fleet)
FLEET_K1 = ("drop_masks_lanes", "masked_max3", "tick_epilogue")


def fleet_runs(main_path) -> dict:
    """Phase 5i: fleets at full width, every lane held equal to the port's
    solo ``cuda`` run of its config on every state field, counter and
    event or metric; each line gives the route's launches, the fleet's
    wall and aggregate node-ticks/s, and the sum of the solo walls."""
    import torch

    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.core.sim import Simulation
    from gossip_protocol_tpu_torch.core.tick import composable_lanes
    from gossip_protocol_tpu_torch.grader import SCENARIOS, grade_all_fleet
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    from gossip_protocol_tpu_torch.models.scenarios import (CATALOG,
                                                            grade_config)
    from gossip_protocol_tpu_torch.models.segments import checkpoint_ticks
    out = {}
    lane_axis = dict.fromkeys(FLEET_K1 + ("grid_overlay_ticks",), 0)

    def drive(fn, expect, axis=True):
        res, counts = main_path.drive(fn, expect)
        if axis:
            for k in lane_axis:
                lane_axis[k] += counts[k]
        return res, {k: v for k, v in counts.items() if v}

    def line(key, fr, counts, solo_walls, extra=""):
        out[key] = dict(batch=fr.batch, wall_s=fr.wall_seconds,
                        pack_s=fr.pack_seconds, device_s=fr.device_seconds,
                        fetch_s=fr.fetch_seconds,
                        aggregate_node_ticks_per_s=(
                            fr.aggregate_node_ticks_per_second),
                        solo_walls_sum_s=sum(solo_walls), launches=counts,
                        **out.get(key, {}))
        say(f"phase 5i: {key}: B={fr.batch}, wall {fr.wall_seconds:.3f} s "
            f"(pack {fr.pack_seconds:.3f}, device {fr.device_seconds:.3f}, "
            f"fetch {fr.fetch_seconds:.3f}), "
            f"{fr.aggregate_node_ticks_per_second:.1f} node-ticks/s "
            f"aggregate; solo walls sum {sum(solo_walls):.3f} s; "
            f"launches {counts}{extra}")

    def same(key, fr, solos, bench=False, skip=()):
        for i, solo in enumerate(solos):
            if hasattr(solo, "metrics"):
                bad = overlay_equal(fr.lanes[i].final_state,
                                    solo.final_state, fr.lanes[i].metrics,
                                    solo.metrics, skip=skip)
            else:
                bad = dense_lane_diff(fr.lanes[i], solo, bench)
            if bad:
                raise AssertionError(f"{key}: lane {i} != its solo run in "
                                     f"{bad}")

    def one_each(ticks):
        return {k: ticks for k in FLEET_K1}

    # the grader's B=3 fleet: one draw, merge and epilogue a tick
    cfgs = [SimConfig.from_conf(os.path.join(REPO, "testcases", f"{s}.conf"))
            for s in SCENARIOS]
    with tempfile.TemporaryDirectory() as wd:
        res, counts = drive(lambda: grade_all_fleet(
            os.path.join(REPO, "testcases"), wd, "cuda"), FLEET_K1)
    if res["total"] != 90:
        raise AssertionError(f"fleet grade {res['total']} != 90")
    if {k: counts.get(k) for k in FLEET_K1} != one_each(cfgs[0].total_ticks):
        raise AssertionError(f"grader fleet launches {counts}")
    fr = FleetSimulation(cfgs[0], device="cuda").run(configs=cfgs)
    solos = [Simulation(c, device="cuda").run() for c in cfgs]
    same("grader_b3", fr, solos)
    out["grader_b3"] = {"grade": res["total"]}
    line("grader_b3", fr, counts, [r.wall_seconds for r in solos])

    # BASELINE's dense N=4096 10% drop bench, B=4 seeds, corner 2816
    cfg = bench_cfg(700)
    sim = FleetSimulation(cfg, device="cuda")
    sim.run_bench(seeds=range(4), warmup=False)    # untimed, not counted
    fr, counts = drive(lambda: sim.run_bench(seeds=range(4), warmup=False),
                       FLEET_K1)
    if {k: counts.get(k) for k in FLEET_K1} != one_each(cfg.total_ticks):
        raise AssertionError(f"bench fleet launches {counts}")
    solos = [Simulation(cfg.replace(seed=s), device="cuda").run_bench(
        warmup=False) for s in range(4)]
    same("bench_n4096_b4", fr, solos, bench=True)
    for lane in fr.lanes:
        oracle_bench(lane)
    bench_fr = fr
    prof = profile_run(lambda: sim.run_bench(seeds=range(4), warmup=False))
    out["bench_n4096_b4"] = {
        "corner": fr.lanes[0].counter_stream_width,
        "solo_node_ticks_per_s": [r.node_ticks_per_second for r in solos],
        "idle_share": prof.get("idle_share"), "profile": prof}
    line("bench_n4096_b4", fr, counts, [r.wall_seconds for r in solos],
         f"; device idle {prof.get('idle_share')} (profiled run)")
    # the same launch, deferred, started and polled under the sync-debug
    # mode "error": nothing may synchronize the device before resolve
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = sim.launch_bench(seeds=range(4), warmup=False, defer=True)
        if pending.started:
            raise AssertionError("a deferred launch started")
        pending.start()
        polls = 0
        while not pending.is_ready():
            polls += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same("pending_b4", pending.resolve(), bench_fr.lanes, bench=True)
    out["pending_b4"] = {"polls_before_ready": polls}
    say(f"phase 5i: PendingFleet: launch(defer=True), start, is_ready "
        f"polled {polls} times under set_sync_debug_mode('error'), then "
        "resolve: lanes equal the bench fleet's")
    del sim, fr, bench_fr, solos

    # BASELINE's intermediate N=512 multifailure trace, B=8 seeds
    cfg = trace_cfgs()["trace_n512_multi"]
    fr, counts = drive(lambda: FleetSimulation(cfg, device="cuda").run(
        seeds=range(8)), FLEET_K1)
    solos = [Simulation(cfg.replace(seed=s), device="cuda").run()
             for s in range(8)]
    same("trace_n512_b8", fr, solos)
    # each lane removes its victims when its solo run does (equal above);
    # seed 0's at t=121/122 exactly (phase 5a)
    for lane in fr.lanes:
        oracle_trace(lane, exact_removal=False)
    rm = [victim_removal_ticks(lane) for lane in fr.lanes]
    out["trace_n512_b8"] = {"victim_removal_ticks": rm}
    line("trace_n512_b8", fr, counts, [r.wall_seconds for r in solos],
         f"; victim removals by tick per lane {rm}")
    fr6, counts6 = drive(lambda: FleetSimulation(cfg, device="cuda").run(
        seeds=range(8), n_real=6), FLEET_K1)
    if fr6.batch != 6 or fr6.padded_batch != 8:
        raise AssertionError("n_real=6 did not unstack 6 of 8 lanes")
    same("trace_n512_b8_nreal6", fr6, fr.lanes[:6])
    out["trace_n512_b8_nreal6"] = {"lanes": fr6.batch,
                                   "padded_batch": fr6.padded_batch,
                                   "occupancy": fr6.occupancy}
    line("trace_n512_b8_nreal6", fr6, counts6, [])
    trace_fr = fr
    del fr6, solos

    # BASELINE's overlay churn N=65,536 (bench.py:384 bench_overlay_fleet)
    # and drop N=4096, B=8 seeds 101-108, on K5's lane axis
    ofr = {}
    for name in ("churn65k", "drop4096"):
        cfg = overlay_cfg(name)
        seeds = range(101, 109)
        fr, counts = drive(lambda: FleetSimulation(cfg, device="cuda").run(
            seeds=seeds, warmup=False), ("grid_overlay_ticks",))
        if counts.get("grid_overlay_ticks") != 38 or \
                counts.get("fused_overlay_tick"):
            raise AssertionError(f"overlay fleet {name} launches {counts}")
        solos = [OverlaySimulation(cfg.replace(seed=s), device="cuda").run()
                 for s in seeds]
        same(f"overlay_{name}_b8", fr, solos)
        val = [validate_overlay(lane) for lane in fr.lanes]
        out[f"overlay_{name}_b8"] = {"validate": val}
        extra = ""
        if name == "churn65k":
            prof = profile_run(lambda: FleetSimulation(cfg, device="cuda")
                               .run(seeds=seeds, warmup=False))
            out["overlay_churn65k_b8"].update(
                idle_share=prof.get("idle_share"), profile=prof)
            extra = f"; device idle {prof.get('idle_share')} (profiled run)"
        line(f"overlay_{name}_b8", fr, counts,
             [r.wall_seconds for r in solos],
             f"; validate_overlay passed on every lane{extra}")
        ofr[name] = fr
        del solos

    # legs: each run cut at a legal segment tick and finished
    for key, cfg, seeds, mono, expect in (
            ("legs_trace_n512_b8", trace_cfgs()["trace_n512_multi"],
             range(8), trace_fr, FLEET_K1),
            ("legs_overlay_churn65k_b8", overlay_cfg("churn65k"),
             range(101, 109), ofr["churn65k"], ("grid_overlay_ticks",))):
        cuts = checkpoint_ticks(cfg)
        cut = cuts[len(cuts) // 2]
        sim = FleetSimulation(cfg, device="cuda")
        leg, counts = drive(lambda: sim.run_leg(resume=sim.run_leg(
            seeds=seeds, ticks=cut).checkpoints), expect)
        if not leg.done:
            raise AssertionError(f"{key}: the second leg did not finish")
        same(key, leg.results(), mono.lanes)
        out[key] = {"cut": cut, "digests": [ck.digest()
                                            for ck in leg.checkpoints]}
        say(f"phase 5i: {key}: cut at t={cut}, resumed and finished with "
            f"finish_lane: every lane == the monolithic fleet's; launches "
            f"{counts}")
    del trace_fr, ofr

    # a composable world: its lanes one at a time inside the fleet tick
    base = wide_family_cfg("dense_zombie", DENSE_WIDE)
    zcfgs = [base.replace(seed=WORLD_SEED + b) for b in range(4)]
    before = composable_lanes.calls
    fr, counts = drive(lambda: FleetSimulation(base, device="cuda").run(
        configs=zcfgs), ("drop_masks_lanes", "masked_max3"), axis=False)
    calls = composable_lanes.calls - before
    if calls != 4 * base.total_ticks or counts.get("tick_epilogue") \
            or counts.get("drop_masks_lanes") != base.total_ticks:
        raise AssertionError(f"zombie fleet route: {calls} lane calls, "
                             f"launches {counts}")
    lane_axis["drop_masks_lanes"] += counts["drop_masks_lanes"]
    for c, lane in zip(zcfgs, fr.lanes):
        verdict = grade_config(CATALOG["dense_zombie"], c, lane)
        if verdict:
            raise AssertionError(f"zombie fleet lane seed {c.seed}: "
                                 f"{verdict[:3]}")
    solos = [Simulation(c, device="cuda").run() for c in zcfgs]
    same("zombie_n1024_b4", fr, solos)
    out["zombie_n1024_b4"] = {"composable_lane_calls": calls}
    line("zombie_n1024_b4", fr, counts, [r.wall_seconds for r in solos],
         f"; composable lane calls {calls}; family oracle passed on every "
         "lane")
    out["lane_axis_launches"] = lane_axis
    return out


def fleet_timing(dev) -> dict:
    """Phase 6's lane-axis kernels on the inputs of launches the fleets
    make: ``masked_max3`` and ``tick_epilogue`` at tick 699 and the draw
    at tick 300 of the B=4 N=4096 bench fleet (corner 2816), K5 on the
    last full call (tick 592) of the B=8 N=65,536 churn fleet; each held
    against its plain version and timed, with B times the per-lane bound
    of the same formula (the merge's and K5's data-dependent terms summed
    over the lanes)."""
    import torch

    from gossip_protocol_tpu_torch.core import tick as tick_mod
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.models import overlay_grid as og
    from gossip_protocol_tpu_torch.models.overlay import resolved_dims
    from gossip_protocol_tpu_torch.ops.cuda import overlay_grid as ogk
    from gossip_protocol_tpu_torch.ops.cuda.tickfused import (
        tick_epilogue, tick_epilogue_lanes_plain)
    from gossip_protocol_tpu_torch.ops.drop import (drop_masks_lanes,
                                                    drop_masks_lanes_plain)
    from gossip_protocol_tpu_torch.ops.merge import (
        masked_max3, masked_max3_lanes_plain)
    out = {}
    cfg = bench_cfg(700)
    t_last, t_draw = cfg.total_ticks - 1, min(300, cfg.total_ticks - 1)
    sim = FleetSimulation(cfg, device="cuda")
    with capture_calls(tick_mod, "tick_epilogue",
                       lambda a, k: a[13] == t_last) as ep, \
            capture_calls(tick_mod, "drop_masks_lanes",
                          lambda a, k: a[1] == t_draw) as dr:
        sim.run_bench(seeds=range(4), warmup=False)
    a, k = ep[0]
    b, n = a[5].shape[:2]
    t_remove = cfg.t_remove
    margs = (a[3], a[4], a[5], a[6], a[7], a[13])
    m = masked_max3(*margs, t_remove=t_remove)
    err = max(max_abs_err(x, y) for x, y in zip(
        m, masked_max3_lanes_plain(*margs, t_remove=t_remove)))
    nbytes = macs = 0
    for i in range(b):
        st = merge_stats(dict(gossip=a[3][i], proc=a[4][i], known=a[5][i],
                              hb=a[6][i], ts=a[7][i], t=a[13]), t_remove)
        nbytes += st["bytes"]
        macs += st["tensor_core_macs"]
    out["masked_max3"] = dict(
        n=n, batch=b, tick=t_last, max_abs_err=err,
        ms=cuda_ms(lambda: masked_max3(*margs, t_remove=t_remove), 20),
        plain_ms=cuda_ms(lambda: masked_max3_lanes_plain(
            *margs, t_remove=t_remove), 1, warm=0),
        bound=bound_tc(nbytes, 2 * macs))
    e_args = (*m, *a[3:14])
    got = tick_epilogue(*e_args, t_remove=t_remove, with_events=False)
    want = tick_epilogue_lanes_plain(*e_args, t_remove=t_remove,
                                     with_events=False)
    ep_bytes = n * n * (12 + 8 + 3 + 8 + 2) + 13 * n
    out["tick_epilogue"] = dict(
        n=n, batch=b, tick=t_last,
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)
                        if x is not None),
        ms=cuda_ms(lambda: tick_epilogue(*e_args, t_remove=t_remove,
                                         with_events=False), 20),
        plain_ms=cuda_ms(lambda: tick_epilogue_lanes_plain(
            *e_args, t_remove=t_remove, with_events=False), 2),
        bound=bound(b * ep_bytes, b * 40 * n * n))
    da, dk = dr[0]
    plan = da[0]
    drawn = sum(plan.lane(plan.active, i, t_draw)
                for i in range(plan.batch))
    got = drop_masks_lanes(*da, **dk)
    want = drop_masks_lanes_plain(*da, **dk)
    out["drop_masks"] = dict(
        n=da[2], n_active=da[3], batch=plan.batch, tick=t_draw,
        drawn_lanes=drawn,
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
        ms=cuda_ms(lambda: drop_masks_lanes(*da, **dk), 50),
        plain_ms=cuda_ms(lambda: drop_masks_lanes_plain(*da, **dk), 2),
        bound=draw_bound(da[2], da[3], drawn, plan.batch))
    del ep, dr, sim, m, got, want
    torch.cuda.empty_cache()
    # K5 on the B=8 N=65,536 churn fleet's last full call
    ocfg = overlay_cfg("churn65k")
    with capture_calls(og, "grid_overlay_ticks",
                       lambda a, k: k["s_ticks"] == 16) as calls:
        FleetSimulation(ocfg, device="cuda").run(seeds=range(101, 109),
                                                 warmup=False)
    a, k = calls[-1]
    del calls
    got = ogk.grid_overlay_ticks(*a, **k)
    want = ogk.grid_overlay_ticks_plain(*a, **k)
    kk = resolved_dims(ocfg)[0]
    t0 = int(np.asarray(a[1])[0, 0])
    reslots = sum((t + 1) % 16 == 0 for t in range(t0, t0 + 16))
    work = [k5_work(ocfg.n, kk, got[1][i], reslots)
            for i in range(k["batch"])]
    out["grid_overlay_ticks"] = dict(
        n=ocfg.n, k=kk, batch=k["batch"], s_ticks=16, sp=t0,
        max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
        ms=cuda_ms(lambda: ogk.grid_overlay_ticks(*a, **k), 10),
        plain_ms=cuda_ms(lambda: ogk.grid_overlay_ticks_plain(*a, **k), 1,
                         warm=0),
        bound=bound(sum(w[0] for w in work), sum(w[1] for w in work)))
    del got, want, a, k
    torch.cuda.empty_cache()
    return out


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
    # the fleet's lane-axis draw (a checkout before the fleet has none)
    if hasattr(drop_ops, "drop_masks_lanes"):
        out["drop_masks_lanes"] = drop_ops.drop_masks_lanes
    return out


def draw_kernel() -> tuple:
    """The dense paths' drop-draw kernel, where the checkout has one."""
    return ("drop_masks",) if "drop_masks" in wrappers() else ()


#: counts of a contract a wrapper launches besides its own count (the
#: rectangular merge of the ring, K3's sharded contract): name ->
#: (wrapper, attribute)
SUB_COUNTS = {"masked_max3/rect": ("masked_max3", "rect_launches"),
              "fused_overlay_tick/sharded": ("fused_overlay_tick",
                                             "sharded_launches")}


def reset_counts():
    w = wrappers()
    for fn in w.values():
        fn.launches = 0
    for name, attr in SUB_COUNTS.values():
        if hasattr(w[name], attr):
            setattr(w[name], attr, 0)


def read_counts() -> dict:
    w = wrappers()
    out = {name: fn.launches for name, fn in w.items()}
    for key, (name, attr) in SUB_COUNTS.items():
        if hasattr(w[name], attr):
            out[key] = getattr(w[name], attr)
    return out


class MainPath:
    """Drives main-path runs with the launch counters zeroed just before
    each and read just after, and totals them."""

    def __init__(self):
        self.total = dict.fromkeys(read_counts(), 0)

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


# ------------------------------------------------------------ serving

#: the failure counters a fault-free serving run must leave at zero
FAILURE_KEYS = ("retries", "breaker_opens", "degraded_dispatches",
                "degraded_requests", "failed_requests", "device_losses",
                "faults_injected", "poisoned_lanes")


def no_failures(tag: str, stats: dict) -> None:
    """Phase 7's no-hidden-fallback gate: a fault-free serving run ends
    with zero retries, degraded requests and breaker opens."""
    f = stats["failures"]
    bad = {k: f[k] for k in FAILURE_KEYS if f.get(k)}
    if bad or stats.get("failed"):
        raise AssertionError(f"{tag}: the service absorbed failures {bad}: "
                             f"{stats.get('last_errors')}")


def injected_only(tag: str, m: dict) -> None:
    """Phase 7's chaos gate: every failure the service counted is one the
    injector recorded."""
    f, inj = m["failures"], m["faults"]
    failing = inj["compile"] + inj["dispatch"] + inj["poison"] \
        + inj["device_loss"]
    if f["faults_injected"] != inj["total"] or f["retries"] > failing \
            or f["poisoned_lanes"] != inj["poison"] \
            or f["device_losses"] != inj["device_loss"] \
            or any("Injected" not in e and "PoisonedLane" not in e
                   for e in m["last_errors"]):
        raise AssertionError(f"{tag}: a failure nobody injected: {f} vs "
                             f"{inj}; {m['last_errors']}")


class LaneAxisCount:
    """Counts the K1 pair's lane-axis launches (3-D ``gossip``) by a spy
    on ``core/tick.py``'s module globals; the wrappers' own counters
    count every launch."""

    def __init__(self):
        from gossip_protocol_tpu_torch.core import tick
        self.tick = tick
        self.n = {"masked_max3": 0, "tick_epilogue": 0}

    def __enter__(self):
        self.orig = {}
        for name in self.n:
            fn = getattr(self.tick, name)
            self.orig[name] = fn

            def spy(*a, _fn=fn, _name=name, **k):
                g = a[0] if _name == "masked_max3" else a[3]
                if g.dim() == 3 and g.is_cuda:
                    self.n[_name] += 1
                return _fn(*a, **k)
            setattr(self.tick, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.tick, name, fn)
        return False


def canonical_cfgs() -> dict:
    """Phase 7d's canonical classes below the 1024 rung: asym drop at
    real N=1000 (4 seeds), partition with 10% drop at real N=900 (2
    seeds); 300-tick traces."""
    from gossip_protocol_tpu_torch.config import SimConfig
    base = dict(single_failure=True, drop_msg=True, msg_drop_prob=0.1,
                total_ticks=300, fail_tick=150)
    return {
        "asym_n1000": [SimConfig(max_nnb=1000, asym_drop=True, seed=s,
                                 **base) for s in range(4)],
        "partition_n900": [SimConfig(max_nnb=900, partition_groups=2,
                                     partition_open_tick=120,
                                     partition_close_tick=200, seed=s,
                                     **base) for s in range(2)]}


def corner_draw_timing(cfgs, dev) -> dict:
    """The canonical rung's corner draw on the input a launch of the
    asym class makes at tick 150 (window open): ``drop_masks_lanes`` at
    N=1024 drawing B lanes' real 1000 x 1000 corners against their
    per-link thresholds, held against its plain version and timed, with
    B times the per-lane draw bound plus the thresholds' bytes."""
    import torch
    from gossip_protocol_tpu_torch.core.fleet import CanonicalFleetSimulation
    from gossip_protocol_tpu_torch.ops import drop as drop_ops
    sim = CanonicalFleetSimulation(cfgs[0], device="cuda")
    scheds = sim._lane_schedules(cfgs)
    sched, plan, _ = sim._stage_dense(cfgs, scheds, False)
    n, na, b, t = sim.rung, cfgs[0].n, len(cfgs), 150
    args = (plan, t, n, na, dev, sched.link_prob, None)
    got = drop_ops.drop_masks_lanes(*args)
    want = drop_ops.drop_masks_lanes_plain(*args)
    drawn = sum(plan.lane(plan.active, i, t) for i in range(b))
    # the draw bound of drawn lanes, plus each lane's thresholds read once
    nbytes = b * (n * n + 2 * n) + b * na * na * 4
    bnd = bound(nbytes, 70 * drawn * (na + 2) * na)
    out = dict(n=n, na=na, batch=b, tick=t, s_ticks=1,
               max_abs_err=max(max_abs_err(x, y) for x, y in zip(got, want)),
               ms=cuda_ms(lambda: drop_ops.drop_masks_lanes(*args), 50),
               plain_ms=cuda_ms(lambda: drop_ops.drop_masks_lanes_plain(
                   *args), 3),
               bound=bnd)
    torch.cuda.synchronize()
    return out


#: seeds a template of 7b's replay and 7e's chaos replay of its stream
#: (the JAX acceptance replay's 34 cut to its first 17, 102 requests; 8e
#: serves the first 8 of them again)
REPLAY_7B_SEEDS = 17


def serving(main_path, dev, profile: bool, sweep_seeds: int,
            t_start: float) -> dict:
    """Phase 7: the fleet service (``service/``, ``store/``) on the card.
    Every path is driven as a main path (counters zeroed before it, read
    after it); the K1 pair's lane-axis launches are counted apart."""
    import torch
    from gossip_protocol_tpu_torch.grader import grade_all_service
    from gossip_protocol_tpu_torch.service import (
        FleetService, chaos_replay, grader_templates, overlay_templates,
        replay, result_digest, solo_execute)
    from gossip_protocol_tpu_torch.service.replay import (_mismatch,
                                                          Template,
                                                          build_trace,
                                                          run_sequential)
    out = {"lane_axis": dict.fromkeys(("masked_max3", "tick_epilogue",
                                       "drop_masks_lanes",
                                       "grid_overlay_ticks"), 0)}

    def drive(tag, fn, expect, lane=True):
        with LaneAxisCount() as la:
            res, counts = main_path.drive(fn, expect)
        if lane:
            for k in ("masked_max3", "tick_epilogue"):
                out["lane_axis"][k] += la.n[k]
            for k in ("drop_masks_lanes", "grid_overlay_ticks"):
                out["lane_axis"][k] += counts[k]
        out.setdefault("launches", {})[tag] = {k: v for k, v in
                                               counts.items() if v}
        return res, counts

    # 7a: the grader through the service
    svc = FleetService(max_batch=3, pad_policy="none")
    with tempfile.TemporaryDirectory() as wd:
        res, _ = drive("grade", lambda: grade_all_service(
            os.path.join(REPO, "testcases"), wd, service=svc),
            ("masked_max3", "tick_epilogue", "drop_masks_lanes"))
    no_failures("7a", svc.stats())
    if res["total"] != 90:
        raise AssertionError(f"grade_all_service graded {res['total']}")
    say(f"phase 7a: grade_all_service on cuda graded {res['total']}/90 "
        f"({svc.stats()['dispatches']} dispatches)")
    out["grade"] = res["total"]
    mark("7a", t_start)

    # 7b: the acceptance replay, parity against the sequential
    # solo_execute leg; its first REPLAY_7B_SEEDS of 34 seeds (the depth
    # cut that keeps the run with phases 8f and 9 under its time limit)
    tpls = grader_templates() + overlay_templates(n=512, ticks=96)
    trace = build_trace(tpls, REPLAY_7B_SEEDS)
    seq = run_sequential(trace, "cuda")
    (m, _), _ = drive("replay", lambda: replay(
        tpls, REPLAY_7B_SEEDS, max_batch=8, sequential=seq, device="cuda",
        return_legs=True), ("masked_max3", "tick_epilogue",
                            "drop_masks_lanes"))
    no_failures("7b", {"failures": m["failures"]})
    rps = m["requests"] / m["service_wall_s"]
    say(f"phase 7b: replay {m['requests']} requests, parity with the "
        f"sequential solo leg: {rps:.1f} requests/s; aggregate "
        f"{m['aggregate_node_ticks_per_s']:.4g} node-ticks/s against "
        f"{m['sequential_node_ticks_per_s']:.4g} sequential (walls "
        f"{m['service_wall_s']} / {m['sequential_wall_s']} s); mean "
        f"occupancy {m['mean_occupancy']}; latency p50 "
        f"{m['latency_p50_s']} s, p99 {m['latency_p99_s']} s; a dispatch "
        f"packs {m['mean_pack_s']} s, waits {m['mean_device_wait_s']} s "
        f"on the device, fetches {m['mean_fetch_s']} s; "
        f"{m['dispatches']} dispatches in {m['buckets']} buckets, ring "
        f"stalls {m['ring_stalls']}")
    out["replay"] = dict(m, requests_per_s=rps)
    out["_seq7b"] = seq     # phase 8e serves the same trace from a mesh
    mark("7b", t_start)

    # 7c: full-width serving, three buckets interleaved
    dense = bench_cfg(700)
    churn, power = overlay_cfg("churn65k"), overlay_cfg("powerlaw1m")
    reqs = []
    for i in range(8):
        reqs.append((churn.replace(seed=101 + i), "trace"))
        if i < 4:
            reqs.append((dense.replace(seed=i), "bench"))
        if i < 2:
            reqs.append((power.replace(seed=i), "trace"))

    def serve_wide():
        s = FleetService(max_batch=8, pad_policy="pow2")
        t0 = time.perf_counter()
        hs = [s.submit(c, mode=md) for c, md in reqs]
        s.drain()
        return s, hs, time.perf_counter() - t0

    (wsvc, hs, wall), counts = drive(
        "wide", serve_wide, ("masked_max3", "tick_epilogue",
                             "drop_masks_lanes", "grid_overlay_ticks"))
    st = wsvc.stats()
    no_failures("7c", st)
    if st["cache"]["buckets"] != 3:
        raise AssertionError(f"7c: {st['cache']['buckets']} buckets")
    if counts["drop_masks_lanes"] != 700 or counts["grid_overlay_ticks"] \
            != 38 + 17 or counts["fused_overlay_tick"] \
            or counts.get("drop_masks"):
        raise AssertionError(f"7c: off the fleet routes: {counts}")
    solo_walls, nt = [], 0
    for (c, md), h in zip(reqs, hs):
        ref = solo_execute(c, md, "cuda")
        solo_walls.append(ref.wall_seconds)
        nt += c.n * c.total_ticks
        if result_digest(h.result()) != result_digest(ref):
            raise AssertionError(f"7c: {c.model} N={c.n} seed {c.seed}: "
                                 f"{_mismatch(Template('w', c), ref, h.result())}")
        del ref
    wide = {"wall_s": wall, "node_ticks_per_s": nt / wall,
            "solo_walls_sum_s": sum(solo_walls),
            "dispatches": st["dispatches"], "launches": counts,
            "mean_pack_s": st["mean_pack_s"],
            "mean_device_wait_s": st["mean_device_wait_s"],
            "mean_fetch_s": st["mean_fetch_s"]}
    del hs, wsvc
    if profile:
        wide["profile"] = profile_run(serve_wide)
    say(f"phase 7c: full-width serving, 14 requests in 3 buckets (dense "
        f"N=4096 bench B=4 on the K1 lane axis + draw, overlay N=65,536 "
        f"churn B=8 and N=2^20 power-law B=2 on K5's lane axis), each "
        f"digest == its solo cuda run: wall {wall:.3f} s, "
        f"{wide['node_ticks_per_s']:.4g} node-ticks/s aggregate; solo "
        f"walls sum {wide['solo_walls_sum_s']:.3f} s; idle "
        f"{wide.get('profile', {}).get('idle_share', 'not profiled')}")
    out["wide"] = wide
    mark("7c", t_start)

    # 7d: a canonical bucket at width: the corner draw with thresholds
    # and with groups on the card
    ccfgs = canonical_cfgs()

    def serve_canon():
        s = FleetService(max_batch=4, canonicalize=True, pad_policy="pow2")
        hs = {k: [s.submit(c) for c in v] for k, v in ccfgs.items()}
        s.drain()
        return s, hs

    (csvc, chs), counts = drive("canonical", serve_canon,
                                ("masked_max3", "tick_epilogue",
                                 "drop_masks_lanes"))
    st = csvc.stats()
    no_failures("7d", st)
    if st["cache"]["buckets"] != 2:
        raise AssertionError(f"7d: {st['cache']['buckets']} buckets")
    for k, v in ccfgs.items():
        for c, h in zip(v, chs[k]):
            ref = solo_execute(c, "trace", "cuda")
            bad = _mismatch(Template(k, c), ref, h.result())
            if bad:
                raise AssertionError(f"7d: {k} seed {c.seed}: canonical "
                                     f"lane != exact solo run in {bad}")
            del ref
    out["canonical"] = {"launches": counts,
                        "draws": counts["drop_masks_lanes"],
                        "dispatches": st["dispatches"],
                        "timing": corner_draw_timing(ccfgs["asym_n1000"],
                                                     dev)}
    del chs, csvc
    say(f"phase 7d: canonical rung 1024: asym N=1000 (B=4) and partition "
        f"+ 10% drop N=900 (B=2), 300-tick traces, every lane == its "
        f"exact solo cuda run; corner draw {json.dumps(out['canonical'])}")
    mark("7d", t_start)

    # 7e: chaos, twice, same seed
    chaos = []
    for _ in range(2):
        (cm, _), _ = drive("chaos", lambda: chaos_replay(
            tpls, REPLAY_7B_SEEDS, max_batch=8, fault_rate=0.12, fault_seed=0,
            sequential=seq, device="cuda", return_legs=True),
            ("masked_max3", "tick_epilogue", "drop_masks_lanes"))
        injected_only("7e", cm)
        chaos.append(cm)
    if chaos[0]["schedule_digest"] != chaos[1]["schedule_digest"] or \
            chaos[0]["outcome_digest"] != chaos[1]["outcome_digest"]:
        raise AssertionError("7e: the chaos digests differ across runs")
    out["chaos"] = [{k: c[k] for k in (
        "requests", "completed", "degraded_requests", "faults",
        "schedule_digest", "outcome_digest", "failures",
        "service_wall_s")} for c in chaos]
    say(f"phase 7e: chaos_replay at fault_rate 0.12, seed 0, twice: 100% "
        f"terminal, parity held, digests equal "
        f"({chaos[0]['schedule_digest']}, {chaos[0]['outcome_digest']}); "
        f"faults {chaos[0]['faults']}, degraded "
        f"{chaos[0]['degraded_requests']}, walls "
        f"{[c['service_wall_s'] for c in chaos]} s")
    del seq
    mark("7e", t_start)

    # 7g's rerun, in a process of its own, starts here and runs beside 7f
    # and 7g's own pass: all three are host-bound and the card has room
    keys = ("variants", "families", "passed", "failed", "verdict_digest",
            "outcome_digest", "wall_s", "dispatches", "mean_occupancy",
            "service_failures")
    code = ("import json\n"
            "from gossip_protocol_tpu_torch.models.scenarios import sweep\n"
            f"r = sweep(seeds_per_family={sweep_seeds}, "
            f"max_batch={sweep_seeds}, device='cuda')\n"
            f"print(json.dumps({{k: r[k] for k in {keys!r}}}))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        _serve_7fg(out, drive, child, keys, sweep_seeds, t_start)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    torch.cuda.synchronize()
    return out


def _serve_7fg(out, drive, child, keys, sweep_seeds: int,
               t_start: float) -> None:
    """Phases 7f and 7g (the rerun ``child`` already started)."""
    from gossip_protocol_tpu_torch.models.scenarios import sweep
    from gossip_protocol_tpu_torch.service import FleetService
    from gossip_protocol_tpu_torch.store.harness import kill_restart_replay
    # 7f: crash and recover, the doomed child on cuda, at one kill point.
    # The harness opens its crash window once every request is submitted
    # (journaled); full buckets dispatch during the submits, about 64 of
    # the stream's ~77 dispatches, so the kill point sits in the last
    # fifth of the run (three points until the mesh phase needed the
    # time: PERF.md §4)
    kills, base = [], None
    for frac in (0.9,):
        (km, base), _ = drive("kill_restart", lambda: kill_restart_replay(
            seeds_per_template=34, kill_frac=frac, baseline=base,
            device="cuda"), ("masked_max3", "tick_epilogue"))
        no_failures("7f", {"failures": km["failures"]})
        kills.append({k: km[k] for k in (
            "completed", "completed_before_kill", "recovered_requests",
            "restarted_lanes", "kill_after_dispatches", "outcome_digest",
            "baseline_digest")})
    out["kill_restart"] = kills
    mark("7f", t_start)
    say(f"phase 7f: kill_restart_replay (204 requests, the doomed child on "
        f"cuda) at one kill point: every request terminal once, 0 "
        f"restarted lanes, digests == the uninterrupted baseline {kills}")

    # 7g: the scenario sweep, beside its rerun (a bucket dispatch carries
    # a family's seeds, no filler lanes)
    ssvc = FleetService(max_batch=sweep_seeds)
    r, _ = drive("sweep", lambda: sweep(seeds_per_family=sweep_seeds,
                                        service=ssvc),
                 ("masked_max3", "drop_masks_lanes"))
    c_out, c_err = child.communicate(timeout=1100)
    if child.returncode != 0:
        raise AssertionError(f"7g: the rerun process failed: {c_err[-3000:]}")
    reps = [{k: r[k] for k in keys}, json.loads(c_out.strip().splitlines()[-1])]
    no_failures("7g", ssvc.stats())
    no_failures("7g rerun", {"failures": reps[1]["service_failures"]})
    if reps[0]["verdict_digest"] != reps[1]["verdict_digest"] or \
            reps[0]["outcome_digest"] != reps[1]["outcome_digest"]:
        raise AssertionError("7g: sweep digests differ on the rerun")
    out["sweep"] = reps
    say(f"phase 7g: sweep of {reps[0]['variants']} variants "
        f"({reps[0]['families']} families): all oracles green, digests "
        f"equal on the rerun in a second process ({reps[0]['verdict_digest']}"
        f", {reps[0]['outcome_digest']}); walls, side by side "
        f"{[r['wall_s'] for r in reps]} s")


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


# ------------------------------------------------------------- worlds

#: the kernels no overlay world run may launch (the JAX package routes
#: world configs off its fused kernels, models/overlay.py:661-662)
OVERLAY_KERNELS = ("fused_overlay_tick", "mega_overlay_ticks",
                   "grid_overlay_ticks", "grid_boot_rows")


def world_route(cfg, with_events: bool = True) -> tuple[tuple, tuple]:
    """(kernels a world run must launch, kernels it must not): dense runs
    draw with ``drop_masks`` every tick or launch, then take K2 (the wave
    inside its envelope), the composable route (zombie, byz, latency:
    ``masked_max3`` and torch) or the K1 pair; overlay runs none of
    K3, K4, K5."""
    from gossip_protocol_tpu_torch.core.dense_mega import \
        dense_mega_supported
    if cfg.model == "overlay":
        return (), OVERLAY_KERNELS
    if dense_mega_supported(cfg, with_events):
        return ("drop_masks", "dense_mega_ticks"), ("masked_max3",
                                                    "tick_epilogue")
    if cfg.zombie or cfg.byz_rate > 0 or cfg.link_latency > 0:
        return ("drop_masks", "masked_max3"), ("tick_epilogue",
                                               "dense_mega_ticks")
    return ("drop_masks", "masked_max3", "tick_epilogue"), \
        ("dense_mega_ticks",)


def drive_world(main_path, fn, cfg, with_events: bool = True):
    """One world run as a main path: it must launch its route's kernels
    and none of the others (:func:`world_route`)."""
    used, unused = world_route(cfg, with_events)
    out, counts = main_path.drive(fn, used)
    bad = [k for k in unused if counts[k]]
    if bad:
        raise AssertionError(f"{cfg.worlds_key()}: off-route launches of "
                             f"{bad}: {counts}")
    return out, counts


def world_draw_checks(dev) -> tuple[float, int]:
    """Phase 2's world draws: ``drop_masks`` with per-link thresholds,
    with partition groups and with both, against its plain version at
    N in {10, 64, 1024, 4096}: S=8 launches in which the drop window and
    the partition are each open and closed in all four combinations,
    and S=1 launches with the window open, or closed with the partition
    open.  Returns the max abs error and the launches checked."""
    import torch

    from gossip_protocol_tpu_torch import worlds
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.ops.drop import (drop_masks,
                                                    drop_masks_plain)
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    err, checked = 0.0, 0
    for n in (10, 64, 1024, 4096):
        cfg = SimConfig(max_nnb=n, seed=n, drop_msg=True, msg_drop_prob=0.1,
                        asym_drop=True, partition_groups=3,
                        partition_open_tick=50, partition_close_tick=90)
        lp = torch.from_numpy(worlds.link_prob_host(cfg)).to(dev)
        grp = torch.from_numpy(worlds.partition_groups_host(cfg)).to(dev)
        launches = [([True, False, True, False, True, True, False, False],
                     [True, True, False, False, True, False, True, False]),
                    ([True], [True]), ([False], [True])]
        for active, part in launches:
            for thr, group in ((lp, None), (None, grp), (lp, grp)):
                if group is None and not any(active):
                    continue
                kw = dict(device=dev, link_prob=thr, group=group,
                          part_active=part if group is not None else None)
                draw = (prng_key(n + len(active)), 80, active,
                        np.float32(0.1), n)
                got = drop_masks(*draw, **kw)
                want = drop_masks_plain(*draw, **kw)
                err = max(err, max(max_abs_err(a, b)
                                   for a, b in zip(got, want)))
                checked += 1
    return err, checked


def world_families_card_vs_cpu(main_path) -> dict:
    """Phase 4's worlds: every catalog family at its catalog size and
    seed ``WORLD_SEED`` on ``cuda`` (a main path, on its route) and on
    ``cpu``: final state, events or metrics, the lane digest and the
    oracle verdict (a pass) equal; dense families also their ``dbg.log``
    and ``msgcount.log`` bytes."""
    import torch

    from gossip_protocol_tpu_torch.models.scenarios import (
        CATALOG, _lane_digest, grade)
    from gossip_protocol_tpu_torch.service.resilience import solo_execute
    t0 = time.perf_counter()
    out = {}
    for name in sorted(CATALOG):
        fam = CATALOG[name]
        cfg = fam.build(WORLD_SEED)
        r_gpu, counts = drive_world(main_path,
                                    lambda: solo_execute(cfg, "trace",
                                                         "cuda"), cfg)
        r_cpu = solo_execute(cfg, "trace", "cpu")
        if cfg.model == "overlay":
            bad = overlay_equal(r_gpu.final_state, r_cpu.final_state,
                                r_gpu.metrics, r_cpu.metrics)
            if not torch.equal(r_gpu.final_state.send_hist.cpu(),
                               r_cpu.final_state.send_hist):
                bad.append("send_hist")
        else:
            bad = [f for f in ("known", "hb", "ts", "gossip", "gossip_age",
                               "in_group", "own_hb", "joinreq", "joinrep")
                   if not torch.equal(getattr(r_gpu.final_state, f).cpu(),
                                      getattr(r_cpu.final_state, f))]
            bad += [f for f in ("added", "removed", "sent", "recv")
                    if not np.array_equal(getattr(r_gpu, f),
                                          getattr(r_cpu, f))]
            with tempfile.TemporaryDirectory() as wd:
                logs = []
                for tag, r in (("cuda", r_gpu), ("cpu", r_cpu)):
                    d = os.path.join(wd, tag)
                    os.makedirs(d)
                    r.write_logs(d)
                    logs.append([read_file(os.path.join(d, f))
                                 for f in ("dbg.log", "msgcount.log")])
            if logs[0] != logs[1]:
                bad.append("logs")
        verdict = grade(fam, WORLD_SEED, r_gpu)
        digest = _lane_digest(cfg, r_gpu)
        if verdict != grade(fam, WORLD_SEED, r_cpu):
            bad.append("verdict")
        if digest != _lane_digest(cfg, r_cpu):
            bad.append("digest")
        if bad or verdict:
            raise AssertionError(f"{name}: cuda != cpu in {bad}; verdict "
                                 f"{verdict[:3]}")
        out[name] = {"n": cfg.n, "ticks": cfg.total_ticks, "digest": digest,
                     "launches": {k: v for k, v in counts.items() if v}}
    wall = time.perf_counter() - t0
    say(f"phase 4: {len(out)} catalog families (seed {WORLD_SEED}) on cuda "
        f"== cpu (state, events or metrics, digest, verdict; dense log "
        f"bytes), {len(out)} passes, wall {wall:.1f} s: "
        + json.dumps({k: v["launches"] for k, v in out.items()}))
    return {"families": out, "seed": WORLD_SEED, "passes": len(out),
            "wall_s": wall}


def asym4096_cfg(ticks: int = 700):
    """BASELINE's dense N=4096 10% drop bench with the asym world on: no
    corner (worlds run at full width), so the K1 pair and the threshold
    draw at N=4096."""
    return bench_cfg(ticks).replace(asym_drop=True)


def dense_world_runs(main_path) -> dict:
    """Phase 5g: ``asym4096`` (bench mode, after an untimed run, held to
    :func:`oracle_bench`), then every dense family kept at N=1024 in
    trace mode (``dense_wave`` at N=512, on K2), each graded by its
    family's oracle, with its node-ticks/s."""
    from gossip_protocol_tpu_torch.core.sim import Simulation
    from gossip_protocol_tpu_torch.models.scenarios import (
        CATALOG, _lane_digest, grade_config)
    runs = {}
    cfg = asym4096_cfg()
    sim = Simulation(cfg, device="cuda")
    sim.run_bench(warmup=False)     # untimed warm-up, not counted
    r, counts = drive_world(main_path, lambda: sim.run_bench(warmup=False),
                            cfg, with_events=False)
    if r.counter_stream_width != cfg.n:
        raise AssertionError("asym4096 ran on a corner")
    o = oracle_bench(r)
    runs["asym4096"] = dict(n=cfg.n, ticks=cfg.total_ticks,
                            wall_s=r.wall_seconds,
                            node_ticks_per_s=r.node_ticks_per_second,
                            launches=counts, **o)
    say(f"phase 5g: asym4096 N=4096 10% asym drop bench, 700 ticks, full "
        f"width: {r.node_ticks_per_second:.1f} node-ticks/s (wall "
        f"{r.wall_seconds:.3f} s); {o}; launches {counts}")
    del r, sim
    for name, n in wide_runs():
        if not name.startswith("dense") or (name, n) in WIDE_LEFT_OUT:
            continue
        cfg = wide_family_cfg(name, n)
        r, counts = drive_world(
            main_path, lambda: Simulation(cfg, device="cuda").run(), cfg)
        verdict = grade_config(CATALOG[name], cfg, r)
        if verdict:
            raise AssertionError(f"{name} at N={n}: {verdict[:3]}")
        runs[f"{name}_n{n}"] = dict(
            n=n, ticks=cfg.total_ticks, wall_s=r.wall_seconds,
            node_ticks_per_s=r.node_ticks_per_second,
            removals=int(r.removed.sum()), digest=_lane_digest(cfg, r),
            launches={k: v for k, v in counts.items() if v})
        say(f"phase 5g: {name} N={n}, {cfg.total_ticks} ticks, trace: oracle "
            f"passed; {r.node_ticks_per_second:.1f} node-ticks/s (wall "
            f"{r.wall_seconds:.3f} s); launches {runs[f'{name}_n{n}']['launches']}")
        del r
    return runs


#: phase 5h's single-device runs, kept on the host for phase 8f:
#: (family, N) -> (final state, metrics)
SOLO_WORLDS: dict = {}


def overlay_world_runs(main_path) -> dict:
    """Phase 5h: every overlay family kept at N=4096, and the two at
    N=65,536, each graded by its family's oracle and
    :func:`validate_overlay`, with its node-ticks/s; K3, K4 and K5 launch
    on none of them."""
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    from gossip_protocol_tpu_torch.models.scenarios import (
        CATALOG, _lane_digest, grade_config)
    runs = {}
    for name, n in wide_runs():
        if not name.startswith("overlay") or (name, n) in WIDE_LEFT_OUT:
            continue
        cfg = wide_family_cfg(name, n)
        r, counts = drive_world(
            main_path, lambda: OverlaySimulation(cfg, device="cuda").run(),
            cfg)
        verdict = grade_config(CATALOG[name], cfg, r)
        if verdict:
            raise AssertionError(f"{name} at N={n}: {verdict[:3]}")
        o = validate_overlay(r, join_complete=(name, n) not in JOINS_LOST)
        runs[f"{name}_n{n}"] = dict(
            n=n, ticks=cfg.total_ticks, wall_s=r.wall_seconds,
            node_ticks_per_s=r.node_ticks_per_second,
            digest=_lane_digest(cfg, r),
            launches={k: v for k, v in counts.items() if v}, **o)
        SOLO_WORLDS[(name, n)] = (r.final_state.to("cpu"), r.metrics)
        say(f"phase 5h: {name} N={n}, {cfg.total_ticks} ticks: oracle and "
            f"validation passed {o}; {r.node_ticks_per_second:.1f} "
            f"node-ticks/s (wall {r.wall_seconds:.3f} s); no K3/K4/K5 "
            "launch")
        del r
    return runs


def sharded_world_runs(main_path, dev, label: str) -> dict:
    """Phase 8f: the overlay worlds peer-sharded at full width, every
    mesh entry ``cuda:0``: the two N=65,536 runs of 5h over 4 entries,
    the N=4096 ones over 2.  Each equals its single-device run (5h's,
    or run here when 5h did not run) in every state field and metric,
    passes its family oracle and :func:`validate_overlay` (5h's
    ``JOINS_LOST`` exceptions), and launches no K3, K4 or K5."""
    import torch

    from gossip_protocol_tpu_torch.models.overlay import (
        OverlayResult, OverlaySimulation, init_overlay_state,
        make_overlay_schedule)
    from gossip_protocol_tpu_torch.models.overlay_sharded import (
        make_overlay_mesh, make_sharded_overlay_run, shard_overlay_state)
    from gossip_protocol_tpu_torch.models.scenarios import (
        CATALOG, grade_config)
    runs = {}
    for name, n in wide_runs():
        if not name.startswith("overlay") or (name, n) in WIDE_LEFT_OUT:
            continue
        p = 4 if n == 65536 else 2
        cfg = wide_family_cfg(name, n)
        if (name, n) not in SOLO_WORLDS:
            r = OverlaySimulation(cfg, device="cuda").run()
            SOLO_WORLDS[(name, n)] = (r.final_state.to("cpu"), r.metrics)
            del r
        ref, rmet = SOLO_WORLDS[(name, n)]
        sched = make_overlay_schedule(cfg)
        omesh = make_overlay_mesh(p)
        run = make_sharded_overlay_run(cfg, omesh)
        state = shard_overlay_state(init_overlay_state(cfg, dev), omesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (fin, met), counts = drive_world(main_path, lambda: run(state, sched),
                                         cfg)
        wall = time.perf_counter() - t0
        bad = overlay_equal(ref, fin, rmet, met)
        if not torch.equal(ref.send_hist, fin.send_hist.cpu()):
            bad.append("send_hist")
        if bad:
            raise AssertionError(f"8f {name} N={n}: {p} shards != the "
                                 f"single-device run in {bad}")
        res = OverlayResult(cfg=cfg, sched=sched, final_state=fin,
                            metrics=met.to_numpy(), wall_seconds=wall)
        verdict = grade_config(CATALOG[name], cfg, res)
        if verdict:
            raise AssertionError(f"8f {name} N={n}: {verdict[:3]}")
        v = validate_overlay(res, join_complete=(name, n) not in JOINS_LOST)
        runs[f"{name}_n{n}_p{p}"] = dict(
            n=n, shards=p, ticks=cfg.total_ticks, wall_s=wall,
            node_ticks_per_s=cfg.n * cfg.total_ticks / wall, **v)
        say(f"phase 8f: {name} N={n} ({cfg.total_ticks} ticks) over {p} "
            f"{label}: every state field and metric == the single-device "
            f"run, oracle and validation passed {v}; wall {wall:.3f} s, "
            f"{cfg.n * cfg.total_ticks / wall:.4g} node-ticks/s; no "
            "K3/K4/K5 launch")
        del fin, met, res, state
    SOLO_WORLDS.clear()
    return runs


def analysis_phase(dev) -> dict:
    """Phase 9: the port's analysis on the card: the source pass over
    the tree, and the runtime and guard passes with ``device="cuda"``
    (the solo tick loops and a launched fleet's wait and resolve under
    the sync-debug mode "error", a warmed lap's fleet-run builds and
    nvcc compilations).  Any finding fails the run."""
    from gossip_protocol_tpu_torch.analysis import guards, run_all, runtime
    from gossip_protocol_tpu_torch.ops.cuda._build import nvcc_build_count
    t0 = time.perf_counter()
    findings = run_all(passes=("ast",))
    findings += runtime.check(device=str(dev))
    gate = guards.steady_state_build_gate(str(dev))
    findings += guards.self_check(device=str(dev))
    if findings:
        raise AssertionError("phase 9: analysis findings:\n" + "\n".join(
            str(f) for f in findings))
    out = {"programs": [p.name for p in runtime.check.last_programs],
           "steady_state_gate": gate, "nvcc_builds": nvcc_build_count(),
           "seconds": round(time.perf_counter() - t0, 1)}
    say("phase 9: the analysis on cuda: ast, runtime (programs "
        f"{out['programs']}, the solo tick loops under sync-debug "
        "'error') and guard passes (a warmed fleet lap built "
        f"{gate['runs']} runs and started {gate['nvcc']} nvcc; a launched "
        "fleet's wait and resolve under sync-debug 'error'; both gates "
        f"trip when injected): no finding; {out['seconds']} s")
    return out


def world_timing(dev) -> dict:
    """Phase 6's world inputs: the threshold draw at N=4096 on the
    asym4096 run's tick 300 (window open), and the K1 pair on its tick
    699, each held against its plain version and timed, with bounds."""
    from gossip_protocol_tpu_torch.ops import drop as drop_ops
    from gossip_protocol_tpu_torch.state import make_schedule
    from gossip_protocol_tpu_torch.utils.threefry import prng_key
    cfg = asym4096_cfg()
    n, t = cfg.n, 300
    sched = make_schedule(cfg, dev)
    args = (prng_key(cfg.seed), t, [sched.drop_on(t)], sched.drop_prob, n)
    kw = dict(device=dev, link_prob=sched.link_prob)
    got = drop_ops.drop_masks(*args, **kw)
    want = drop_ops.drop_masks_plain(*args, **kw)
    # bytes: the outputs written, the thresholds read (N^2 + 2N floats)
    draw = dict(n=n, tick=t, s_ticks=1, drawn_ticks=1, world="asym",
                max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
                ms=cuda_ms(lambda: drop_ops.drop_masks(*args, **kw), 50),
                plain_ms=cuda_ms(lambda: drop_ops.drop_masks_plain(
                    *args, **kw), 3),
                bound=bound((n * n + 2 * n) * 5, 70 * (n + 2) * n))
    del got, want
    k1 = time_k1(k1_launch_input(cfg, n, dev), cfg.t_remove,
                 with_events=False, reps=20, describe=True)
    return {"draw_asym4096": draw, "k1_asym4096": k1}


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


# ------------------------------------------------- phase 8: the mesh

def rect_inputs(r: int, s: int, c: int, seed: int, dev, lanes=None):
    """A random rectangular merge input: delivery block bool[S, R] (about
    a quarter delivering), proc, and payload rows known / hb / ts [S, C]
    with timestamps on both sides of the freshness gate; a leading lane
    axis with ``lanes``."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    lead = () if lanes is None else (lanes,)

    def b(p, shape):
        return (torch.rand(lead + shape, generator=g) < p).to(dev)

    def i(lo, hi, shape):
        return torch.randint(lo, hi, lead + shape, generator=g,
                             dtype=torch.int32).to(dev)

    return (b(0.25, (s, r)), b(0.9, (r,)), b(0.7, (s, c)),
            i(0, 600, (s, c)), i(T8 - 40, T8 + 1, (s, c)))


#: the clock of phase 8a's random merge inputs
T8 = 300


def rect_bound(x) -> tuple[float, str]:
    """The rectangular merge's least time: the delivery block and proc
    read, known/hb/ts (9 bytes a cell) of the senders that deliver, the
    three i32 maxima written, against the int8 tensor-core MACs of the
    one product every descent runs (the pre-resolve: receivers x
    delivering senders x columns)."""
    gossip, proc, known = x[0], x[1], x[2]
    lead = known.shape[:-2]
    s_dim, r_dim = gossip.shape[-2:]
    c_dim = known.shape[-1]
    b = int(np.prod(lead)) if lead else 1
    senders = int((gossip & proc.unsqueeze(-2)).any(-1).sum())
    nbytes = b * (s_dim * r_dim + r_dim + 12 * r_dim * c_dim) \
        + 9 * senders * c_dim
    return bound_tc(nbytes, 2 * b * r_dim * senders * c_dim)


def time_rect(x, reps: int = 20) -> dict:
    """masked_max3 vs its plain version on one rectangular input: equal,
    and both timed."""
    from gossip_protocol_tpu_torch.ops.merge import (masked_max3,
                                                     masked_max3_lanes_plain,
                                                     masked_max3_plain)
    t = x[5] if len(x) > 5 else T8
    args = x[:5]
    plain = masked_max3_lanes_plain if args[2].dim() == 3 \
        else masked_max3_plain
    got = masked_max3(*args, t, t_remove=20)
    want = plain(*args, t, t_remove=20)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    return {"shape": [int(v) for v in args[2].shape[:-2]]
            + [int(args[0].shape[-1]), int(args[0].shape[-2]),
               int(args[2].shape[-1])],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: masked_max3(*args, t, t_remove=20), reps),
            "plain_ms": cuda_ms(lambda: plain(*args, t, t_remove=20), 2),
            "bound": rect_bound(args)}


def shard_k3(x: dict, p: int, s: int) -> dict:
    """Shard ``s`` of ``p``'s K3 input from a single-device one: its rows,
    each round's plane from shard ``s ^ (m // Nl)``, the local masks and
    the global id of its first row (the sharded contract)."""
    idsaux, pw, intro, masks, scalars = x["args"]
    nl = idsaux.shape[0] // p

    def rows(t, q):
        return t[q * nl:(q + 1) * nl]

    kw = dict(x["kw"], masks_local=[m % nl for m in masks],
              row_start=s * nl,
              aux_rounds=[rows(idsaux, s ^ (m // nl)) for m in masks],
              pw_rounds=[rows(pw, s ^ (m // nl)) for m in masks])
    return {"args": (rows(idsaux, s), rows(pw, s), intro, masks, scalars),
            "kw": kw, "nl": nl}


def check_k3_sharded(x: dict, p: int, time_shard: int) -> dict:
    """Every shard of ``p``: the kernel's sharded contract == its plain
    version == the single-device kernel's rows; shard ``time_shard``
    (a non-zero row start) timed against its bound."""
    from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import (
        fused_overlay_tick, fused_overlay_tick_plain)
    whole = fused_overlay_tick(*x["args"], **x["kw"])
    err = 0.0
    out = {}
    for s in range(p):
        y = shard_k3(x, p, s)
        got = fused_overlay_tick(*y["args"], **y["kw"])
        want = fused_overlay_tick_plain(*y["args"], **y["kw"])
        rows = [w[s * y["nl"]:(s + 1) * y["nl"]] for w in whole]
        err = max(err, *(max_abs_err(a, b) for a, b in zip(got, want)),
                  *(max_abs_err(a, b) for a, b in zip(got, rows)))
        if s == time_shard:
            idsaux = y["args"][0]
            n, k = idsaux.shape[0], y["args"][1].shape[1]
            f = len(y["args"][3])
            recv = int(got[3][:, 0].sum())
            out = {"n": int(x["args"][0].shape[0]), "shards": p, "nl": n,
                   "k": k, "f": f, "row_start": y["kw"]["row_start"],
                   "recv": recv,
                   "ms": cuda_ms(lambda: fused_overlay_tick(
                       *y["args"], **y["kw"]), 20),
                   "plain_ms": cuda_ms(lambda: fused_overlay_tick_plain(
                       *y["args"], **y["kw"]), 2),
                   "bound": k3_bound(n, k, f, recv=recv)}
    out["max_abs_err"] = err
    return out


@contextlib.contextmanager
def keep_last_merge():
    """Keeps the arguments of the last rectangular merge the comm module
    launches (parallel/comm.py), for timing on a real ring-step input."""
    from gossip_protocol_tpu_torch.parallel import comm
    orig = comm.masked_max3
    box = {}

    def spy(*a, **k):
        box["args"] = a
        return orig(*a, **k)

    comm.masked_max3 = spy
    try:
        yield box
    finally:
        comm.masked_max3 = orig


def mesh_phase(main_path, dev, t_start: float, seq7b=None) -> dict:
    """Phase 8: multi-device execution on a mesh of one process, every
    mesh's entries ``cuda:0`` (so P shards take turns on one H100: the
    walls here are those of P shards on one card, not of P cards)."""
    out = {"lane_axis": dict.fromkeys(("masked_max3", "tick_epilogue",
                                       "drop_masks_lanes",
                                       "grid_overlay_ticks"), 0)}
    label = "shards on one H100"

    class Drive:
        """main_path.drive, the K1 pair's lane-axis launches (3-D
        ``gossip`` through core/tick.py) and the lane-axis draws and K5
        calls counted apart, as phase 7 counts them."""

        def drive(self, fn, expect):
            with LaneAxisCount() as la:
                res, counts = outer.drive(fn, expect)
            for k in ("masked_max3", "tick_epilogue"):
                out["lane_axis"][k] += la.n[k]
            for k in ("drop_masks_lanes", "grid_overlay_ticks"):
                out["lane_axis"][k] += counts[k]
            return res, counts

    outer, main_path = main_path, Drive()
    # 8e's load bench runs in a process of its own, started now beside
    # 8a-8e: wall-paced, it waits on its arrival schedule most of the time
    # (its walls and latencies are then those beside phase 8's other work)
    code = ("import json\n"
            "from gossip_protocol_tpu_torch.service.loadbench import "
            "load_openloop_bench\n"
            "print(json.dumps(load_openloop_bench(smoke=True, "
            "device='cuda')))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        _mesh_8(out, main_path, dev, t_start, seq7b, child, label)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return out


def _mesh_8(out, main_path, dev, t_start: float, seq7b, child,
            label: str) -> None:
    """8a-8e (the load bench's ``child`` already started)."""
    import dataclasses

    import torch

    from gossip_protocol_tpu_torch.core.sim import Simulation
    from gossip_protocol_tpu_torch.core.tick import make_tick_run
    from gossip_protocol_tpu_torch.models.overlay import (
        OverlayResult, OverlaySimulation, init_overlay_state,
        make_overlay_schedule)
    from gossip_protocol_tpu_torch.models.overlay_sharded import (
        make_overlay_mesh, make_sharded_overlay_run, shard_overlay_state)
    from gossip_protocol_tpu_torch.parallel.fleet_mesh import (
        MeshFleetSimulation, make_lane_mesh, make_lane_peer_mesh)
    from gossip_protocol_tpu_torch.parallel.sharded import (
        make_mesh, make_sharded_run, shard_state)
    from gossip_protocol_tpu_torch.state import init_state, make_schedule

    # ---- 8a: the two kernel contracts against their plain versions ----
    rect = {}
    for r, s_, c in ((1024, 1024, 4096), (512, 512, 4096), (128, 128, 1024),
                     (5, 5, 10)):
        rect[f"{r}x{s_}x{c}"] = time_rect(rect_inputs(r, s_, c, r + c, dev))
        rect[f"b2_{r}x{s_}x{c}"] = time_rect(rect_inputs(r, s_, c, r + 1,
                                                         dev, lanes=2))
    err = max(v["max_abs_err"] for v in rect.values())
    if err:
        raise AssertionError(f"rectangular masked_max3 != plain: {rect}")
    say("phase 8a: rectangular masked_max3 == plain bit for bit at (R,S,C) "
        "1024x1024x4096, 512x512x4096, 128x128x1024, 5x5x10, each also at "
        "B=2 lanes; ms " + json.dumps({k: round(v["ms"], 4)
                                       for k, v in rect.items()}))
    k3s = {}
    cfg1m = overlay_cfg("powerlaw1m")
    mid = OverlaySimulation(cfg1m, device="cuda").run(ticks=136)
    x1m = k3_launch_input(cfg1m, mid.final_state)
    k3s["powerlaw1m_p4_t136"] = check_k3_sharded(x1m, 4, time_shard=1)
    del mid, x1m
    cfg65 = overlay_cfg("churn65k")
    mid = OverlaySimulation(cfg65, device="cuda").run(ticks=300)
    k3s["churn65k_p8_t300"] = check_k3_sharded(
        k3_launch_input(cfg65, mid.final_state), 8, time_shard=5)
    del mid
    if any(v["max_abs_err"] for v in k3s.values()):
        raise AssertionError(f"K3's sharded contract != plain: {k3s}")
    say("phase 8a: K3's sharded contract == plain == the single-device "
        "kernel's rows, every shard, on the real tick-136 state of the "
        "N=2^20 power-law run (4 shards, Nl=2^18, F=8) and tick 300 of "
        "the N=65,536 churn run (8 shards, F=3): " + json.dumps(
            {k: {f: v[f] for f in ("row_start", "ms", "plain_ms", "recv")}
             for k, v in k3s.items()}))
    out["rect"], out["k3_sharded"] = rect, k3s
    mark("8a", t_start)

    # ---- 8b: dense peer-sharded runs on cuda:0 x 4 ----------------------
    runs = {}
    mesh4 = make_mesh(4)
    cfg = bench_cfg(700)
    sched = make_schedule(cfg, dev)
    ref, rev = make_tick_run(cfg, with_events=False)(init_state(cfg, dev),
                                                     sched)
    torch.cuda.synchronize()
    with keep_last_merge() as merge_in:
        t0 = time.perf_counter()
        (fin, ev), counts = main_path.drive(
            lambda: make_sharded_run(cfg, mesh4, with_events=False)(
                shard_state(init_state(cfg, dev), mesh4), sched),
            ("masked_max3", "masked_max3/rect") + draw_kernel())
        wall = time.perf_counter() - t0
    bad = [f for f in ("known", "hb", "ts", "gossip", "in_group", "own_hb",
                       "joinreq", "joinrep")
           if not torch.equal(getattr(fin, f), getattr(ref, f))]
    bad += [f for f in ("sent", "recv")
            if not torch.equal(getattr(ev, f), getattr(rev, f))]
    if bad or counts["tick_epilogue"]:
        raise AssertionError(f"8b bench: sharded != single device in {bad}"
                             f" ({counts})")
    runs["bench_n4096_p4"] = {"wall_s": wall, "launches": counts,
                              "node_ticks_per_s": cfg.n * 700 / wall}
    rect_real = time_rect(tuple(merge_in["args"][:5])
                          + (merge_in["args"][5],))
    if rect_real["max_abs_err"]:
        raise AssertionError("8b: the ring-step merge != plain")
    out["rect_real"] = dict(rect_real, tick=699, n=4096, shards=4)
    say(f"phase 8b: N=4096 10% drop bench, 700 ticks, 4 {label}: final "
        f"state and counters == the single-device K1 route; wall "
        f"{wall:.2f} s, {cfg.n * 700 / wall:.4g} node-ticks/s; launches "
        f"{counts}; the last ring-step merge (1024x1024x4096) "
        f"{rect_real['ms']:.4f} ms")
    del fin, ev, ref, rev
    cfg = trace_cfgs()["trace_n1024_drop"]
    ref = Simulation(cfg, device="cuda").run()
    t0 = time.perf_counter()
    (fin, ev), counts = main_path.drive(
        lambda: make_sharded_run(cfg, mesh4)(
            shard_state(init_state(cfg, dev), mesh4),
            make_schedule(cfg, dev)), ("masked_max3/rect",))
    wall = time.perf_counter() - t0
    got = dataclasses.replace(ref, added=ev.added.cpu().numpy(),
                              removed=ev.removed.cpu().numpy(),
                              sent=ev.sent.cpu().numpy().T,
                              recv=ev.recv.cpu().numpy().T)
    bad = [f for f in ("added", "removed", "sent", "recv")
           if not np.array_equal(getattr(got, f), getattr(ref, f))]
    if bad:
        raise AssertionError(f"8b trace: sharded != single device in {bad}")
    o = oracle_trace(got, exact_removal=False)
    runs["trace_n1024_p4"] = dict(wall_s=wall, launches=counts, **o)
    say(f"phase 8b: N=1024 multifailure 10% drop trace over 4 {label}: "
        f"every event mask == the single-device trace; oracle {o}; wall "
        f"{wall:.2f} s")
    del fin, ev, ref, got
    mesh2 = make_mesh(2)
    for conf in ("singlefailure", "multifailure", "msgdropsinglefailure"):
        from gossip_protocol_tpu_torch.config import SimConfig
        cfg = SimConfig.from_conf(os.path.join(REPO, "testcases",
                                               f"{conf}.conf"))
        ref = Simulation(cfg, device="cuda").run()
        (fin, ev), counts = main_path.drive(
            lambda: make_sharded_run(cfg, mesh2)(
                shard_state(init_state(cfg, dev), mesh2),
                make_schedule(cfg, dev)), ("masked_max3/rect",))
        if not (np.array_equal(ev.added.cpu().numpy(), ref.added)
                and np.array_equal(ev.removed.cpu().numpy(), ref.removed)):
            raise AssertionError(f"8b {conf}: sharded events differ")
        runs[f"{conf}_p2"] = {"launches": counts}
    say("phase 8b: the three N=10 testcases over 2 entries: events equal")
    mark("8b", t_start)

    # ---- 8c: overlay peer-sharded, per-tick K3's sharded contract ------
    for name, p in (("powerlaw1m", 4), ("churn65k", 8)):
        cfg = overlay_cfg(name)
        osched = make_overlay_schedule(cfg)
        ref = OverlaySimulation(cfg, device="cuda").run()
        omesh = make_overlay_mesh(p)
        t0 = time.perf_counter()
        (fin, met), counts = main_path.drive(
            lambda: make_sharded_overlay_run(cfg, omesh)(
                shard_overlay_state(init_overlay_state(cfg, dev), omesh),
                osched), ("fused_overlay_tick/sharded",))
        wall = time.perf_counter() - t0
        bad = overlay_equal(ref.final_state, fin, ref.metrics, met)
        if bad:
            raise AssertionError(f"8c {name}: sharded != single device in "
                                 f"{bad}")
        res = OverlayResult(cfg=cfg, sched=osched, final_state=fin,
                            metrics=met.to_numpy(), wall_seconds=wall)
        v = validate_overlay(res)
        runs[f"overlay_{name}_p{p}"] = dict(
            wall_s=wall, launches=counts,
            node_ticks_per_s=cfg.n * cfg.total_ticks / wall, **v)
        say(f"phase 8c: overlay {name} ({cfg.total_ticks} ticks) over {p} "
            f"{label}: final state and every metric == the single-device "
            f"run; {v}; wall {wall:.2f} s, "
            f"{cfg.n * cfg.total_ticks / wall:.4g} node-ticks/s; launches "
            f"{counts}")
        del ref, fin, met, res
    mark("8c", t_start)

    # ---- 8d: meshes of fleets -----------------------------------------
    cfg = bench_cfg(700)
    msim = MeshFleetSimulation(cfg, make_lane_mesh(2))
    msim.run_bench(seeds=range(4))          # untimed warm-up, not counted
    torch.cuda.synchronize()

    def deferred():
        torch.cuda.set_sync_debug_mode("error")
        try:
            pend = msim.launch_bench(seeds=range(4), warmup=False,
                                     defer=True)
            pend.start()
            while not pend.is_ready():
                pass
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return pend.resolve()

    fr, counts = main_path.drive(deferred, ("masked_max3", "tick_epilogue",
                                            "drop_masks_lanes"))
    for i, lane in enumerate(fr.lanes):
        bad = dense_lane_diff(lane, Simulation(cfg.replace(seed=i),
                                               device="cuda").run_bench(),
                              bench=True)
        if bad:
            raise AssertionError(f"8d bench lane {i} != solo in {bad}")
    runs["fleet_bench_n4096_b4_lanes2"] = dict(
        wall_s=fr.wall_seconds, launches=counts,
        node_ticks_per_s=fr.aggregate_node_ticks_per_second)
    say(f"phase 8d: B=4 N=4096 bench on 2 lane entries, launched under "
        f"set_sync_debug_mode('error'): every lane == its solo run; wall "
        f"{fr.wall_seconds:.2f} s, {fr.aggregate_node_ticks_per_second:.4g}"
        f" node-ticks/s aggregate ({label})")
    del msim, fr
    cfg = overlay_cfg("churn65k")
    fr, counts = main_path.drive(
        lambda: MeshFleetSimulation(cfg, make_lane_mesh(2)).run(
            seeds=range(101, 109)), ("grid_overlay_ticks",))
    for i, lane in enumerate(fr.lanes):
        solo = OverlaySimulation(cfg.replace(seed=101 + i),
                                 device="cuda").run()
        bad = overlay_equal(lane.final_state, solo.final_state,
                            lane.metrics, solo.metrics)
        if bad:
            raise AssertionError(f"8d overlay lane {i} != solo in {bad}")
    runs["fleet_churn65k_b8_lanes2"] = dict(
        wall_s=fr.wall_seconds, launches=counts,
        node_ticks_per_s=fr.aggregate_node_ticks_per_second)
    say(f"phase 8d: B=8 N=65,536 churn overlay fleet on 2 lane entries: "
        f"every lane == its solo run; wall {fr.wall_seconds:.2f} s, "
        f"{fr.aggregate_node_ticks_per_second:.4g} node-ticks/s aggregate")
    del fr
    cfg = trace_cfgs()["trace_n1024_drop"]
    fr, counts = main_path.drive(
        lambda: MeshFleetSimulation(cfg, make_lane_peer_mesh(2, 2)).run(
            seeds=range(4)), ("masked_max3/rect", "drop_masks_lanes"))
    for i, lane in enumerate(fr.lanes):
        bad = dense_lane_diff(lane, Simulation(cfg.replace(seed=i),
                                               device="cuda").run())
        if bad:
            raise AssertionError(f"8d 2-D trace lane {i} != solo in {bad}")
    runs["fleet_trace_n1024_b4_2x2"] = dict(wall_s=fr.wall_seconds,
                                            launches=counts)
    say(f"phase 8d: B=4 N=1024 trace on a 2x2 lanes x peers mesh (the "
        f"peer-sharded fleet tick, rectangular merges with a lane axis): "
        f"every lane == its solo run; wall {fr.wall_seconds:.2f} s; "
        f"launches {counts}")
    del fr
    mark("8d", t_start)

    # ---- 8e: serving on a mesh ----------------------------------------
    from gossip_protocol_tpu_torch.service import (grader_templates,
                                                   overlay_templates, replay)
    from gossip_protocol_tpu_torch.service.replay import (
        Template, build_trace, elastic_replay, run_sequential)
    # the first 8 seeds of 7b's stream (its trace is seed-major, so they
    # are a prefix of 7b's sequential leg)
    tpls = grader_templates() + overlay_templates(n=512, ticks=96)
    seeds = 8
    trace = build_trace(tpls, seeds)
    if seq7b is None:
        seq = run_sequential(trace, "cuda")
    else:
        # the prefix's results; its own sequential wall is not measured
        seq = (seq7b[0][:len(trace)], float("nan"))
    m, counts = main_path.drive(
        lambda: replay(tpls, seeds, max_batch=4, mesh=make_lane_mesh(2),
                       sequential=seq), ("masked_max3", "tick_epilogue"))
    no_failures("8e replay", {"failures": m["failures"]})
    runs["replay_lanes2"] = {k: m[k] for k in (
        "requests", "service_wall_s", "latency_p50_s", "latency_p99_s",
        "mean_occupancy", "dispatches")}
    say(f"phase 8e: the 7b replay ({m['requests']} requests) served from a "
        f"2-entry lane mesh: every result digest == its solo run; service "
        f"{m['service_wall_s']} s, p50 {m['latency_p50_s']} s, p99 "
        f"{m['latency_p99_s']} s")
    from gossip_protocol_tpu_torch.config import SimConfig
    churn_drop = SimConfig(max_nnb=512, model="overlay",
                           single_failure=False, drop_msg=True,
                           msg_drop_prob=0.1, seed=0, total_ticks=96,
                           churn_rate=0.2, rejoin_after=30,
                           step_rate=12 / 512, drop_open_tick=32,
                           drop_close_tick=64)
    etpls = [Template("churn-drop", churn_drop)] \
        + overlay_templates(n=512, ticks=96)[:1]
    em, counts = main_path.drive(
        lambda: elastic_replay(etpls, seeds_per_template=4, max_batch=1,
                               mesh=make_lane_mesh(4), checkpoint_every=32,
                               fault_seed=7), ("grid_overlay_ticks",))
    runs["elastic_lanes4"] = {k: em[k] for k in (
        "requests", "faults", "restarted_from_zero", "devices_start",
        "devices_end", "mean_legs", "schedule_digest", "outcome_digest",
        "service_wall_s")}
    runs["elastic_lanes4"]["lanes_migrated"] = em["elastic"]["lanes_migrated"]
    say(f"phase 8e: elastic_replay on 4 lane entries: gate passed (100% "
        f"complete, {em['faults']['device_loss']} loss and "
        f"{em['faults']['device_return']} return, 0 restarts, "
        f"{em['elastic']['lanes_migrated']} lanes migrated, "
        f"{em['devices_start']} -> {em['devices_end']} entries, parity)")
    mark("8e", t_start)
    # ---- 8f: the overlay worlds peer-sharded at full width -------------
    out["worlds"] = sharded_world_runs(main_path, dev, label)
    mark("8f", t_start)
    c_out, c_err = child.communicate(timeout=1100)
    if child.returncode != 0:
        raise AssertionError(f"8e: the load bench failed: {c_err[-3000:]}")
    lb = json.loads(c_out.strip().splitlines()[-1])
    mp = lb["mesh_point"]
    runs["load_openloop_smoke"] = {
        "capacity_probe_rps": lb["capacity_probe_rps"],
        "saturation_offered_rps": lb["saturation_offered_rps"],
        "points": [{k: r[k] for k in ("offered_rps", "achieved_rps",
                                      "latency_p50_s", "latency_p99_s",
                                      "deadline_miss_rate", "saturated")}
                   for r in lb["points"]],
        "replay_check": lb["replay_check"]["deterministic"],
        "mesh_point": {k: mp[k] for k in (
            "devices", "max_batch_per_device", "offered_rps",
            "achieved_rps", "latency_p50_s", "latency_p99_s")},
        "bench_wall_s": lb["bench_wall_s"]}
    say("phase 8e: load_openloop_bench(smoke=True) on cuda, in a second "
        "process beside 8a-8f: " + json.dumps(runs["load_openloop_smoke"]))
    out["runs"] = runs


def mesh_kernel_rows(m8: dict, main_path) -> list:
    """The kernels-line rows of phase 8's two contracts."""
    rr = m8["rect_real"]
    k3 = m8["k3_sharded"]["powerlaw1m_p4_t136"]
    err = max(v["max_abs_err"] for v in m8["rect"].values())
    return [
        {"name": "masked_max3/rect", "route": "cuda",
         "source": "gossip_protocol_tpu_torch/csrc/dense_tick.cu",
         "replaces": "gossip_protocol_tpu/parallel/comm.py:130",
         "launches": main_path.total["masked_max3/rect"],
         "max_abs_err": max(err, rr["max_abs_err"]), "ms": rr["ms"],
         "plain_ms": rr["plain_ms"], "bound_ms": rr["bound"][0],
         "bound_by": rr["bound"][1], "library_ms": None,
         "shape": {"r": rr["shape"][0], "s": rr["shape"][1],
                   "c": rr["shape"][2], "tick": rr["tick"],
                   "shards": rr["shards"]}},
        {"name": "fused_overlay_tick/sharded", "route": "cuda",
         "source": "gossip_protocol_tpu_torch/csrc/overlay_tick.cu",
         "replaces":
             "gossip_protocol_tpu/ops/pallas/overlay_exchange.py:267",
         "launches": main_path.total["fused_overlay_tick/sharded"],
         "max_abs_err": max(v["max_abs_err"]
                            for v in m8["k3_sharded"].values()),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
         "library_ms": None,
         "shape": {k: k3[k] for k in ("n", "shards", "nl", "k", "f",
                                      "row_start")}}]


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
    ap.add_argument("--sweep-seeds", type=int, default=2,
                    help="seeds a catalog family in phase 7g's sweep "
                         "(default 2: 50 variants, cut from 8 to make "
                         "room for phase 8; 40 is the JAX default of "
                         "1000)")
    ap.add_argument("--serving-only", action="store_true",
                    help="run only phase 1 and phase 7 (the fleet "
                         "service); no kernels line and no result line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only phase 1, phase 8 (multi-device "
                         "execution on a mesh of cuda:0 entries) and "
                         "phase 9 (the analysis); no kernels line and no "
                         "result line")
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
    if not (args.turns or only):
        # the native C++ engine phase 4b holds the port against
        from gossip_protocol_tpu_torch.compat import native
        tb = time.perf_counter()
        native.require()
        details["native_build_s"] = time.perf_counter() - tb
        say(f"phase 1: {native.LIB_NAME} built with make from native/ in "
            f"{details['native_build_s']:.1f} s")
    mark("1", t_start)
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
    if args.serving_only:
        details["phase7"] = serving(MainPath(), dev, args.profile,
                                    args.sweep_seeds, t_start)
        details["phase7"].pop("_seq7b")
        mark("7", t_start)
    if args.mesh_only:
        mp = MainPath()
        details["phase8"] = mesh_phase(mp, dev, t_start)
        say("phase 8 kernels: " + json.dumps(
            mesh_kernel_rows(details["phase8"], mp)))
        details["phase9"] = analysis_phase(dev)
        mark("9", t_start)
    if args.turns or only or args.serving_only or args.mesh_only:
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
    # the world draws: per-link thresholds, partition groups, both
    if "drop_masks" in wrappers():
        e, world_draws = world_draw_checks(dev)
        errs["drop_masks"] = max(errs["drop_masks"], e)
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
    mark("2 (solo kernels)", t_start)
    # the fleet's lane axis: masked_max3 and tick_epilogue on real states
    # of lanes with their own seeds and ticks (a silent lane among them),
    # and the lane-axis draw
    lane_k1 = {}
    for b, n, lanes in LANE_K1_CASES:
        r = compare_lane_k1(lane_k1_inputs(n, lanes, dev), t_remove=20)
        for k, v in r["err"].items():
            errs[k] = max(errs[k], v)
        lane_k1[f"b{b}_n{n}"] = r["deliveries"]
    errs["drop_masks_lanes"], lane_draws = lane_draw_checks(dev)
    details["lane_k1_deliveries"] = lane_k1
    say(f"phase 2: lane-axis masked_max3 + tick_epilogue (one launch each "
        f"for the lanes) at B,N = 3,10 4,64 8,512 4,2816, deliveries a "
        f"lane {json.dumps(lane_k1)}; {lane_draws} lane-axis draws")
    torch.cuda.synchronize()
    if any(v != 0 for v in errs.values()):
        raise AssertionError(f"kernel != plain version: {errs}")
    mark("2 (lane axis)", t_start)
    say(f"phase 2: kernels == plain versions bit for bit "
        f"(max abs err {errs}; {k5_checked} K5 launches; {world_draws} "
        f"world draws (thresholds, groups, both; window and partition "
        f"open and closed) at N=10..4096; boot pre-pass aggregate slots "
        f"checked {boot_slots})")
    details["max_abs_err_phase2"] = dict(errs)

    main_path = MainPath()
    mark("2", t_start)
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
    details["phase4_worlds"] = world_families_card_vs_cpu(main_path)
    mark("4", t_start)
    details["phase4b"] = independent_engines(main_path)
    mark("4b", t_start)

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
    # the worlds at full width: dense (5g) and overlay (5h)
    runs["worlds_dense"] = dense_world_runs(main_path)
    runs["worlds_overlay"] = overlay_world_runs(main_path)
    mark("5a-h", t_start)
    runs["fleet"] = fleet_runs(main_path)
    mark("5i", t_start)
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
        # the worlds: the K1 route at N=4096, the composable route at
        # N=1024 and the overlay worlds' per-tick route at N=65,536
        prof["asym4096"] = profile_run(
            lambda: Simulation(asym4096_cfg(), device="cuda")
            .run_bench(warmup=False))
        prof["dense_zombie_n1024"] = profile_run(
            lambda: Simulation(wide_family_cfg("dense_zombie", DENSE_WIDE),
                               device="cuda").run())
        prof["overlay_partition_heal_n65536"] = profile_run(
            lambda: OverlaySimulation(wide_family_cfg(
                "overlay_partition_heal", 65536), device="cuda").run())
        # the two fleets, profiled in phase 5i
        prof["fleet_bench_n4096_b4"] = \
            runs["fleet"]["bench_n4096_b4"]["profile"]
        prof["overlay_fleet_churn65k_b8"] = \
            runs["fleet"]["overlay_churn65k_b8"]["profile"]
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
    mark("5", t_start)

    # ---- phase 6: kernel times on real launch inputs ------------------
    # Each kernel is timed, and held against its plain version, on the
    # input of a launch the main path makes: the run is stopped one
    # launch early and the next launch's input is built as the run
    # builds it.
    timing = dense_timing(dev, describe=True)
    timing.update(world_timing(dev))
    timing["fleet"] = fleet_timing(dev)
    for name, tm in timing["fleet"].items():
        key = "drop_masks_lanes" if name == "drop_masks" else name
        errs[key] = max(errs[key], tm["max_abs_err"])
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
                               ("draw_t300", "draw_t699", "draw_stack",
                                "draw_asym4096")))
    for name in ("masked_max3", "tick_epilogue"):
        errs[name] = max(errs[name],
                         timing["k1_asym4096"]["max_abs_err"][name])
    if any(v != 0 for v in errs.values()):
        raise AssertionError(f"kernel != plain on a launch input: {errs}")
    details["timing"] = timing
    details["max_abs_err"] = errs
    mark("6", t_start)

    # ---- phase 7: the fleet service on the card ----------------------
    serve = serving(main_path, dev, args.profile, args.sweep_seeds,
                    t_start)
    seq7b = serve.pop("_seq7b")
    details["phase7"] = serve
    ctm = serve["canonical"]["timing"]
    if ctm["max_abs_err"] != 0:
        raise AssertionError(f"the corner draw != plain: {ctm}")
    mark("7", t_start)

    # ---- phase 8: multi-device execution on a mesh of one process -----
    m8 = mesh_phase(main_path, dev, t_start, seq7b)
    del seq7b
    details["phase8"] = m8
    details["main_path_launches"] = main_path.total
    mark("8", t_start)

    # ---- phase 9: the port's analysis on the card ----------------------
    details["phase9"] = analysis_phase(dev)
    mark("9", t_start)
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
    # the world inputs at N=4096 (the asym4096 run): their own rows, with
    # that run's launches
    asym = runs["worlds_dense"]["asym4096"]["launches"]
    for name, tm, shape in (
            ("drop_masks", timing["draw_asym4096"],
             {"n": 4096, "tick": 300, "s_ticks": 1, "world": "asym"}),
            ("masked_max3", timing["k1_asym4096"]["masked_max3"],
             {"n": 4096, "tick": 699, "world": "asym"}),
            ("tick_epilogue", timing["k1_asym4096"]["tick_epilogue"],
             {"n": 4096, "tick": 699, "world": "asym"})):
        base = next(k for k in kernels if k["name"] == name)
        kernels.append({
            **base, "name": f"{name}/asym4096", "launches": asym[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None, "shape": shape})
    # the lane-axis launches of the fleets (phase 5i): rows of their own;
    # the solo rows keep the solo launches
    lane = {k: v + serve["lane_axis"].get(k, 0) + m8["lane_axis"].get(k, 0)
            for k, v in runs["fleet"]["lane_axis_launches"].items()}
    # the canonical rung's corner draws have a row of their own
    lane["drop_masks_lanes"] -= serve["canonical"]["draws"]
    for name, wrapper in (("masked_max3", "masked_max3"),
                          ("tick_epilogue", "tick_epilogue"),
                          ("drop_masks", "drop_masks_lanes"),
                          ("grid_overlay_ticks", "grid_overlay_ticks")):
        tm = timing["fleet"][name]
        base = next(k for k in kernels if k["name"] == name)
        if wrapper != "drop_masks_lanes":
            base["launches"] -= lane[wrapper]
        kernels.append({
            **base, "name": f"{name}/fleet", "launches": lane[wrapper],
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None,
            "shape": {k: tm[k] for k in ("n", "batch", "tick", "s_ticks")
                      if k in tm}})
        kernels[-1].pop("needed_bytes_bound_ms", None)
    base = next(k for k in kernels if k["name"] == "drop_masks")
    kernels.append({
        **base, "name": "drop_masks/canonical",
        "launches": serve["canonical"]["draws"],
        "max_abs_err": ctm["max_abs_err"], "ms": ctm["ms"],
        "plain_ms": ctm["plain_ms"], "bound_ms": ctm["bound"][0],
        "bound_by": ctm["bound"][1], "library_ms": None,
        "shape": {k: ctm[k] for k in ("n", "na", "batch", "tick")}})
    # the ring's rectangular merges and K3's sharded launches (phase 8)
    # have rows of their own
    for name, sub in (("masked_max3", "masked_max3/rect"),
                      ("fused_overlay_tick", "fused_overlay_tick/sharded")):
        next(k for k in kernels if k["name"] == name)["launches"] -= \
            main_path.total[sub]
    kernels += mesh_kernel_rows(m8, main_path)
    for key in ("k1", "k1_n1024", "k1_n10", "k1_asym4096"):
        t = timing[key]
        say(f"phase 6: masked_max3 at N={t['n']}, tick {t['tick']}: "
            f"{json.dumps(t['merge_stats'])}")
    say("phase 6: overlay kernels (ms; bound ms): " + json.dumps(
        overlay_numbers({"timing": timing, "phase5": {}})))
    say(f"phase 6: timed {len(kernels)} kernels on real launch inputs; "
        f"details {json.dumps(timing)}")
    say(json.dumps({"kernels": kernels}))
    details["kernels"] = kernels

    details["phase_seconds"] = PHASE_SECONDS
    details["seconds"] = time.perf_counter() - t_start
    if args.details:
        write_details(args.details, details)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

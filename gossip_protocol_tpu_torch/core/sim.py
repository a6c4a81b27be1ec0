"""Simulation orchestrator (counterpart of ``gossip_protocol_tpu/core/sim.py``).

Modes:
* trace mode (``run()``)  — per-tick event masks come back to the host
  for the dbg.log writer and the grader.  Chunked over ticks so the
  masks staged on the device stay near 1 GB (the JAX chunk rule).
* bench mode (``run_bench()``) — counters only; the whole run stays on
  the device and is timed end to end, with a device synchronize inside
  the timed region.

Each chunk's masks are copied to the host directly; the JAX package's
sparse packing (``_pack_sparse``) is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig
from ..events import LogEvent, event_stream, grader_view
from ..state import WorldState, init_state, make_schedule, resolve_device
from .tick import make_run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class SimResult:
    """Host-side digest of a finished run (or resumed run segment)."""

    cfg: SimConfig
    start_tick: np.ndarray   # i32[N]
    fail_tick: np.ndarray    # i32[N]
    rejoin_tick: np.ndarray  # i32[N] (NEVER = no churn rejoin)
    added: Optional[np.ndarray]    # bool[T, N, N] (trace mode only)
    removed: Optional[np.ndarray]  # bool[T, N, N]
    sent: np.ndarray         # i32[N, T]
    recv: np.ndarray         # i32[N, T]
    final_state: WorldState
    wall_seconds: float
    first_tick: int = 0      # absolute tick of added[0] (0 unless resumed)
    resumed: bool = False    # True for a continuation segment
    #: width at which the run drew its drop stream (None: full width);
    #: see core/dense_corner.py bench_stream_width
    counter_stream_width: Optional[int] = None

    def events(self) -> list[LogEvent]:
        if self.added is None:
            raise ValueError("events need a trace-mode run")
        return list(event_stream(self.cfg, self.start_tick, self.fail_tick,
                                 self.added, self.removed,
                                 first_tick=self.first_tick,
                                 rejoin_tick=self.rejoin_tick))

    def grader_view(self) -> dict:
        return grader_view(self.events())

    def write_logs(self, outdir: str = ".") -> None:
        from ..logging_compat import write_dbg_log, write_msgcount_log
        write_dbg_log(self.events(), outdir)
        write_msgcount_log(self.sent, self.recv, outdir)

    @property
    def ticks_run(self) -> int:
        return self.sent.shape[1]

    @property
    def ticks_per_second(self) -> float:
        if self.ticks_run == 0 or self.wall_seconds <= 0.0:
            return 0.0
        return self.ticks_run / self.wall_seconds

    @property
    def node_ticks_per_second(self) -> float:
        return self.ticks_per_second * self.cfg.n


class Simulation:
    """Run a config on one device (``cuda`` unless ``device="cpu"``)."""

    def __init__(self, cfg: SimConfig, device=None,
                 chunk_ticks: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if chunk_ticks is None:
            per_tick = 2 * cfg.n * cfg.n  # two bool masks
            chunk_ticks = max(1, min(cfg.total_ticks,
                                     (1 << 30) // max(per_tick, 1)))
        self.chunk_ticks = chunk_ticks

    def run(self, seed: Optional[int] = None,
            resume_from: Optional[WorldState] = None,
            ticks: Optional[int] = None) -> SimResult:
        """Trace-mode run: full event masks for logging and grading.

        ``resume_from`` continues a previous (possibly checkpointed)
        state; ``ticks`` stops the segment early.  Same contract as the
        JAX ``Simulation.run``.
        """
        if seed is not None and resume_from is not None:
            raise ValueError(
                "seed and resume_from are mutually exclusive: a reseeded "
                "schedule would not be the one that produced the resumed "
                "state")
        cfg = self.cfg if seed is None else self.cfg.replace(seed=seed)
        sched = make_schedule(cfg, self.device)
        state = init_state(cfg, self.device) if resume_from is None \
            else resume_from
        first = state.tick
        t_end = cfg.total_ticks if ticks is None \
            else min(cfg.total_ticks, first + ticks)
        added, removed, sent, recv = [], [], [], []
        t0 = time.perf_counter()
        done = first
        while done < t_end:
            length = min(self.chunk_ticks, t_end - done)
            run = make_run(cfg.replace(total_ticks=length), with_events=True)
            state, ev = run(state, sched)
            added.append(ev.added.cpu().numpy())
            removed.append(ev.removed.cpu().numpy())
            sr = torch.stack([ev.sent, ev.recv]).cpu().numpy()
            sent.append(sr[0])
            recv.append(sr[1])
            done += length
        _sync(self.device)
        wall = time.perf_counter() - t0
        n = cfg.n
        if not added:   # zero-length segment (already at/after t_end)
            added = [np.zeros((0, n, n), bool)]
            removed = [np.zeros((0, n, n), bool)]
            sent = [np.zeros((0, n), np.int32)]
            recv = [np.zeros((0, n), np.int32)]
        host = make_schedule_columns(sched)
        return SimResult(
            cfg=cfg, **host,
            added=np.concatenate(added, 0),
            removed=np.concatenate(removed, 0),
            sent=np.concatenate(sent, 0).T.copy(),
            recv=np.concatenate(recv, 0).T.copy(),
            final_state=state, wall_seconds=wall, first_tick=first,
            resumed=resume_from is not None)

    def run_bench(self, seed: Optional[int] = None,
                  warmup: bool = True) -> SimResult:
        """Bench-mode run from tick 0, timed end to end (the device is
        synchronized inside the timed region).  ``warmup`` first runs
        the same config once untimed (the kernels' first-use build and
        the caching allocator's growth land there)."""
        from .dense_corner import bench_stream_width
        cfg = self.cfg if seed is None else self.cfg.replace(seed=seed)
        sched = make_schedule(cfg, self.device)
        run = make_run(cfg, with_events=False)
        if warmup:
            run(init_state(cfg, self.device), sched)
            _sync(self.device)
        state = init_state(cfg, self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        state, ev = run(state, sched)
        _sync(self.device)
        if state.tick != cfg.total_ticks:
            raise RuntimeError("bench run did not complete all ticks")
        wall = time.perf_counter() - t0
        return SimResult(
            cfg=cfg, **make_schedule_columns(sched), added=None, removed=None,
            sent=ev.sent.cpu().numpy().T.copy(),
            recv=ev.recv.cpu().numpy().T.copy(),
            final_state=state, wall_seconds=wall,
            counter_stream_width=bench_stream_width(cfg))


def make_schedule_columns(sched) -> dict:
    """The schedule's per-peer columns as host numpy (for SimResult)."""
    return {k: getattr(sched, k).cpu().numpy()
            for k in ("start_tick", "fail_tick", "rejoin_tick")}


def run_scenario(cfg: SimConfig, outdir: Optional[str] = None,
                 device=None, **sim_kw) -> SimResult:
    """One-call helper: simulate and (optionally) write the three logs."""
    result = Simulation(cfg, device=device, **sim_kw).run()
    if outdir is not None:
        result.write_logs(outdir)
    return result

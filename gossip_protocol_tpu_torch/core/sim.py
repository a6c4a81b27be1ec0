"""Simulation orchestrator (counterpart of ``gossip_protocol_tpu/core/sim.py``).

Modes:
* trace mode (``run()``)  — per-tick event masks come back to the host
  for the dbg.log writer and the grader.  Chunked over ticks so the
  masks staged on the device stay near 1 GB (the JAX chunk rule).
* bench mode (``run_bench()``) — counters only; the whole run stays on
  the device and is timed end to end, with a device synchronize inside
  the timed region.

Each chunk's masks cross to the host sparse (the JAX package's
``_pack_sparse`` rule, as torch operations): the subject axis is
bit-packed into int32 words, the nonzero words are compacted on the
device without a sync, and only they cross, through pinned host
buffers; a chunk denser than the word cap falls back to the dense copy.
The fleet (core/fleet.py) stages a whole ``(chunk * lanes, N, N)`` stack
this way once a chunk.
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


def record_event(device: torch.device, timing: bool = False):
    """A CUDA event recorded on the device's stream (None on the CPU,
    where every operation has finished when it returns); ``timing``
    makes it one that ``elapsed_time`` can read."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=timing)
    ev.record(torch.cuda.current_stream(device))
    return ev


def to_host_async(x: torch.Tensor) -> torch.Tensor:
    """Start the copy of a device tensor into a pinned host buffer
    (non-blocking; valid once the stream reaches it).  A CPU tensor is
    returned as it is."""
    if x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


def _packbits(m: torch.Tensor) -> torch.Tensor:
    """bool[C, N, N] -> the subject axis packed into int32 words, flat
    [C * N * ceil(N / 32)]: bit b of word w is subject 32 w + b (eight
    bits a byte, four little-endian bytes a word)."""
    c, n, _ = m.shape
    nw = (n + 31) // 32
    u = m.to(torch.uint8)
    if nw * 32 != n:
        u = torch.nn.functional.pad(u, (0, nw * 32 - n))
    # 1, 2, 4, ... 128, made on the device (no host copy)
    weights = torch.pow(2, torch.arange(8, dtype=torch.int32,
                                        device=m.device)).to(torch.uint8)
    packed = (u.view(c, n, nw * 4, 8) * weights).sum(-1, dtype=torch.uint8)
    return packed.view(torch.int32).reshape(-1)


def _pack_sparse(added: torch.Tensor, removed: torch.Tensor, cap: int):
    """Device-side sparse encoding of two (C, N, N) bool event masks (the
    JAX ``core/sim.py _pack_sparse``): the packed words of both, and the
    first ``cap`` nonzero ones compacted.  Returns ``(idx i32[cap], vals
    i32[cap], nz_words)``, all on the device, with no sync (the
    compaction is a prefix sum and a scatter, not a data-dependent
    shape); if ``nz_words > cap`` the caller falls back to the dense
    copy (correctness never depends on the cap)."""
    flat = torch.cat([_packbits(added), _packbits(removed)])
    nz = flat != 0
    nzw = nz.sum()
    pos = torch.cumsum(nz, 0) - 1
    # nonzero word k goes to slot pos[k] < cap; everything else to the
    # spare slot cap, which is dropped
    slot = torch.where(nz & (pos < cap), pos, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=flat.device)
    idx.scatter_(0, slot, torch.arange(flat.numel(), device=flat.device))
    idx = idx[:cap]
    return idx.to(torch.int32), flat[idx], nzw


def _finish_masks_host(added, removed, idx, vals, nzw, cap: int):
    """Host half of the sparse mask transfer: consume the outputs of
    :func:`_pack_sparse` (``nzw`` may already be a host tensor) and
    unpack to numpy; the dense copy of the masks when the realized
    nonzero count overflowed the cap."""
    c, n, _ = added.shape
    nzw = int(nzw)
    if nzw > cap:                       # denser than the sparse budget
        return added.cpu().numpy(), removed.cpu().numpy()
    pair = torch.stack([idx[:nzw], vals[:nzw]])
    pair = to_host_async(pair)
    if added.device.type == "cuda":
        torch.cuda.current_stream(added.device).synchronize()
    pair = pair.numpy()
    nw = (n + 31) // 32
    # only the nonzero words are unpacked: word w of row r (of the 2c n
    # rows of both stacks) holds subjects 32 w .. 32 w + 31
    bits = np.unpackbits(pair[1].view(np.uint32).view(np.uint8)
                         .reshape(-1, 4), axis=1, bitorder="little")
    k, b = np.nonzero(bits)
    row, word = np.divmod(pair[0][k].astype(np.int64), nw)
    both_h = np.zeros((2 * c * n, n), bool)
    both_h[row, word * 32 + b] = True
    both_h = both_h.reshape(2 * c, n, n)
    return both_h[:c], both_h[c:]


def _masks_to_host(added, removed, cap: int):
    """Two (C, N, N) bool masks on the device -> host numpy, sparse when
    possible (one compaction pass over both)."""
    c, n, _ = added.shape
    if c == 0 or n < 2:
        return added.cpu().numpy(), removed.cpu().numpy()
    idx, vals, nzw = _pack_sparse(added, removed, cap=cap)
    return _finish_masks_host(added, removed, idx, vals, nzw, cap)


def sparse_cap(length: int, n: int) -> int:
    """The compaction's word cap for ``length`` tick planes (the JAX
    rule: a sixteenth of the packed words, at least 2^14)."""
    nw = (n + 31) // 32
    return max(1 << 14, (2 * length * n * nw) // 16)


def counters_to_host(sent: torch.Tensor, recv: torch.Tensor) -> np.ndarray:
    """(sent, recv) stacked and copied in one transfer; int16 where the
    counters fit (N <= 8192: a tick's counts are bounded by ~2N), as
    the JAX package copies them."""
    sr = torch.stack([sent, recv])
    if sent.shape[-1] <= 8192:
        sr = sr.to(torch.int16)
    return sr.cpu().numpy().astype(np.int32, copy=False)


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
            # sparse device -> host event staging
            a_h, r_h = _masks_to_host(ev.added, ev.removed,
                                      sparse_cap(length, cfg.n))
            added.append(a_h)
            removed.append(r_h)
            sr = counters_to_host(ev.sent, ev.recv)
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

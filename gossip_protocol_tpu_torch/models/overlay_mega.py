"""Host harness of the multi-tick overlay kernel (port of
``gossip_protocol_tpu/models/overlay_mega.py``).

Packs an :class:`~.overlay.OverlayState` and the loop-invariant
schedule columns into K4's (N, 2K+16) plane, runs whole-SLOT_EPOCH
launches of ``ops/cuda/overlay_mega.py mega_overlay_ticks`` (16 ticks a
call, then one remainder launch), and unpacks into the same
``(final_state, OverlayMetrics[T])`` contract as
:func:`~.overlay.make_overlay_run`.  Per-tick ``live_uncovered`` is the
"not tracked" sentinel -1, as on the TPU; coverage is checked on the
final state (``OverlayResult.final_coverage``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..ops.cuda.overlay_mega import (AUX_LANES, MEGA_TICKS, MET_ADDS,
                                     MET_FALSE_REMOVALS, MET_IN_GROUP,
                                     MET_RECV, MET_REMOVALS, MET_SENT,
                                     MET_VICTIM, MET_VIEW, mega_overlay_ticks,
                                     pack_plane, unpack_plane)
from ..ops.overlay_rules import (OverlaySchedule, OverlayState, as_i32,
                                 exchange_mask)
from .overlay import (OverlayMetrics, resolved_dims, schedule_columns,
                      tick_flags)

#: largest N routed to K4 (the JAX package's hardware-verified envelope,
#: kept so that both packages route the same configs)
MEGA_N_LIMIT = 4096


def mega_supported(cfg: SimConfig) -> bool:
    """Whether K4 covers this config: power-of-two 8 <= N <= 4096,
    2K+16 <= 128, F <= 7, runs of at most 4094 ticks, no world."""
    n = cfg.n
    k, f = resolved_dims(cfg)
    return (cfg.model == "overlay" and n & (n - 1) == 0 and 8 <= n
            and n <= MEGA_N_LIMIT and 2 * k + AUX_LANES <= 128 and f <= 7
            and cfg.total_ticks <= 4094
            and not cfg.has_worlds and not cfg.has_latency)


def _pack_state(cfg: SimConfig, state: OverlayState,
                sched: OverlaySchedule) -> torch.Tensor:
    """OverlayState + schedule columns -> the (N, 2K+16) plane."""
    c = schedule_columns(sched, cfg.n, state.device)
    return pack_plane(state.ids, state.hb, state.ts, state.in_group,
                      state.own_hb, state.joinreq, state.joinrep,
                      state.send_flags, c.start, c.fail, c.rejoin, c.deg)


def _unpack_state(cfg: SimConfig, plane: torch.Tensor,
                  tick: int) -> OverlayState:
    k, f = resolved_dims(cfg)
    return OverlayState(
        tick=tick, send_hist=torch.zeros((cfg.n, f), dtype=torch.int32,
                                         device=plane.device),
        **unpack_plane(plane, k, f))


def _sp_vector(cfg: SimConfig, sched: OverlaySchedule, t0: int,
               s_ticks: int, n: int, f: int) -> np.ndarray:
    """K4's scalars (int32 bits) and the launch's (S, F) XOR masks."""
    intro = torch.zeros(1, dtype=torch.int64)
    scalars = [t0, sched.seed, sched.victim_lo, sched.victim_hi,
               sched.fail_tick, sched.rejoin_after, sched.churn_thr,
               sched.churn_after, int(sched.drop_on), sched.drop_open,
               sched.drop_close, sched.drop_thr,
               int(sched.fail_of(intro)[0]), int(sched.rejoin_of(intro)[0])]
    masks = [exchange_mask(sched.seed, t0 + s - 1, fi, n)
             for s in range(s_ticks) for fi in range(f)]
    return np.array([as_i32(v) for v in scalars + masks], np.int32)


def mega_kernel_kwargs(cfg: SimConfig, sched: OverlaySchedule) -> dict:
    """K4's static arguments for a run of ``cfg`` under ``sched`` (all
    but ``s_ticks``): the churn window is the schedule's."""
    k, f = resolved_dims(cfg)
    return dict(n=cfg.n, k=k, f_rounds=f, t_remove=cfg.t_remove,
                churn_lo=sched.churn_lo, churn_span=sched.churn_span,
                **tick_flags(cfg))


def make_mega_run(cfg: SimConfig, length: int):
    """``run(state, sched) -> (final, OverlayMetrics[length])`` through
    whole-SLOT_EPOCH K4 launches and one remainder launch; ``run.stage``
    packs the plane and ``run.enqueue`` launches
    (:func:`~.overlay.make_overlay_run`)."""
    if not mega_supported(cfg):
        raise ValueError("config outside the K4 envelope (mega_supported)")
    n = cfg.n
    f = resolved_dims(cfg)[1]
    n_full, rem = divmod(length, MEGA_TICKS)

    def stage(state: OverlayState, sched: OverlaySchedule):
        return [_pack_state(cfg, state, sched), state.tick, sched]

    def enqueue(staged):
        plane, t, sched = staged
        staged.clear()
        kern_kw = mega_kernel_kwargs(cfg, sched)
        parts = []
        for s_ticks in [MEGA_TICKS] * n_full + ([rem] if rem else []):
            sp = _sp_vector(cfg, sched, t, s_ticks, n, f)
            plane, met = mega_overlay_ticks(plane, sp, s_ticks=s_ticks,
                                            **kern_kw)
            parts.append(met)
            t += s_ticks
        met = torch.cat(parts) if parts else torch.zeros(
            (0, 128), dtype=torch.int32, device=plane.device)
        metrics = OverlayMetrics(
            in_group=met[:, MET_IN_GROUP], view_slots=met[:, MET_VIEW],
            adds=met[:, MET_ADDS], removals=met[:, MET_REMOVALS],
            false_removals=met[:, MET_FALSE_REMOVALS],
            victim_slots=met[:, MET_VICTIM],
            live_uncovered=torch.full((length,), -1, dtype=torch.int32,
                                      device=plane.device),
            sent=met[:, MET_SENT], recv=met[:, MET_RECV])
        return _unpack_state(cfg, plane, t), metrics

    def run(state: OverlayState, sched: OverlaySchedule):
        return enqueue(stage(state, sched))

    run.stage, run.enqueue = stage, enqueue
    return run

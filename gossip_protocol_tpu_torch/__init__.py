"""gossip_protocol_tpu_torch — the gossip simulator in PyTorch, with
hand-written CUDA kernels for the H100.

A port of ``gossip_protocol_tpu`` (the JAX/Pallas package, which stays
the reference).  The dense full-view model's state is a handful of
tensors and one tick is a few kernel launches: the three gossip merge
maxima (``masked_max3``), the post-merge epilogue (``tick_epilogue``,
the TPU's K1) and, for N <= 512 (1024 in bench mode),
``dense_mega_ticks`` (K2), 16 or 8 whole ticks per call.  The bounded
partial-view overlay (``models/overlay.py``, up to N = 2^20) runs 16
whole ticks per call in ``mega_overlay_ticks`` (K4) for N <= 4096 and
in ``grid_overlay_ticks`` (K5, with the schedule's dead phases left out
per launch) above it; ``fused_overlay_tick`` (K3) runs one tick's whole
(N, K) phase on the per-tick route that remains for the other configs.
Runs go to the card unless ``device="cpu"`` is asked for; on the CPU
every kernel runs its plain PyTorch version.  Multi-device execution
(``parallel/``, ``models/overlay_sharded.py``) runs on a mesh of one
process whose entries may repeat a device: peer-sharded dense and
overlay runs, meshes of fleets, and elastic serving from a mesh.

This package never imports JAX or ``gossip_protocol_tpu``.
"""

from .config import (INTRODUCER, MSG_DROP_SINGLE_FAILURE, MULTI_FAILURE,
                     SINGLE_FAILURE, SimConfig)
from .state import (Schedule, WorldState, init_state, load_checkpoint,
                    make_schedule, make_schedule_host, save_checkpoint,
                    state_from_host, state_to_host)

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "INTRODUCER",
    "SINGLE_FAILURE", "MULTI_FAILURE", "MSG_DROP_SINGLE_FAILURE",
    "WorldState", "Schedule", "init_state", "make_schedule",
    "make_schedule_host", "state_to_host", "state_from_host",
    "save_checkpoint", "load_checkpoint", "Simulation", "run_scenario",
]


def __getattr__(name):
    if name in ("Simulation", "run_scenario"):
        from .core import sim
        return getattr(sim, name)
    raise AttributeError(name)

"""The port against the benchmark's plain overlay reference
(``benchmark/reference/overlay.py``) at the shapes of the
``overlay1m-powerlaw`` configuration, on the CPU.

The configuration's own file, cut to N in {64, 256} and 64 ticks with
the single failure at T/2: power-law out-degrees (alpha 2.5) at the
resolved F = 8 exchange rounds, K auto.  ``OverlaySimulation`` runs it on
its default route, K5 (outside K4's F <= 7; the plain twin on CPU
tensors), and on the per-tick route; every field the benchmark's check
compares is equal, value for value.  One seed of each N puts the victim
on a degree-8 hub, which sends on every round.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.check import overlay_mismatches
from benchmark.reference import overlay as ref
from benchmark.reference.prims import victim_draw
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models.overlay import (OverlaySimulation,
                                                      resolved_dims)
from gossip_protocol_tpu_torch.models.overlay_grid import grid_supported
from gossip_protocol_tpu_torch.models.overlay_mega import mega_supported
from gossip_protocol_tpu_torch.utils import spans

torch.set_num_threads(2)

with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "benchmark", "configs", "overlay1m-powerlaw.json")) as _f:
    CELL = json.load(_f)
TICKS = 64
#: (N, seed, whether the seed's victim is a degree-8 hub)
CASES = [(64, 30, True), (64, 1902160583, False), (256, 1, True),
         (256, 2071723519, False)]


def _conf(n: int, seed: int) -> dict:
    """The cell's configuration at N peers and 64 ticks: every peer
    started by tick 16, the failure at T/2, detected within the run."""
    return dict(CELL, max_nnb=n, total_ticks=TICKS, fail_tick=TICKS // 2,
                step_rate=16 / n, seed=seed)


def _sim_config(conf: dict) -> SimConfig:
    fields = set(SimConfig.__dataclass_fields__)
    return SimConfig(**{k: v for k, v in conf.items() if k in fields})


@pytest.mark.parametrize("route", ["k5", "per_tick"])
@pytest.mark.parametrize("n,seed,hub", CASES)
def test_the_port_equals_the_reference_at_powerlaw_shapes(n, seed, hub,
                                                          route):
    conf = _conf(n, seed)
    cfg = _sim_config(conf)
    assert resolved_dims(cfg)[1] == ref.dims(conf)[1] == 8
    assert grid_supported(cfg) and not mega_supported(cfg)
    sched = ref.Schedule(conf, seed, "cpu")
    victim = int(victim_draw(seed) * n) % n
    assert (int(sched.deg[victim]) == 8) == hub
    assert int(sched.start[victim]) < conf["fail_tick"]
    spans.clear()
    with spans.enable():
        res = OverlaySimulation(cfg, device="cpu",
                                per_tick=route == "per_tick").run()
    launches = spans.snapshot()["counters"].get("solo.k5_launches", 0)
    spans.clear()
    assert launches == (TICKS // 16 if route == "k5" else 0)
    want = ref.run_lane(conf, seed, "cpu")
    assert overlay_mismatches(res, want) == 0
    # the degree gate held sends back: fewer (row, round) sends than F
    # rounds of every member, and the victim's entries left the views
    m = res.metrics
    assert 0 < m.sent[-1] < 8 * m.in_group[-1]
    assert m.victim_slots[TICKS // 2 + 1] > 0 and m.victim_slots[-1] == 0
    assert np.array_equal(m.recv, want["metrics"][:, -1].numpy())

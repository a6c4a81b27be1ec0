"""The K1 route's vector step (``ops/vector.py fused_vector_step``) on the
CPU: the fleet tick that takes it equals each lane's solo K1 tick bit for
bit, its call counter shows the route, and its inputs reach it in the
layout the kernel takes.

On the CPU the wrapper calls the plain ``vector_step``; the kernel itself
is held to it on the card (tests/test_torch_cuda.py).  The fleet tick
there also leaves the join accounting to ``tick_epilogue(rows=)``, which
these runs exercise: every counter of every lane is compared.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core import fleet
from gossip_protocol_tpu_torch.core import tick as ptick
from gossip_protocol_tpu_torch.core.dense_corner import active_bound
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.core.tick import make_tick_run
from gossip_protocol_tpu_torch.ops import vector as pvector
from gossip_protocol_tpu_torch.ops.vector import (VectorStep,
                                                  fused_vector_step)
from gossip_protocol_tpu_torch.state import init_state, make_schedule

torch.set_num_threads(2)

DENSE_STATE = ("in_group", "own_hb", "known", "hb", "ts", "gossip",
               "gossip_age", "joinreq", "joinrep")

#: the flags the kernel takes: the course worlds (drop, failures), churn
#: (``rejoin_after``) and flap
WORLDS = {
    "drop_multifailure": dict(max_nnb=24, single_failure=False,
                              drop_msg=True, msg_drop_prob=0.1,
                              total_ticks=80, fail_tick=30,
                              drop_open_tick=10, drop_close_tick=60),
    "churn": dict(max_nnb=32, single_failure=False, drop_msg=False,
                  total_ticks=70, fail_tick=20, rejoin_after=15),
    "flap": dict(max_nnb=24, single_failure=True, drop_msg=True,
                 msg_drop_prob=0.1, total_ticks=90, fail_tick=40,
                 flap_rate=0.3, flap_period=12, flap_down=4,
                 flap_open_tick=20, flap_close_tick=70),
}


def _eq(a, b, what):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


def _solo_k1(cfg):
    """One lane through the solo K1 tick (``make_tick``, per tick)."""
    run = make_tick_run(cfg, with_events=True)
    return run(init_state(cfg, "cpu"), make_schedule(cfg, "cpu"))


@pytest.mark.parametrize("world,b,nr", [
    ("drop_multifailure", 3, 3), ("drop_multifailure", 8, 5),
    ("churn", 8, 8), ("flap", 3, 2), ("flap", 8, 8)])
def test_fleet_k1_tick_equals_solo_k1_ticks(world, b, nr):
    """B lanes of the fleet tick (one vector step a tick for all of them)
    == each lane's solo K1 tick over the whole run: events, per-peer
    per-tick counters, final state; the wrapper is called once a fleet
    tick."""
    cfg = SimConfig(seed=0, **WORLDS[world])
    seeds = [11 + 7 * i for i in range(b)]
    before = fused_vector_step.calls
    got = fleet.FleetSimulation(cfg, device="cpu").run(
        seeds=seeds, n_real=nr, warmup=False)
    assert fused_vector_step.calls - before == cfg.total_ticks
    assert got.batch == nr
    for i in range(nr):
        lane = cfg.replace(seed=seeds[i])
        before = fused_vector_step.calls
        st, ev = _solo_k1(lane)
        assert fused_vector_step.calls - before == cfg.total_ticks
        ctx = f"{world} lane {i}"
        _eq(got.lanes[i].added, ev.added, f"{ctx}: added")
        _eq(got.lanes[i].removed, ev.removed, f"{ctx}: removed")
        _eq(got.lanes[i].sent, ev.sent.T, f"{ctx}: sent")
        _eq(got.lanes[i].recv, ev.recv.T, f"{ctx}: recv")
        for f in DENSE_STATE:
            _eq(getattr(got.lanes[i].final_state, f), getattr(st, f),
                f"{ctx}: state {f}")


def test_bench_corner_fleet_equals_solo_corner_runs():
    """The dense sweep's path at a small size: a bench fleet on the active
    corner (``launch_bench``) == each lane's solo bench run, which takes
    the solo K1 tick on the same corner; one vector step a fleet tick."""
    cfg = SimConfig(max_nnb=256, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, total_ticks=30, fail_tick=15,
                    drop_open_tick=5, drop_close_tick=25, seed=0)
    assert active_bound(cfg) == 128
    seeds = [101, 202, 303]
    sim = fleet.FleetSimulation(cfg, device="cpu")
    before = fused_vector_step.calls
    got = sim.launch_bench(seeds=seeds, warmup=False).resolve()
    assert fused_vector_step.calls - before == cfg.total_ticks
    for i, s in enumerate(seeds):
        solo = Simulation(cfg.replace(seed=s), device="cpu").run_bench(
            warmup=False)
        for f in ("sent", "recv"):
            _eq(getattr(got.lanes[i], f), getattr(solo, f), f"lane {i} {f}")
        for f in DENSE_STATE:
            _eq(getattr(got.lanes[i].final_state, f),
                getattr(solo.final_state, f), f"lane {i}: state {f}")


@pytest.mark.parametrize("route", ["composable", "overlay"])
def test_wrapper_still_off_the_k1_route(route):
    """The composable worlds (zombie: their torch phases read the plain
    step) and the overlay fleet (K5) never call the wrapper."""
    if route == "composable":
        cfg = SimConfig(max_nnb=16, single_failure=True, drop_msg=False,
                        seed=2, total_ticks=60, fail_tick=30, zombie=True)
    else:
        cfg = SimConfig(max_nnb=64, model="overlay", single_failure=False,
                        drop_msg=False, seed=0, total_ticks=48,
                        churn_rate=0.25, rejoin_after=16, step_rate=8.0 / 64)
    before = fused_vector_step.calls
    res = fleet.FleetSimulation(cfg, device="cpu").run(seeds=[2, 3],
                                                       warmup=False)
    assert res.batch == 2
    assert fused_vector_step.calls == before


def _kernel_layout(args, kw):
    """The inputs as the kernel's wrapper checks them on a card: int32
    schedule columns and own heartbeats, bool lanes and draws, one shape,
    each contiguous."""
    t, *cols = args
    assert isinstance(t, int)
    shape = cols[3].shape
    for x, dt in zip(cols, (torch.int32,) * 3 + (torch.bool, torch.int32)
                     + (torch.bool,) * 4):
        assert x.dtype == dt and x.shape == shape and x.is_contiguous()
    for f in kw.get("flap") or ():
        assert f.dtype == torch.bool and f.shape == shape
        assert f.is_contiguous()


@pytest.mark.parametrize("path", ["fleet_trace_flap", "canonical_flap",
                                  "fleet_bench_corner", "fleet_leg_resumed",
                                  "solo_churn"])
def test_k1_route_hands_the_kernel_its_layout(monkeypatch, path):
    """Every K1 caller passes what the CUDA wrapper accepts (it raises on
    anything else, with no fallback): recorded on the CPU, where the
    tensors come from the same staging code."""
    seen = []

    def record(*args, **kw):
        _kernel_layout(args, kw)
        seen.append(args[0])
        return pvector.vector_step(*args, **kw)

    monkeypatch.setattr(ptick, "fused_vector_step", record)
    if path == "fleet_trace_flap":
        cfg = SimConfig(seed=0, **WORLDS["flap"])
        fleet.FleetSimulation(cfg, device="cpu").run(seeds=[1, 2],
                                                     warmup=False)
    elif path == "canonical_flap":
        # the flap knobs a lane ([B, 1]) broadcast against the anchors
        cfgs = [SimConfig(max_nnb=12, seed=s, total_ticks=80,
                          flap_rate=0.3, flap_period=p, flap_down=d,
                          flap_open_tick=10, flap_close_tick=70)
                for p, d, s in ((10, 3, 1), (12, 4, 2))]
        fleet.CanonicalFleetSimulation(cfgs[0], device="cpu").run(
            configs=cfgs)
        cfg = cfgs[0]
    elif path == "fleet_bench_corner":
        cfg = SimConfig(max_nnb=256, single_failure=False, total_ticks=30,
                        fail_tick=15, seed=0)
        fleet.FleetSimulation(cfg, device="cpu").run_bench(seeds=[1, 2],
                                                           warmup=False)
    elif path == "fleet_leg_resumed":
        cfg = SimConfig(seed=0, **WORLDS["churn"])
        sim = fleet.FleetSimulation(cfg, device="cpu")
        leg = sim.run_leg(seeds=[1, 2], ticks=16)
        sim.run_leg(resume=leg.checkpoints)
    else:
        cfg = SimConfig(seed=0, **WORLDS["churn"])
        _solo_k1(cfg)
    assert len(seen) == cfg.total_ticks


def test_wrapper_fields_follow_the_kernel_lanes():
    """The wrapper unpacks the kernel's byte and word lanes by name, in
    the order of the S_* / I_* enums of csrc/dense_tick.cu, and covers
    every field of :class:`VectorStep`."""
    src = (Path(pvector.__file__).resolve().parents[1] / "csrc"
           / "dense_tick.cu").read_text()

    def enum(first, last):
        body = re.search(rf"enum {{ ({first} = 0,[^}}]*{last}) }}", src,
                         re.S).group(1)
        names = [x.split("=")[0].strip() for x in body.split(",")]
        return [x.split("_", 1)[1].lower() for x in names[:-1]]

    byte_lanes = enum("S_PROC", "S_LANES")
    word_lanes = enum("I_OWN_HB", "I_LANES")
    want_bytes = [{"rejoin": "rejoining"}.get(x, x) for x in byte_lanes]
    assert list(pvector.BYTE_LANES) == want_bytes
    assert list(pvector.WORD_LANES) == word_lanes
    assert sorted(pvector.BYTE_LANES + pvector.WORD_LANES) == sorted(
        VectorStep.__dataclass_fields__)

"""The spans and counters a solo overlay run leaves in the port's recorder
(``OverlaySimulation.run``; gossip_protocol_tpu_torch/utils/spans.py), on
the CPU.

Each run records ``solo.stage``, ``solo.enqueue`` and ``solo.fetch`` in
that order, without overlap, and ``solo.device``, all under one id of its
own; the K5 route adds its launches and boot pre-passes to
``solo.k5_launches`` and ``solo.boot_prepass``; with recording off
nothing is kept; recording changes no bit of the result; under a
profiler the three host phases are profiler ranges at the same places.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
from gossip_protocol_tpu_torch.models.overlay_grid import (_launches,
                                                           grid_supported)
from gossip_protocol_tpu_torch.models.overlay_mega import mega_supported
from gossip_protocol_tpu_torch.models.segments import plan_segments
from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import (GRID_TICKS,
                                                             grid_boot_rows)
from gossip_protocol_tpu_torch.ops.overlay_rules import METRIC_FIELDS
from gossip_protocol_tpu_torch.utils import spans

torch.set_num_threads(2)

SOLO = ("solo.stage", "solo.enqueue", "solo.fetch")
#: the power-law overlay (F = 8: the K5 route) and the uniform one at
#: F = 3 (the K4 route), each with the per-tick route beside it
POWERLAW = dict(max_nnb=64, model="overlay", topology="powerlaw",
                single_failure=True, drop_msg=False, seed=5, total_ticks=40,
                fail_tick=20, step_rate=16.0 / 64)
UNIFORM = dict(POWERLAW, topology="uniform")
ROUTES = {"k5": (POWERLAW, False), "k4": (UNIFORM, False),
          "per_tick": (POWERLAW, True)}


@pytest.fixture(autouse=True)
def fresh_recorder():
    spans.clear()
    yield
    while spans.recording() and not torch.autograd._profiler_enabled():
        spans.disable()
    spans.clear()


def _sim(route):
    conf, per_tick = ROUTES[route]
    return OverlaySimulation(SimConfig(**conf), device="cpu",
                             per_tick=per_tick)


def _same(a, b):
    for f in dataclasses.fields(a.final_state):
        x, y = getattr(a.final_state, f.name), getattr(b.final_state, f.name)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f.name
    for f in METRIC_FIELDS:
        assert np.array_equal(getattr(a.metrics, f), getattr(b.metrics, f)), f


def test_the_routes_are_the_ones_named():
    assert grid_supported(SimConfig(**POWERLAW))
    assert not mega_supported(SimConfig(**POWERLAW))
    assert mega_supported(SimConfig(**UNIFORM))


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_run_records_its_phases_in_order_under_one_id(route):
    sim = _sim(route)
    with spans.enable():
        res = [sim.run(), sim.run(ticks=24)]
    recs = spans.snapshot()["spans"]
    ids = sorted({r.id for r in recs})
    assert len(ids) == 2 and len(recs) == 8
    ends = []
    for rid, r in zip(ids, res):
        mine = {x.name: x for x in recs if x.id == rid}
        assert set(mine) == set(SOLO) | {"solo.device"}
        assert all(x.parent is None for x in mine.values())
        assert all(dict(x.attrs) == dict(start=0, ticks=r.ticks_run)
                   for x in mine.values())
        phases = [mine[n] for n in SOLO]
        for a, b in zip(phases, phases[1:]):
            assert a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns
        # the stage's packing, the enqueue and the wait are the wall
        wall_ns = r.wall_seconds * 1e9
        assert mine["solo.fetch"].start_ns - mine["solo.stage"].start_ns \
            >= wall_ns - 1e3
        # on the CPU the run executes inside the enqueue
        assert mine["solo.device"][3:5] == mine["solo.enqueue"][3:5]
        ends.append((phases[0].start_ns, phases[-1].end_ns))
    assert ends[0][1] <= ends[1][0]


@pytest.mark.parametrize("route", list(ROUTES))
def test_results_are_bit_identical_with_the_recorder_on_and_off(route):
    off = _sim(route).run()
    assert spans.snapshot() == dict(spans=[], counters={}, dropped=0)
    with spans.enable():
        on = _sim(route).run()
    _same(off, on)
    assert spans.snapshot()["spans"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_enqueue_consumes_the_staged_inputs(route):
    """The caller's staged list is emptied, so a packed plane lives no
    longer than inside a plain call; the halves equal the whole."""
    from gossip_protocol_tpu_torch.models.overlay import (
        init_overlay_state, make_overlay_run, make_overlay_schedule)
    sim = _sim(route)
    cfg = sim.cfg
    kw = dict(mega=False, grid=False) if sim.per_tick else {}
    run = make_overlay_run(cfg, start_tick=0, **kw)
    sched = make_overlay_schedule(cfg)
    staged = run.stage(init_overlay_state(cfg, "cpu"), sched)
    assert len(staged) == 3
    final, met = run.enqueue(staged)
    assert staged == []
    whole = sim.run()
    assert torch.equal(final.ids, whole.final_state.ids)
    assert np.array_equal(met.recv.numpy(), whole.metrics.recv)


def test_nothing_recorded_when_off():
    assert not spans.recording()
    for route in ROUTES:
        _sim(route).run()
    first = _sim("k5").run(ticks=8)
    _sim("k5").run(resume_from=first.final_state)
    assert spans.snapshot() == dict(spans=[], counters={}, dropped=0)


@pytest.mark.parametrize("start,ticks", [(0, None), (0, 24), (8, None),
                                         (24, 8)])
def test_k5_counters_follow_the_plan(start, ticks):
    """``solo.k5_launches`` counts the launches of the plan the run
    executes; ``solo.boot_prepass`` is 0 from tick 0 and 1 for a run
    resumed at a join-live tick > 0 (the ramp here ends at tick 16), as
    many as K5's boot pre-pass ran."""
    sim = _sim("k5")
    state = sim.run(ticks=start).final_state if start else None
    cfg = sim.cfg
    end = cfg.total_ticks if ticks is None else start + ticks
    plan = list(_launches(plan_segments(cfg, end - start, start,
                                        GRID_TICKS)))
    calls = grid_boot_rows.calls
    with spans.enable():
        sim.run(resume_from=state, ticks=ticks)
    got = spans.snapshot()["counters"]
    assert got["solo.k5_launches"] == len(plan) == -(-(end - start) // 16)
    boot = int(start > 0 and plan[0][1].join_live)
    assert got["solo.boot_prepass"] == grid_boot_rows.calls - calls == boot
    assert boot == (start == 8)


def test_other_routes_count_no_k5_launch():
    with spans.enable():
        _sim("k4").run()
        _sim("per_tick").run()
    assert spans.snapshot()["counters"] == {}


def test_profiler_ranges_hold_the_solo_phases():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        with spans.span("warm-up"):
            pass
        _sim("k5").run()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in SOLO:
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    recs = [r for r in spans.snapshot()["spans"] if r.name in SOLO]
    assert sorted(r.name for r in recs) == sorted(SOLO)
    assert {n: len(v) for n, v in ranges.items()} == dict.fromkeys(SOLO, 1)
    for r in recs:
        (s0, s1), = ranges[r.name]
        assert abs(s0 - r.start_ns) < 1_000_000, r
        assert abs(s1 - r.end_ns) < 1_000_000, r
    assert not any(r.name.startswith("bench.")
                   for r in spans.snapshot()["spans"])


@pytest.mark.gpu
def test_device_span_on_the_card():
    """On the card: results equal an unrecorded run's; ``solo.device``
    (the enqueue's two timing events) ends when the wait returned and
    lies inside the enqueue-to-fetch interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90); none is visible")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    cfg = SimConfig(**dict(POWERLAW, max_nnb=1 << 16, total_ticks=64,
                           fail_tick=32, step_rate=16.0 / (1 << 16)))
    off = OverlaySimulation(cfg, device="cuda").run()
    with spans.enable():
        on = OverlaySimulation(cfg, device="cuda").run()
    _same(off, on)
    got = {r.name: r for r in spans.snapshot()["spans"]}
    enq, dev, fetch = (got[n] for n in ("solo.enqueue", "solo.device",
                                        "solo.fetch"))
    assert dev.end_ns == fetch.start_ns
    assert enq.start_ns - 1_000_000 <= dev.start_ns < dev.end_ns
    assert spans.snapshot()["counters"] == {"solo.k5_launches": 4,
                                            "solo.boot_prepass": 0}

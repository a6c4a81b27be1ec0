"""The port's span recorder (gossip_protocol_tpu_torch/utils/spans.py) and
the spans the fleet and the service leave in it, on the CPU.

A fleet's ``fleet.stage`` + ``fleet.enqueue`` + ``fleet.fetch`` are its
``pack_seconds`` + ``fetch_seconds``; a served request's ``serve.queue``
+ ``serve.dispatch`` + ``serve.in_flight`` + ``serve.collect`` are its
``latency_s`` on the service's clock; ids and parents link a request to
its dispatch and a dispatch to its fleet; with recording off nothing is
kept; under a profiler each synchronous span is a profiler range at the
same place on the trace's clock; the ring stays bounded.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
from gossip_protocol_tpu_torch.service import FleetService
from gossip_protocol_tpu_torch.utils import spans

torch.set_num_threads(2)

FLEET = ("fleet.stage", "fleet.enqueue", "fleet.fetch", "fleet.device")
REQUEST = ("serve.queue", "serve.dispatch", "serve.in_flight",
           "serve.collect")
#: spans that are also profiler ranges while profiling
RANGES = ("fleet.stage", "fleet.enqueue", "fleet.fetch", "serve.dispatch",
          "serve.collect")

DENSE = dict(max_nnb=16, single_failure=True, drop_msg=True,
             msg_drop_prob=0.1, seed=0, total_ticks=40, fail_tick=20)
OVERLAY = dict(max_nnb=64, model="overlay", single_failure=False,
               drop_msg=False, seed=0, total_ticks=48, churn_rate=0.25,
               rejoin_after=16, step_rate=8.0 / 64)


@pytest.fixture(autouse=True)
def fresh_recorder():
    spans.clear()
    yield
    while spans.recording() and not torch.autograd._profiler_enabled():
        spans.disable()
    spans.clear()


class TickingClock:
    """A service clock that moves 1.25 ms at every reading, so every span
    has a length of its own."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t

    def sleep(self, dt):
        self.t += dt


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def _launch(kind, seeds=(1, 2, 3), n_real=None):
    cfg = SimConfig(**(DENSE if kind == "dense" else OVERLAY))
    return FleetSimulation(cfg, device="cpu").launch_bench(
        seeds=list(seeds), warmup=False, n_real=n_real).resolve()


@pytest.mark.parametrize("kind", ["dense", "overlay"])
def test_fleet_spans_sum_to_pack_and_fetch(kind):
    with spans.enable():
        fr = _launch(kind, n_real=2)
    recs = spans.snapshot()["spans"]
    got = {n: _by_name(recs, n) for n in FLEET}
    assert all(len(v) == 1 for v in got.values()), got
    fid = got["fleet.stage"][0].id
    ticks = (DENSE if kind == "dense" else OVERLAY)["total_ticks"]
    for r in (v[0] for v in got.values()):
        assert (r.id, r.parent) == (fid, None)
        assert dict(r.attrs) == dict(ticks=ticks, lanes=2, padded=3)
        assert r.end_ns >= r.start_ns
    host = sum(got[n][0].seconds for n in FLEET[:3])
    assert abs(host - (fr.pack_seconds + fr.fetch_seconds)) <= 1e-9
    assert abs(got["fleet.fetch"][0].seconds - fr.fetch_seconds) <= 1e-9
    # on the CPU the run executes inside enqueue: its device span
    assert got["fleet.device"][0][3:5] == got["fleet.enqueue"][0][3:5]


def _serve(pipeline, n=5, clock=None):
    kw = dict(clock=clock, sleep=clock.sleep) if clock is not None else {}
    svc = FleetService(max_batch=2, device="cpu", pipeline=pipeline, **kw)
    cfg = SimConfig(**OVERLAY)
    hs = [svc.submit(cfg, seed=10 + i, mode="bench") for i in range(n)]
    svc.drain()
    for h in hs:
        h.result()
    return svc, hs


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "synchronous"])
def test_request_spans_tile_latency_on_the_service_clock(pipeline):
    with spans.enable():
        svc, hs = _serve(pipeline, clock=TickingClock())
    assert svc.stats()["failures"]["retries"] == 0
    recs = spans.snapshot()["spans"]
    disp = {r.id: r for r in _by_name(recs, "serve.dispatch")}
    coll = {r.id: r for r in _by_name(recs, "serve.collect")}
    assert set(disp) == set(coll) and len(disp) == 3
    for h in hs:
        m = h.metrics
        q, = [r for r in _by_name(recs, "serve.queue") if r.id == m.rid]
        f, = [r for r in _by_name(recs, "serve.in_flight") if r.id == m.rid]
        assert q.parent == f.parent and q.parent in disp
        parts = (q, disp[q.parent], f, coll[q.parent])
        for a, b in zip(parts, parts[1:]):
            assert a.end_ns == b.start_ns       # one reading, shared
        assert all(p.end_ns > p.start_ns for p in parts)
        assert abs(sum(p.seconds for p in parts) - m.latency_s) <= 1e-9
        assert abs(q.seconds - m.queue_wait_s) <= 1e-9


def test_ids_link_requests_dispatches_and_fleets():
    with spans.enable():
        svc, hs = _serve(True)
    recs = spans.snapshot()["spans"]
    disp = {r.id for r in _by_name(recs, "serve.dispatch")}
    assert disp == {r.id for r in _by_name(recs, "serve.collect")}
    for name in ("serve.queue", "serve.in_flight"):
        mine = _by_name(recs, name)
        assert sorted(r.id for r in mine) == [h.metrics.rid for h in hs]
        assert {r.parent for r in mine} == disp
    fleets = {}
    for name in FLEET:
        for r in _by_name(recs, name):
            fleets.setdefault(r.id, {})[name] = r.parent
    assert len(fleets) == len(disp)
    for parents in fleets.values():
        assert set(parents) == set(FLEET)
        assert len(set(parents.values())) == 1
        assert parents["fleet.stage"] in disp
    # a dispatch's fleet counts the requests that rode it
    for f in _by_name(recs, "fleet.stage"):
        riders = [r for r in _by_name(recs, "serve.in_flight")
                  if r.parent == f.parent]
        assert f.attrs["lanes"] == len(riders) and f.attrs["padded"] == 2


def test_nothing_recorded_when_off():
    assert not spans.recording()
    a, b = spans.span("fleet.stage"), spans.span("serve.collect", 7)
    assert a is b
    with a:
        assert spans.current() is None
    spans.record("x", 1, 2)
    spans.count("y")
    _launch("dense")
    _serve(True, n=3)
    snap = spans.snapshot()
    assert snap == dict(spans=[], counters={}, dropped=0)


def test_enable_nests_and_counts():
    with spans.enable():
        with spans.enable():
            spans.count("c", 2)
        assert spans.recording()
        spans.count("c")
        with spans.span("outer", 5):
            with spans.span("inner"):
                assert spans.current() == 5
            with spans.span("inner", 6):
                assert spans.current() == 6
            assert spans.current() == 5
        assert spans.current() is None
    assert not spans.recording()
    spans.count("c")
    assert spans.snapshot()["counters"] == {"c": 3}


def test_profiler_ranges_hold_the_converted_spans():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.recording()
        # a process's first range may pay the profiler's set-up between
        # its start stamp and the work it holds
        with spans.span("warm-up"):
            pass
        _launch("overlay")
        _serve(True, n=3)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in RANGES:
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    recs = [r for r in spans.snapshot()["spans"] if r.name in RANGES]
    assert {r.name for r in recs} == set(RANGES)
    for r in recs:
        s0, s1 = min(ranges[r.name], key=lambda x: abs(x[0] - r.start_ns))
        assert abs(s0 - r.start_ns) < 1_000_000, r
        assert abs(s1 - r.end_ns) < 1_000_000, r
    assert not any(r.name.startswith("bench.")
                   for r in spans.snapshot()["spans"])


def test_ring_is_bounded():
    with spans.enable():
        for i in range(spans.CAPACITY + 10):
            spans.record("r", i, i + 1, id=i)
    snap = spans.snapshot()
    assert len(snap["spans"]) == spans.CAPACITY
    assert snap["dropped"] == 10
    assert snap["spans"][0].id == 10
    assert snap["spans"][-1].id == spans.CAPACITY + 9


@pytest.mark.gpu
def test_device_span_on_the_card_adds_no_sync():
    """On the card, with spans recording: the launch, its start and the
    readiness polls still never synchronize (sync-debug "error"), the
    results equal an unrecorded run's, and ``fleet.device`` (the run's
    two timing events) lies inside the launch-to-wait interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90); none is visible")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    cfg = SimConfig(max_nnb=4096, model="overlay", single_failure=False,
                    seed=0, total_ticks=272, churn_rate=0.2,
                    rejoin_after=40, step_rate=64.0 / 4096)
    sim = FleetSimulation(cfg, device="cuda")
    ref = sim.run(seeds=[1, 2], warmup=True)
    torch.cuda.synchronize()
    with spans.enable():
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = sim.launch_bench(seeds=[1, 2], warmup=False,
                                       defer=True)
            pending.start()
            while not pending.is_ready():
                pass
        finally:
            torch.cuda.set_sync_debug_mode(0)
        res = pending.resolve()
    for la, lb in zip(ref.lanes, res.lanes):
        assert np.array_equal(la.metrics.in_group, lb.metrics.in_group)
        assert torch.equal(la.final_state.ids, lb.final_state.ids)
    got = {r.name: r for r in spans.snapshot()["spans"]}
    assert set(got) == set(FLEET)
    enq, dev = got["fleet.enqueue"], got["fleet.device"]
    assert 0 < dev.end_ns - dev.start_ns
    assert enq.start_ns <= dev.start_ns
    assert dev.end_ns - dev.start_ns <= (dev.end_ns - enq.start_ns)
    host = sum(got[n].seconds for n in FLEET[:3])
    assert abs(host - (res.pack_seconds + res.fetch_seconds)) <= 1e-9
    # under a device trace the ranges stay on the host: no device event
    # (a kernel or an annotation) carries a span's name
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.launch_bench(seeds=[3, 4], warmup=False).resolve()
        torch.cuda.synchronize()
    evs = [(e.name(), e.device_type())
           for e in prof.profiler.kineto_results.events()]
    names = {n for n, d in evs if d == torch.autograd.DeviceType.CPU}
    assert set(RANGES[:3]) <= names
    assert not [n for n, d in evs if d == torch.autograd.DeviceType.CUDA
                and n in RANGES]

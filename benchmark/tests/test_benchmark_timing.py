"""The open loop's clock, the sweep's count of work and the trace's
reduction, without a card."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.arrivals import percentile, saturated, schedule
from benchmark.drivers import openloop, sweep
from benchmark.harness import TraceIncomplete, check_trace
from benchmark.trace import NoTrace, reduce_events


class _Metrics(SimpleNamespace):
    pass


class _Handle:
    def __init__(self, svc, rid, seed):
        self.request = SimpleNamespace(rid=rid, submit_s=time.perf_counter())
        self.svc, self.seed = svc, seed
        self._done_at = None
        self.failed = False
        self.metrics = None

    @property
    def done(self):
        return self.metrics is not None

    def result(self):
        return ("lane", self.seed)


class FakeService:
    """Completes each request ``delay`` after its submission on the next
    pump; request ``stall`` completes ``stall_s`` late; submission
    ``slow`` blocks the caller for ``slow_s`` (the generator falls
    behind).  Its own latency stamp reads 0, and it refuses a forced
    flush: the loop times requests itself and only pumps."""

    def __init__(self, delay=0.01, stall=3, stall_s=0.4, slow=6, slow_s=0.3):
        self.handles, self.delay = [], delay
        self.stall, self.stall_s, self.slow, self.slow_s = \
            stall, stall_s, slow, slow_s

    def submit(self, cfg, seed, mode):
        h = _Handle(self, len(self.handles), seed)
        self.handles.append(h)
        if h.request.rid == self.slow:
            time.sleep(self.slow_s)
        self.pump()
        return h

    def pump(self):
        now = time.perf_counter()
        for h in self.handles:
            wait = self.delay + (self.stall_s if h.request.rid == self.stall
                                 else 0.0)
            if h.metrics is None and now - h.request.submit_s >= wait:
                h.metrics = _Metrics(latency_s=0.0,
                                     batch=1, padded_batch=2,
                                     run_wall_s=float(h.request.rid))
        return 0

    def drain(self):
        raise AssertionError("the window forced a flush")

    def stats(self):
        return {"dispatches": sum(h.done for h in self.handles),
                "mean_host_s": 0.001}


def test_latency_runs_from_the_due_time_and_p95_takes_every_request():
    env = SimpleNamespace(
        svc=FakeService(), conf={"mode": "trace"}, cfg=None, seed=4,
        traffic=dict(rate_rps=20.0, max_batch=2, max_wait_s=0.1),
        pick=np.random.default_rng(1))
    arrivals = schedule(20.0, 1.0, 0, 4)
    rec = openloop.window(env, 1.0, NoTrace())
    assert rec["attempted"] == len(arrivals) == len(rec["latencies_s"])
    assert rec["failed"] == 0
    lat = np.asarray(rec["latencies_s"])
    # the stalled request waits its stall on top of its service time
    assert lat.max() >= 0.4
    # requests due while the slow submission blocked the loop count the
    # loop's lateness: submitted late, timed from when they were due
    assert max(rec["lag_s"]) >= 0.2
    assert (lat >= np.asarray(rec["lag_s"]) * 0 + 0.009).all()
    assert percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert percentile(lat, 100) == lat.max()
    assert rec["occupancy"] == pytest.approx(0.5)


def test_a_failed_request_counts_as_waiting_to_the_end():
    svc = FakeService()
    orig = svc.pump

    def pump():
        orig()
        for h in svc.handles:
            if h.request.rid == 2 and h.done:
                h.failed = True
        return 0

    svc.pump = pump
    env = SimpleNamespace(svc=svc, conf={"mode": "trace"}, cfg=None, seed=4,
                          traffic=dict(rate_rps=20.0, max_batch=2,
                                       max_wait_s=0.1),
                          pick=np.random.default_rng(1))
    rec = openloop.window(env, 0.5, NoTrace())
    assert rec["failed"] == 1
    assert max(rec["latencies_s"]) >= rec["span_s"] - 0.5


def test_a_request_that_never_comes_is_unanswered(monkeypatch):
    """Past the grace after the window the loop stops waiting: the
    request counts as failed, waiting until the loop's end."""
    monkeypatch.setattr(openloop, "GRACE_S", 0.3)
    svc = FakeService(stall=2, stall_s=1e9)
    svc.drain = lambda: None
    env = SimpleNamespace(svc=svc, conf={"mode": "trace"}, cfg=None, seed=4,
                          traffic=dict(rate_rps=20.0, max_batch=2,
                                       max_wait_s=0.1),
                          pick=np.random.default_rng(1))
    rec = openloop.window(env, 0.5, NoTrace())
    assert rec["failed"] == 1 and rec["completed"] == rec["attempted"] - 1
    assert 0.8 <= rec["span_s"] < 1.5
    assert max(rec["latencies_s"]) >= rec["span_s"] - 0.5


def test_every_seed_offers_the_same_gaps():
    a = schedule(12.0, 30.0, 0, 5)
    b = schedule(12.0, 30.0, 0, 2 ** 40 + 3)
    assert len(a) == len(b)
    ga = sorted(np.diff([0.0] + [t for t, _ in a]).round(9))
    gb = sorted(np.diff([0.0] + [t for t, _ in b]).round(9))
    assert ga == gb
    assert [s for _, s in a] != [s for _, s in b]
    assert 300 < len(a) < 420


def test_saturation_rule():
    assert not saturated(10.0, 9.5, 21.0, 20.0)
    assert not saturated(10.0, 8.0, 21.0, 20.0)       # drain tail only
    assert saturated(10.0, 8.0, 25.0, 20.0)


def test_trace_reduction():
    ns = 1_000_000
    evs = [("bench.window", "cpu", 0, 100 * ns),
           ("bench.window", "annotation", 0, 100 * ns),
           ("bench.launch", "cpu", 0, 30 * ns),
           ("cudaLaunchKernel", "cpu", 1 * ns, 2 * ns),
           ("cudaLaunchKernel", "cpu", 3 * ns, 4 * ns),
           ("cudaLaunchKernel", "cpu", 200 * ns, 201 * ns),   # outside
           ("aten::copy_", "cpu", 25 * ns, 60 * ns),
           ("k_a", "kernel", 10 * ns, 20 * ns),
           ("k_b", "kernel", 15 * ns, 30 * ns),
           ("Memcpy DtoH", "copy", 60 * ns, 70 * ns),
           ("k_c", "kernel", 150 * ns, 160 * ns)]             # outside
    r = reduce_events(evs)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.030)
    assert r["kernel_s"] == pytest.approx(0.025)
    assert r["kernels"] == 2 and r["launches"] == 2
    ops = dict(r["device_ops"])
    assert ops["k_b"] == pytest.approx(0.015)
    gaps = dict(r["idle_gaps"])
    assert gaps["bench.launch"] == pytest.approx(0.010)      # 0-10 ms
    assert gaps["aten::copy_"] == pytest.approx(0.030)       # 30-60 ms
    assert gaps["host idle"] == pytest.approx(0.030)         # 70-100 ms


class _FakeFleet:
    """A fleet whose own count of node-ticks is wrong: the sweep counts
    the configuration's N x ticks of every lane that came back."""

    def __init__(self, seeds):
        self.lanes = [SimpleNamespace() for _ in seeds]
        self.total_node_ticks = 1           # never read
        self.pack_seconds = self.device_seconds = self.fetch_seconds = 0.001

    def resolve(self):
        time.sleep(0.01)
        return self


def test_the_sweep_counts_its_own_work():
    sim = SimpleNamespace(
        launch_bench=lambda seeds, warmup: _FakeFleet(seeds))
    env = SimpleNamespace(sim=sim, conf=dict(max_nnb=64, total_ticks=100),
                          traffic=dict(batch=8, in_flight=2),
                          rng=np.random.default_rng(3),
                          pick=np.random.default_rng(4))
    rec = sweep.window(env, 0.1, NoTrace())
    lanes = sum(f["lanes"] for f in rec["fleets"])
    assert lanes == rec["attempted"] and rec["failed"] == 0 and lanes >= 16
    assert rec["node_ticks"] == 64 * 100 * lanes
    picks = sweep.answers(env, rec)
    assert len(picks) == 4          # one lane from each quarter of 8


def test_a_trace_that_lost_events_is_refused():
    check_trace(dict(kernels=5, launches=5))
    with pytest.raises(TraceIncomplete):
        check_trace(dict(kernels=4, launches=5))

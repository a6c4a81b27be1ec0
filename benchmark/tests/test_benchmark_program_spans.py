"""The ``program_span`` metrics that read the port's own span recorder
(``fleet.stage_ms_per_tick``, ``fleet.enqueue_ms_per_tick``,
``fleet.fetch_ms_per_tick``, ``serve.queue_ms``, ``serve.in_flight_ms``,
``serve.device_ms``), on a recorder filled by CPU fleet and service runs:
the lead-in's records are left out, and with no records, or no recorder,
each reads None."""

import sys

import pytest
import torch

from benchmark import spec
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
from gossip_protocol_tpu_torch.service import FleetService
from gossip_protocol_tpu_torch.utils import spans

torch.set_num_threads(2)

FLEET_METRICS = {"fleet.stage_ms_per_tick": "fleet.stage",
                 "fleet.enqueue_ms_per_tick": "fleet.enqueue",
                 "fleet.fetch_ms_per_tick": "fleet.fetch"}
SERVE_METRICS = {"serve.queue_ms": "serve.queue",
                 "serve.in_flight_ms": "serve.in_flight",
                 "serve.device_ms": "fleet.device"}
DENSE = dict(max_nnb=16, single_failure=True, drop_msg=True,
             msg_drop_prob=0.1, seed=0, total_ticks=40, fail_tick=20)
OVERLAY = dict(max_nnb=64, model="overlay", single_failure=False,
               drop_msg=False, seed=0, total_ticks=48, churn_rate=0.25,
               rejoin_after=16, step_rate=8.0 / 64)


def _metric(name):
    return spec.load_module(spec.ROOT / "metrics" / f"{name}.py", name)


@pytest.fixture(autouse=True)
def recorder():
    spans.clear()
    with spans.enable():
        yield
    spans.clear()


def _ms(r):
    return (r.end_ns - r.start_ns) / 1e6


@pytest.mark.parametrize("conf", [DENSE, OVERLAY], ids=["dense", "overlay"])
def test_fleet_readers_take_the_window_and_sum_to_host(conf):
    sim = FleetSimulation(SimConfig(**conf), device="cpu")
    sim.launch_bench(seeds=[1, 2], warmup=False).resolve()     # lead-in
    n_lead = len(spans.snapshot()["spans"])
    fleets = []
    for seeds in ([3, 4], [5, 6], [7, 8]):
        fr = sim.launch_bench(seeds=seeds, warmup=False).resolve()
        fleets.append(dict(ticks=conf["total_ticks"], pack_s=fr.pack_seconds,
                           fetch_s=fr.fetch_seconds))
    ctx = dict(record=dict(fleets=fleets))
    window = spans.snapshot()["spans"][n_lead:]
    ticks = 3 * conf["total_ticks"]
    got = {}
    for metric, name in FLEET_METRICS.items():
        got[metric] = _metric(metric).read(ctx)
        want = sum(_ms(r) for r in window if r.name == name) / ticks
        assert got[metric] == pytest.approx(want, rel=1e-12)
    host = _metric("fleet.host_ms_per_tick").read(ctx)
    assert sum(got.values()) == pytest.approx(host, rel=1e-9)


def test_serve_readers_take_the_window_dispatches():
    svc = FleetService(max_batch=2, device="cpu")
    cfg = SimConfig(**OVERLAY)

    def serve(seeds):
        hs = [svc.submit(cfg, seed=s, mode="bench") for s in seeds]
        svc.drain()
        return [h.metrics for h in hs if h.result() is not None]

    serve([1, 2, 3])                                          # lead-in
    d0 = svc.stats()["dispatches"]
    mets = serve([4, 5, 6, 7, 8])
    ctx = dict(record=dict(dispatches=svc.stats()["dispatches"] - d0))
    assert ctx["record"]["dispatches"] == 3
    recs = spans.snapshot()["spans"]
    rids = {m.rid for m in mets}
    queue = _metric("serve.queue_ms").read(ctx)
    assert queue == pytest.approx(
        sum(m.queue_wait_s for m in mets) / len(mets) * 1e3, rel=1e-6)
    flight = [r for r in recs if r.name == "serve.in_flight"
              and r.id in rids]
    assert _metric("serve.in_flight_ms").read(ctx) == pytest.approx(
        sum(_ms(r) for r in flight) / len(flight), rel=1e-12)
    dev = {r.parent: _ms(r) for r in recs if r.name == "fleet.device"}
    assert _metric("serve.device_ms").read(ctx) == pytest.approx(
        sum(dev[r.parent] for r in flight) / len(flight), rel=1e-12)


def test_readers_without_records_or_recorder_read_none(monkeypatch):
    fleet_ctx = dict(record=dict(fleets=[dict(ticks=40, pack_s=0.1,
                                              fetch_s=0.1)]))
    serve_ctx = dict(record=dict(dispatches=2))
    names = list(FLEET_METRICS) + list(SERVE_METRICS)
    ctxs = [fleet_ctx] * 3 + [serve_ctx] * 3
    for name, ctx in zip(names, ctxs):
        assert _metric(name).read(ctx) is None, name
    # a window with more fleets than the recorder holds
    sim = FleetSimulation(SimConfig(**DENSE), device="cpu")
    sim.launch_bench(seeds=[1], warmup=False).resolve()
    two = dict(record=dict(fleets=fleet_ctx["record"]["fleets"] * 2))
    for name in FLEET_METRICS:
        assert _metric(name).read(two) is None, name
        assert _metric(name).read(fleet_ctx) is not None, name
    # a program without the recorder (an older checkout of the port)
    monkeypatch.setitem(sys.modules, "gossip_protocol_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["gossip_protocol_tpu_torch.utils"],
                        "spans")
    for name, ctx in zip(names, ctxs):
        assert _metric(name).read(ctx) is None, name

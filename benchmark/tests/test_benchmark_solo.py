"""The solo cell (``overlay1m-powerlaw.solo``) on the CPU, shrunk through
``run_cell``'s overrides: the solo driver against the plain reference,
a broken program coming out not correct, the control failing the check
on the new configuration, the cell's spec entries, and its readers of
the program's solo spans and of the trace."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.harness import make_env, run_cell
from benchmark.tools.control import readings
from gossip_protocol_tpu_torch.utils import spans

torch.set_num_threads(2)

CELL = "overlay1m-powerlaw.solo"
QUIET = dict(log=lambda m: None, device="cpu")


def _small(n: int) -> dict:
    """The configuration at N peers and 64 ticks: every peer started by
    tick 16, the single failure at T/2."""
    return dict(max_nnb=n, total_ticks=64, fail_tick=32, step_rate=16 / n)


def _metric(name):
    return spec.load_module(spec.ROOT / "metrics" / f"{name}.py", name)


@pytest.mark.parametrize("n", [16, 64])
def test_the_solo_driver_is_correct(n):
    out = run_cell(CELL, 2 ** 33 + n, 1.5, False, conf_over=_small(n),
                   **QUIET)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["checks"]["answers_checked"]["value"] == 2
    assert set(out["metrics"]) == {"setup_s", "node_ticks_per_s"}


# ------------------------------------------------ faults underneath


def _state_unchanged(res, first):
    fs = res.final_state
    for f in dataclasses.fields(fs):
        v = getattr(fs, f.name)
        if torch.is_tensor(v):
            setattr(fs, f.name, -torch.ones_like(v) if f.name == "ids"
                    else torch.zeros_like(v))
    for k, v in vars(res.metrics).items():
        setattr(res.metrics, k, v * 0)


def _stale_answer(res, first):
    """Every run answers with the process's first run (another seed)."""
    res.final_state, res.metrics = first.final_state, first.metrics


def _answer_altered(res, first):
    fs = res.final_state
    fs.own_hb = fs.own_hb.clone()
    fs.own_hb[0] += 1


@pytest.mark.parametrize("fault", [_state_unchanged, _stale_answer,
                                   _answer_altered])
def test_a_broken_program_is_not_correct(monkeypatch, fault):
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    run = OverlaySimulation.run
    first = []

    def broken(self, *a, **kw):
        res = run(self, *a, **kw)
        if not first:
            first.append(run(self, *a, **kw))
        fault(res, first[0])
        return res

    monkeypatch.setattr(OverlaySimulation, "run", broken)
    out = run_cell(CELL, 5, 1.0, False, conf_over=_small(16), **QUIET)
    assert not out["correct"], out["checks"]
    assert out["checks"]["mismatched_values"]["value"] > 0


def test_a_run_that_raises_counts_as_failed(monkeypatch):
    from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
    run = OverlaySimulation.run
    calls = []

    def first_window_run_lost(self, *a, **kw):
        calls.append(1)
        if len(calls) == 3:         # after the set-up's two runs
            raise RuntimeError("a lost run")
        return run(self, *a, **kw)

    monkeypatch.setattr(OverlaySimulation, "run", first_window_run_lost)
    out = run_cell(CELL, 9, 1.0, False, conf_over=_small(16), **QUIET)
    assert out["failed"] == 1 and not out["correct"]
    assert out["attempted"] > out["failed"]


@pytest.mark.parametrize("n", [16, 64])
def test_the_control_fails_the_check(n):
    conf = spec.read_json(spec.ROOT / "configs" / "overlay1m-powerlaw.json")
    conf.update(_small(n))
    rows = readings(conf, [3, 4, 5], torch.device("cpu"))
    assert all(r["mismatched_values"] > 0 and not r["correct"]
               for r in rows), rows


def test_the_configuration_and_cell_entries():
    s = spec.load_spec()
    conf_entry = spec.find(s["configs"], "overlay1m-powerlaw", "config")
    assert conf_entry["reduced"] == []
    conf = spec.read_json(spec.REPO / conf_entry["file"])
    assert conf["source"] == conf_entry["source"]
    want = dict(max_nnb=1 << 20, model="overlay", topology="powerlaw",
                powerlaw_alpha=2.5, fanout=0, overlay_view=0,
                single_failure=True, fail_tick=136, total_ticks=272,
                step_rate=40 / (1 << 20), drop_msg=False, churn_rate=0.0,
                rejoin_after=None, t_remove=20, t_fail=5,
                reference="overlay", mode="trace")
    assert {k: conf[k] for k in want} == want
    assert conf["resolved"] == dict(fanout=8, overlay_view=64)
    for k in ("powerlaw_alpha", "fanout", "overlay_view", "total_ticks",
              "fail_tick", "step_rate", "max_nnb"):
        assert k in conf["assumed"], k
    env = make_env(conf, {}, 1, torch.device("cpu"))
    from gossip_protocol_tpu_torch.models.overlay import resolved_dims
    from gossip_protocol_tpu_torch.models.overlay_grid import grid_supported
    assert resolved_dims(env.cfg) == (64, 8) and grid_supported(env.cfg)
    wl = spec.find(s["workloads"], CELL, "workload")
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "overlay1m-powerlaw", "solo", 1)
    e2e = {m["name"] for m in spec.metrics_of(s, CELL, "end_to_end")}
    assert e2e == {"setup_s", "node_ticks_per_s"}
    layer = {m["name"] for m in spec.metrics_of(s, CELL, "per_layer")}
    assert layer == {"overlay_tick_roofline", "device.idle_share.sweep",
                     "solo.stage_ms_per_run", "solo.enqueue_ms_per_run",
                     "solo.fetch_ms_per_run", "solo.launches_per_run"}
    r = spec.resolve(s, CELL)
    assert r["traffic"]["checked"] == 2 and r["traffic"]["driver"] == "solo"
    assert len(s["workloads"]) == 4
    assert all(w["chips"] == 1 for w in s["workloads"])


# ------------------------------------------------ the cell's readers

SOLO_METRICS = {"solo.stage_ms_per_run": "solo.stage",
                "solo.enqueue_ms_per_run": "solo.enqueue",
                "solo.fetch_ms_per_run": "solo.fetch"}


@pytest.fixture
def recorder():
    spans.clear()
    with spans.enable():
        yield
    spans.clear()


def _env(n=16, seed=3):
    conf = {**spec.resolve(spec.load_spec(), CELL)["config"], **_small(n)}
    r = spec.resolve(spec.load_spec(), CELL)
    return make_env(conf, r["traffic"], seed, torch.device("cpu")), r


def test_span_readers_take_the_window_runs(recorder):
    from benchmark.trace import NoTrace
    env, r = _env()
    r["driver"].lead_in(env)
    n_lead = len(spans.snapshot()["spans"])
    record = r["driver"].window(env, 1.0, NoTrace())
    runs = record["fleets"]
    assert len(runs) >= 1 and record["failed"] == 0
    assert all(f["recv"].shape == (1, 64) for f in runs)
    window = spans.snapshot()["spans"][n_lead:]
    ctx = dict(record=record, trace=None)
    for metric, name in SOLO_METRICS.items():
        mine = [x for x in window if x.name == name]
        assert len(mine) == len(runs)
        want = sum((x.end_ns - x.start_ns) / 1e6 for x in mine) / len(mine)
        assert _metric(metric).read(ctx) == pytest.approx(want, rel=1e-12)
    assert spans.snapshot()["counters"]["solo.k5_launches"] == \
        4 * (len(runs) + 1)


def test_the_trace_readers_read_a_one_lane_record():
    """``solo.launches_per_run``, and the sweep readers the cell shares
    (``overlay_tick_roofline``, ``node_ticks_per_s``), on a record of
    one-lane runs."""
    recv = np.full((1, 272), 7 << 20, np.int64)
    runs = [dict(lanes=1, ticks=272, node_ticks=272 << 20, recv=recv)] * 4
    record = dict(fleets=runs, span_s=2.0, node_ticks=4 * (272 << 20))
    conf = spec.resolve(spec.load_spec(), CELL)["config"]
    trace = dict(launches=4 * 20, kernel_s=4.0, window_s=2.0, busy_s=1.5)
    ctx = dict(record=record, trace=trace, conf=conf)
    assert _metric("solo.launches_per_run").read(ctx) == 20
    assert _metric("node_ticks_per_s").read(ctx) == 2 * (272 << 20)
    share = _metric("overlay_tick_roofline").read(ctx)
    assert 0 < share < 100
    assert _metric("device.idle_share.sweep").read(ctx) == 25.0
    for name in ("solo.launches_per_run", *SOLO_METRICS):
        assert _metric(name).read(dict(ctx, trace=None,
                                       record=dict(fleets=[]))) is None


def test_span_readers_without_records_or_recorder_read_none(monkeypatch):
    spans.clear()
    ctx = dict(record=dict(fleets=[dict(ticks=64)] * 2))
    for name in SOLO_METRICS:
        assert _metric(name).read(ctx) is None, name
    # a program without the recorder (an older checkout of the port)
    monkeypatch.setitem(sys.modules, "gossip_protocol_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["gossip_protocol_tpu_torch.utils"],
                        "spans")
    for name in SOLO_METRICS:
        assert _metric(name).read(ctx) is None, name

"""The plain references against the port on the CPU, through the cells'
own drivers and check; the controls fail the check; and a run whose
program is broken underneath comes out not correct."""

import dataclasses

import pytest
import torch

from benchmark.check import check
from benchmark.harness import run_cell
from benchmark.tools.control import readings

QUIET = dict(log=lambda m: None, device="cpu")
#: cells shrunk to a CPU's size: peers and ticks (the drop window,
#: failures, churn and rejoins all still fall inside the run)
SMALL = {"dense4096-drop": dict(max_nnb=64, total_ticks=320),
         "overlay65k-churn": dict(max_nnb=64, total_ticks=208)}


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("cell,config", [
    ("dense4096-drop.sweep8", "dense4096-drop"),
    ("overlay65k-churn.sweep8", "overlay65k-churn")])
def test_reference_equals_the_port_through_the_sweep(cell, config, n):
    """B=2 fleets: both lanes checked (one from each half)."""
    over = dict(SMALL[config], max_nnb=n)
    out = run_cell(cell, 2 ** 33 + n, 1.0, False, conf_over=over,
                   traffic_over=dict(batch=2), **QUIET)
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_checked"]["value"] == 2
    assert out["checks"]["mismatched_values"]["value"] == 0


@pytest.mark.parametrize("n", [16, 64])
def test_reference_equals_the_port_through_the_service(n):
    """Requests padded into dispatches of 3 lanes (max_wait 0.2 s at
    4 requests/s leaves most buckets partial)."""
    over = dict(SMALL["overlay65k-churn"], max_nnb=n)
    out = run_cell("overlay65k-churn.served", 11 + n, 1.5, False,
                   conf_over=over,
                   traffic_over=dict(max_batch=3, rate_rps=4.0,
                                     max_wait_s=0.2), **QUIET)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2


def test_the_dense_corner_runs_in_the_reference():
    """N=1024 over 100 ticks acts on the 512-wide corner; the reference
    takes the corner's drop stream, and the check holds the rows and
    columns past it at zero."""
    over = dict(max_nnb=1024, total_ticks=100, fail_tick=60)
    out = run_cell("dense4096-drop.sweep8", 77, 0.5, False, conf_over=over,
                   traffic_over=dict(batch=1, in_flight=1), **QUIET)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("config", ["dense4096-drop", "overlay65k-churn"])
def test_the_control_fails_the_check(config):
    from benchmark import spec
    conf = spec.read_json(spec.ROOT / "configs" / f"{config}.json")
    conf.update(max_nnb=16, total_ticks=320 if config.startswith("dense")
                else 208)
    rows = readings(conf, [3, 4, 5], torch.device("cpu"))
    assert all(r["mismatched_values"] > 0 and not r["correct"]
               for r in rows), rows


# ------------------------------------------------ faults underneath


def _state_unchanged(lanes):
    """Every tick returned its state unchanged: the run ends where it
    began, counters silent."""
    for lane in lanes:
        fs = lane.final_state
        for f in dataclasses.fields(fs):
            v = getattr(fs, f.name)
            if torch.is_tensor(v) and f.name not in ("rng",):
                setattr(fs, f.name, -torch.ones_like(v) if f.name == "ids"
                        else torch.zeros_like(v))
        if hasattr(lane, "metrics"):
            for k, v in vars(lane.metrics).items():
                setattr(lane.metrics, k, v * 0)
        else:
            lane.sent, lane.recv = lane.sent * 0, lane.recv * 0


def _half_left_out(lanes):
    """Only the first half of the batch computed; the rest copied."""
    b = len(lanes)
    for lane in lanes[(b + 1) // 2:]:
        lane.final_state = lanes[0].final_state
        if hasattr(lane, "metrics"):
            lane.metrics = lanes[0].metrics
        else:
            lane.sent, lane.recv = lanes[0].sent, lanes[0].recv


def _answer_altered(lanes):
    """One value of each answer altered where it is produced."""
    for lane in lanes:
        fs = lane.final_state
        fs.own_hb = fs.own_hb.clone()
        fs.own_hb[0] += 1


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("cell,config,traffic", [
    ("dense4096-drop.sweep8", "dense4096-drop", dict(batch=4)),
    ("overlay65k-churn.sweep8", "overlay65k-churn", dict(batch=4)),
    ("overlay65k-churn.served", "overlay65k-churn",
     dict(max_batch=4, rate_rps=8.0, max_wait_s=0.3))])
def test_a_broken_program_is_not_correct(monkeypatch, fault, cell, config,
                                         traffic):
    import gossip_protocol_tpu_torch.core.fleet as fleet

    @dataclasses.dataclass
    class Broken(fleet.FleetResult):
        def __post_init__(self):
            if len(self.lanes) > 1 or fault is not _half_left_out:
                fault(self.lanes)

    monkeypatch.setattr(fleet, "FleetResult", Broken)
    over = dict(SMALL[config], max_nnb=16)
    out = run_cell(cell, 5, 1.0, False, conf_over=over,
                   traffic_over=traffic, **QUIET)
    assert not out["correct"], out["checks"]
    assert out["checks"]["mismatched_values"]["value"] > 0

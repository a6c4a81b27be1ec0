"""The port's failure plane (service/faults.py, service/resilience.py)
against the JAX package's.

The fault schedule is a pure function of ``(seed, attempt index)``
drawn by numpy, so the port's ``schedule_digest`` must equal the JAX
injector's; a chaos replay's fault and outcome digests must equal the
JAX chaos replay's on the same stream; retried and solo-degraded
requests must stay bit-identical to solo runs; and ``poison`` must
replace a lane's field, never write into another lane's (or a
tensor's) memory.  Sizes are the JAX resilience tests'
(tests/test_resilience.py): dense N=16, overlay N=64.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from gossip_protocol_tpu import service as jsvc
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu_torch import service as psvc
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import FleetSimulation

pr = importlib.import_module("gossip_protocol_tpu_torch.service.replay")

torch.set_num_threads(2)
pytestmark = [pytest.mark.service, pytest.mark.resilience]


def _dense_churn(pkg_cfg=SimConfig, n=16, ticks=22):
    return pkg_cfg(max_nnb=n, single_failure=False, drop_msg=False, seed=0,
                   total_ticks=ticks, fail_tick=20, rejoin_after=15)


def _overlay(pkg_cfg=SimConfig):
    return pkg_cfg(max_nnb=64, model="overlay", single_failure=True,
                   drop_msg=True, msg_drop_prob=0.1, seed=0, total_ticks=48,
                   fail_tick=24, step_rate=8 / 64)


@pytest.mark.parametrize("seed,rate", [(0, 0.12), (3, 0.3), (11, 0.5)])
def test_fault_schedule_digest_equals_jax(seed, rate):
    a = psvc.FaultInjector(seed=seed, fault_rate=rate, device_loss_at=5,
                           device_return_at=9)
    b = jsvc.FaultInjector(seed=seed, fault_rate=rate, device_loss_at=5,
                           device_return_at=9)
    for i in range(1, 200):
        assert a.plan(i) == b.plan(i)
        assert a.latency_s(i) == b.latency_s(i)
    assert a.events == b.events and a.summary() == b.summary()
    assert a.schedule_digest() == b.schedule_digest()


def test_retry_and_breaker_equal_jax():
    ra = psvc.RetryPolicy(seed=4)
    rb = jsvc.RetryPolicy(seed=4)
    for att in range(1, 7):
        for salt in (0, 3):
            assert ra.backoff_s(att, salt) == rb.backoff_s(att, salt)
    br = psvc.CircuitBreaker(psvc.BreakerPolicy(failure_threshold=2,
                                                reset_after_s=5.0))
    assert not br.record_failure("k", 0.0)
    assert br.record_failure("k", 1.0) and br.is_open("k", 2.0)
    assert br.allow("k", 6.5)
    br.record_success("k")
    assert br.open_buckets(7.0) == 0


@pytest.mark.parametrize("kind", ["dense", "overlay"])
def test_poison_replaces_never_writes(kind):
    """poison forces one lane's message counters negative by REPLACING
    the field: the other lanes, the original arrays and the lane's
    tensors are untouched, and validate_lane catches it."""
    cfg = _dense_churn() if kind == "dense" else _overlay()
    fleet = FleetSimulation(cfg, device="cpu").run(seeds=[1, 2])
    before = [np.array(l.metrics.sent if kind == "overlay" else l.sent)
              for l in fleet.lanes]
    olds = [(l.metrics.sent if kind == "overlay" else l.sent)
            for l in fleet.lanes]
    known0 = fleet.lanes[0].final_state.in_group.clone()
    i = psvc.FaultInjector(seed=1).poison(fleet, 7)
    req = psvc.SimRequest(rid=0, cfg=cfg.replace(seed=1 + i), mode="trace",
                          bucket=(), submit_s=0.0)
    assert psvc.validate_lane(req, fleet.lanes[i]) == \
        "negative message counters"
    assert psvc.validate_lane(req, fleet.lanes[1 - i]) is None
    for j, (b, o) in enumerate(zip(before, olds)):
        assert np.array_equal(np.asarray(o), b), j     # never written
    assert torch.equal(fleet.lanes[0].final_state.in_group, known0)


def test_poison_checkpoint_chunk_replaces():
    cfg = _overlay()
    sim = FleetSimulation(cfg, device="cpu")
    from gossip_protocol_tpu_torch.models.segments import checkpoint_ticks
    leg = sim.run_leg(seeds=[1, 2], ticks=checkpoint_ticks(cfg)[0])
    held = [ck.chunks[-1].sent for ck in leg.checkpoints]
    copies = [h.copy() for h in held]
    i = psvc.FaultInjector(seed=2).poison(leg, 3)
    ck = leg.checkpoints[i]
    req = psvc.SimRequest(rid=0, cfg=ck.cfg, mode="trace", bucket=(),
                          submit_s=0.0)
    assert "negative" in psvc.validate_checkpoint(req, ck)
    assert psvc.validate_checkpoint(req, leg.checkpoints[1 - i]) is None
    for h, c in zip(held, copies):       # the replaced arrays are intact
        assert np.array_equal(h, c)


def _chaos(pkg, pkg_cfg, device=None):
    tpls = [pkg.Template("dense-churn", _dense_churn(pkg_cfg)),
            pkg.Template("overlay-drop", _overlay(pkg_cfg))]
    kw = dict(seeds_per_template=3, max_batch=2, fault_seed=11,
              fault_rate=0.3, backoff_base_s=1e-4)
    if device is not None:
        kw["device"] = device
    return pkg.chaos_replay(tpls, **kw)


@pytest.fixture(scope="module")
def chaos_pair():
    return _chaos(psvc, SimConfig, "cpu"), _chaos(jsvc, JaxConfig)


def test_chaos_digests_equal_jax(chaos_pair):
    """chaos_replay at a fixed seed, with the mid-stream device loss:
    every request terminal and bit-equal to its solo run (the harness
    raises otherwise), and the fault-schedule and outcome digests equal
    the JAX chaos replay's."""
    got, want = chaos_pair
    assert got["faults"]["total"] > 0 and got["faults"]["device_loss"] == 1
    assert got["schedule_digest"] == want["schedule_digest"]
    assert got["outcome_digest"] == want["outcome_digest"]
    assert got["outcomes"] == [tuple(o) for o in want["outcomes"]]
    assert got["completion_rate"] == 1.0


def test_chaos_failures_are_injected_ones(chaos_pair):
    """Every failure the service counted traces to an injected fault."""
    got, _ = chaos_pair
    f, inj = got["failures"], got["faults"]
    assert f["faults_injected"] == inj["total"]
    assert f["poisoned_lanes"] == inj["poison"]
    failing = inj["compile"] + inj["dispatch"] + inj["poison"] \
        + inj["device_loss"]
    # each retry follows a failed attempt, each failed attempt a fault
    assert 0 < f["retries"] <= failing
    assert all("Injected" in e or "PoisonedLane" in e
               for e in got["last_errors"])


def test_exhausted_retries_degrade_to_solo_with_parity():
    svc = psvc.FleetService(
        max_batch=2, device="cpu",
        injector=psvc.FaultInjector(schedule={i: "compile"
                                              for i in range(1, 9)}),
        retry=psvc.RetryPolicy(max_retries=2, backoff_base_s=1e-4))
    hs = [svc.submit(_dense_churn(), seed=s) for s in (1, 2)]
    svc.drain()
    for s, h in zip((1, 2), hs):
        assert h.status == "degraded" and h.metrics.retries == 3
        ref = psvc.solo_execute(_dense_churn().replace(seed=s), "trace",
                                "cpu")
        assert pr.result_digest(h.result()) == pr.result_digest(ref)
    assert svc.stats()["failures"]["degraded_requests"] == 2


def test_exhausted_retries_without_fallback_fail_typed():
    svc = psvc.FleetService(
        max_batch=1, device="cpu", degrade_to_solo=False,
        injector=psvc.FaultInjector(schedule={i: "dispatch"
                                              for i in range(1, 9)}),
        retry=psvc.RetryPolicy(max_retries=1, backoff_base_s=1e-4))
    h = svc.submit(_dense_churn(), seed=3)
    svc.drain()
    assert h.status == "failed"
    with pytest.raises(psvc.DispatchFailed):
        h.result()


def test_solo_execute_modes_and_overlay_route():
    """solo_execute takes the JAX signature: bench mode runs
    run_bench, and the overlay runs the per-tick route — equal to the
    JAX solo result digest either way."""
    from gossip_protocol_tpu.service.resilience import \
        solo_execute as jax_solo
    jr = importlib.import_module("gossip_protocol_tpu.service.replay")
    for cfg, jcfg, mode in (
            (_dense_churn(), _dense_churn(JaxConfig), "bench"),
            (_dense_churn(), _dense_churn(JaxConfig), "trace"),
            (_overlay(), _overlay(JaxConfig), "trace")):
        got = psvc.solo_execute(cfg, mode, "cpu")
        assert pr.result_digest(got) == jr.result_digest(jax_solo(jcfg,
                                                                  mode))
    bench = psvc.solo_execute(_dense_churn(), "bench", "cpu")
    assert bench.added is None
    ov = psvc.solo_execute(_overlay(), "trace", "cpu")
    assert int(np.asarray(ov.metrics.live_uncovered).min()) >= 0


def test_solo_resume_from_checkpoint_equals_solo():
    cfg = _overlay().replace(seed=5)
    sim = FleetSimulation(cfg, device="cpu")
    from gossip_protocol_tpu_torch.models.segments import checkpoint_ticks
    leg = sim.run_leg(seeds=[5], ticks=checkpoint_ticks(cfg)[0])
    req = psvc.SimRequest(rid=0, cfg=cfg, mode="trace", bucket=(),
                          submit_s=0.0)
    req.resume = leg.checkpoints[0]
    res = psvc.solo_resume(req, "cpu")
    ref = psvc.solo_execute(cfg, "trace", "cpu")
    assert pr._mismatch(pr.Template("o", cfg), ref, res) is None
    dense = _dense_churn(ticks=60).replace(seed=2)
    dleg = FleetSimulation(dense, device="cpu").run_leg(
        seeds=[2], ticks=checkpoint_ticks(dense)[0])
    req = dataclasses.replace(req, cfg=dense)
    req.resume = dleg.checkpoints[0]
    res = psvc.solo_resume(req, "cpu")
    ref = psvc.solo_execute(dense, "trace", "cpu")
    assert pr._mismatch(pr.Template("d", dense), ref, res) is None

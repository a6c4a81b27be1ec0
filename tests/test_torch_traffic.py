"""The port's open-loop traffic plane (service/traffic.py, service/slo.py)
against the JAX package's.

Arrival schedules are pure functions of ``(seed, index)``: the port's
must equal the JAX schedules digest for digest.  Under a
:class:`VirtualClock` every scheduling decision is a function of the
schedule alone, so a run's outcome digest must equal the JAX service's
on the same schedule — with faults injected too.  Sizes are the JAX
traffic tests' (tests/test_traffic.py): dense N=16, at most 26 ticks.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu import service as jsvc
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu_torch import service as psvc
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.service.resilience import solo_execute

torch.set_num_threads(2)
pytestmark = [pytest.mark.service, pytest.mark.traffic]


def _cfgs(pkg_cfg):
    churn = pkg_cfg(max_nnb=16, single_failure=False, drop_msg=False,
                    seed=0, total_ticks=22, fail_tick=20, rejoin_after=15)
    drop = pkg_cfg(max_nnb=16, single_failure=True, drop_msg=True,
                   msg_drop_prob=0.1, seed=0, total_ticks=26, fail_tick=10)
    return churn, drop


def _catalog(pkg, pkg_cfg):
    churn, drop = _cfgs(pkg_cfg)
    return [pkg.Template("dense-churn", churn),
            pkg.Template("dense-drop", drop)]


PATTERNS = {
    "poisson": dict(kind="poisson", rate_rps=6.0),
    "burst": dict(kind="burst", rate_rps=6.0),
    "diurnal": dict(kind="diurnal", rate_rps=4.0, diurnal_period_s=5.0),
    "closed": dict(kind="closed", rate_rps=4.0),
}


@pytest.mark.parametrize("seed", (0, 9))
@pytest.mark.parametrize("kind", sorted(PATTERNS))
def test_schedule_digest_equals_jax(kind, seed):
    mix = {"interactive": 0.35, "standard": 0.5, "batch": 0.15}
    got = psvc.make_schedule(_catalog(psvc, SimConfig), 20,
                             psvc.TrafficPattern(**PATTERNS[kind]),
                             seed=seed, class_mix=mix)
    want = jsvc.make_schedule(_catalog(jsvc, JaxConfig), 20,
                              jsvc.TrafficPattern(**PATTERNS[kind]),
                              seed=seed, class_mix=mix)
    assert got.digest() == want.digest()
    assert [a.t_s for a in got.arrivals] == [a.t_s for a in want.arrivals]
    # the prefix invariant: a shorter schedule is a prefix
    short = psvc.make_schedule(_catalog(psvc, SimConfig), 7,
                               psvc.TrafficPattern(**PATTERNS[kind]),
                               seed=seed, class_mix=mix)
    assert short.arrivals == got.arrivals[:7]


def test_closed_schedule_is_the_replay_trace():
    tpls = _catalog(psvc, SimConfig)
    sched = psvc.closed_schedule(tpls, 3)
    assert [(a.template.name, a.lane_seed) for a in sched.arrivals] \
        == [(t.name, s) for t, s in psvc.build_trace(tpls, 3)]
    assert sched.digest() == jsvc.closed_schedule(
        _catalog(jsvc, JaxConfig), 3).digest()


def test_default_slo_equals_jax():
    a, b = psvc.default_slo(0.5), jsvc.default_slo(0.5)
    assert a.class_mix() == b.class_mix()
    for c in a.classes:
        assert a.deadline_for(c) == b.deadline_for(c)


def _virtual_run(pkg, pkg_cfg, sched_kw, injector_seed=None,
                 fault_rate=0.0, device=None):
    sched = pkg.make_schedule(_catalog(pkg, pkg_cfg), 14,
                              pkg.TrafficPattern(**sched_kw), seed=9,
                              class_mix={"interactive": 1.0})
    vc = pkg.VirtualClock()
    inj = pkg.FaultInjector(seed=injector_seed, fault_rate=fault_rate) \
        if injector_seed is not None else None
    slo = pkg.SLOPolicy(
        classes={"interactive": pkg.ClassPolicy(deadline_s=6.0,
                                                weight=1.0)},
        default_class="interactive", assumed_dispatch_wall_s=0.25,
        safety_factor=1.0)
    kw = dict(max_batch=4, max_wait_s=2.0, clock=vc, sleep=vc.sleep,
              slo=slo, pump_harvest=False, injector=inj,
              retry=pkg.RetryPolicy(max_retries=2, backoff_base_s=1e-3))
    if device is not None:
        kw["device"] = device
    svc = pkg.FleetService(**kw)
    handles, rec = pkg.run_schedule(svc, sched, pace="virtual", clock=vc)
    dig = pkg.outcome_digest(sched, handles, rec["sheds"])
    return sched, handles, dig, (inj.schedule_digest() if inj else None)


@pytest.mark.parametrize("kind", ["burst", "poisson"])
def test_virtual_load_outcome_digest_equals_jax(kind):
    """A seeded open-loop schedule under a VirtualClock: the port's
    outcome digest equals the JAX service's, and every served lane is
    bit-identical to its solo run."""
    sched, hs, got, _ = _virtual_run(psvc, SimConfig, PATTERNS[kind],
                                     device="cpu")
    _, _, want, _ = _virtual_run(jsvc, JaxConfig, PATTERNS[kind])
    assert got == want
    assert all(h is None or h.done for h in hs)
    a, h = sched.arrivals[0], hs[0]
    ref = solo_execute(a.template.cfg.replace(seed=a.lane_seed), "trace",
                       "cpu")
    assert np.array_equal(h.result().sent, ref.sent)


def test_chaos_under_load_digests_equal_jax():
    """A chaos seed under the load generator: fault schedule digest and
    outcome digest equal the JAX run's, and the run replays itself."""
    _, h1, d1, f1 = _virtual_run(psvc, SimConfig, PATTERNS["poisson"], 11,
                                 0.3, device="cpu")
    _, _, d2, f2 = _virtual_run(psvc, SimConfig, PATTERNS["poisson"], 11,
                                0.3, device="cpu")
    _, _, dj, fj = _virtual_run(jsvc, JaxConfig, PATTERNS["poisson"], 11,
                                0.3)
    assert f1 is not None and f1 == f2 == fj
    assert d1 == d2 == dj
    assert all(h is None or h.done for h in h1)


def test_virtual_pacing_guards():
    sched = psvc.make_schedule(_catalog(psvc, SimConfig), 3, seed=1)
    with pytest.raises(ValueError, match="VirtualClock"):
        psvc.run_schedule(psvc.FleetService(device="cpu"), sched,
                          pace="virtual")
    vc = psvc.VirtualClock()
    svc = psvc.FleetService(clock=vc, sleep=vc.sleep, device="cpu")
    with pytest.raises(ValueError, match="pump_harvest"):
        psvc.run_schedule(svc, sched, pace="virtual", clock=vc)

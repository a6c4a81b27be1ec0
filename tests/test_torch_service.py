"""The port's fleet service (gossip_protocol_tpu_torch/service/) against
the live JAX service, bit for bit.

On the CPU the port's service runs its fleets on the plain kernel
versions; every request's ``result_digest`` must equal the JAX
service's digest of the same request, every bucket key the JAX key,
and every lane its own solo run.  Sizes are the JAX service tests'
(tests/test_service.py): dense N <= 16, overlay N <= 128, at most 96
ticks beside the grader's 700-tick N=10 scenarios.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.service import FleetService as JaxService
from gossip_protocol_tpu.service.bucket import bucket_key as jax_bucket_key
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.service import (MODES, FleetService,
                                               bucket_key, pad_configs,
                                               solo_execute)
from gossip_protocol_tpu_torch.service.resilience import solo_run

jr = importlib.import_module("gossip_protocol_tpu.service.replay")
pr = importlib.import_module("gossip_protocol_tpu_torch.service.replay")

torch.set_num_threads(2)
pytestmark = pytest.mark.service


def norm_key(k):
    """A bucket key with every config in it as its dict: the two
    packages' SimConfig classes differ, their fields do not."""
    if isinstance(k, tuple):
        return tuple(norm_key(x) for x in k)
    if dataclasses.is_dataclass(k):
        return ("cfg", tuple(sorted(k.to_dict().items())))
    return k


KEY_CONFIGS = {
    "dense-trace": dict(max_nnb=12, seed=3, total_ticks=60, fail_tick=20),
    "dense-drop": dict(max_nnb=10, drop_msg=True, msg_drop_prob=0.1,
                       total_ticks=80, fail_tick=30),
    "dense-corner": dict(max_nnb=32, drop_msg=True, msg_drop_prob=0.1,
                         total_ticks=60, fail_tick=20, step_rate=0.25),
    "dense-churn": dict(max_nnb=16, single_failure=False, fail_tick=20,
                        rejoin_after=15, total_ticks=60),
    "dense-partition": dict(max_nnb=16, partition_groups=2,
                            partition_open_tick=20, partition_close_tick=40,
                            total_ticks=60, fail_tick=30),
    "overlay": dict(max_nnb=64, model="overlay", single_failure=False,
                    churn_rate=0.25, rejoin_after=16, step_rate=8 / 64,
                    total_ticks=64),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(KEY_CONFIGS))
def test_bucket_key_equals_jax(name, mode):
    """The exact bucket key is the JAX tuple for the same config."""
    kw = KEY_CONFIGS[name]
    got = bucket_key(SimConfig(**kw), mode)
    want = jax_bucket_key(JaxConfig(**kw), mode)
    assert norm_key(got) == norm_key(want)
    assert hash(got) == hash(bucket_key(SimConfig(**kw), mode))


def test_pad_configs_and_modes():
    a, b = SimConfig(max_nnb=10), SimConfig(max_nnb=10, seed=4)
    assert pad_configs([a], 3, b) == [a, b, b]
    with pytest.raises(ValueError):
        pad_configs([a, a], 1, b)
    with pytest.raises(ValueError):
        bucket_key(a, "fast")


def _dense_drop(seed):
    return SimConfig(max_nnb=16, single_failure=True, drop_msg=True,
                     msg_drop_prob=0.1, seed=seed, total_ticks=60,
                     fail_tick=25, drop_open_tick=10, drop_close_tick=45)


def _overlay_churn(seed):
    return SimConfig(max_nnb=64, model="overlay", single_failure=False,
                     drop_msg=False, seed=seed, total_ticks=64,
                     churn_rate=0.25, rejoin_after=16, step_rate=8 / 64)


@pytest.mark.parametrize("mode", ["trace", "bench"])
def test_padded_lanes_equal_solo_runs(mode):
    """Partial batches pad to max_batch with filler lanes; every real
    lane equals its port solo run and the JAX solo run, and filler is
    never handed back."""
    svc = FleetService(max_batch=4, device="cpu")
    cfgs = [_dense_drop(s) for s in (1, 2, 3)]
    if mode == "trace":
        cfgs += [_overlay_churn(s) for s in (5, 6)]
    handles = [svc.submit(c, mode=mode) for c in cfgs]
    svc.drain()
    for c, h in zip(cfgs, handles):
        m = h.metrics
        assert m.padded_batch == 4 and m.batch in (2, 3) and not m.degraded
        got = pr.result_digest(h.result())
        assert got == pr.result_digest(solo_execute(c, mode, "cpu"))
        jcfg = JaxConfig(**c.to_dict())
        from gossip_protocol_tpu.service.resilience import \
            solo_execute as jax_solo
        assert got == jr.result_digest(jax_solo(jcfg, mode)), c
    st = svc.stats()
    assert st["completed"] == len(cfgs) and st["failed"] == 0
    assert st["failures"]["retries"] == 0 and not st["last_errors"]


def test_mixed_trace_builds_once_per_bucket():
    """Each distinct bucket builds its fleet program once; later
    dispatches of the bucket reuse it (zero builds)."""
    svc = FleetService(max_batch=2, device="cpu")
    cfgs = [_dense_drop(s) for s in range(5)] \
        + [_overlay_churn(s) for s in range(3)]
    hs = [svc.submit(c) for c in cfgs]
    svc.drain()
    assert all(h.status == "completed" for h in hs)
    st = svc.stats()
    assert len(st["buckets"]) == 2
    for b in st["buckets"].values():
        assert b["builds"] == 1, st["buckets"]
    assert st["cache"]["misses"] == 2
    # the first dispatch of each bucket (two requests each) built
    assert sum(1 for h in hs if not h.metrics.cache_hit) == 4


@pytest.fixture(scope="module")
def replay_pair():
    """The replay stream through both services, same seeds."""
    jt = jr.build_trace(jr.grader_templates()
                        + jr.overlay_templates(n=128, ticks=48), 2)
    pt = pr.build_trace(pr.grader_templates()
                        + pr.overlay_templates(n=128, ticks=48), 2)
    jres, _, _ = jr.run_service(jt, max_batch=8)
    pres, psvc, _ = pr.run_service(pt, max_batch=8, device="cpu")
    return jt, jres, pt, pres, psvc


def test_replay_result_digests_equal_jax(replay_pair):
    """``replay(grader_templates() + overlay_templates(n=128, ticks=48),
    2)``'s stream: every request's result digest equals the JAX
    service's, and the service ran fault-free."""
    jt, jres, pt, pres, psvc = replay_pair
    assert [(t.name, s) for t, s in jt] == [(t.name, s) for t, s in pt]
    for (tpl, seed), a, b in zip(jt, jres, pres):
        assert jr.result_digest(a) == pr.result_digest(b), (tpl.name, seed)
    st = psvc.stats()
    assert st["completed"] == len(pt) and st["failures"]["retries"] == 0
    assert st["failures"]["degraded_requests"] == 0


def test_replay_parity_harness():
    """The port's ``replay`` (solo leg + service leg, parity checked)
    runs clean on a two-template stream and reports its metrics."""
    tpls = pr.grader_templates()[:1] + pr.overlay_templates(n=64,
                                                            ticks=48)[:1]
    m = pr.replay(tpls, 2, max_batch=2, device="cpu")
    assert m["requests"] == 4 and m["parity_checked"]
    assert m["failures"]["retries"] == 0
    assert m["buckets"] == 2 and m["max_builds_per_bucket"] == 1


def test_result_digest_sees_every_field(replay_pair):
    """A flipped event bit or counter changes the digest, so equal
    digests mean equal results."""
    _, _, pt, pres, _ = replay_pair
    lane = pres[0]
    d0 = pr.result_digest(lane)
    lane2 = dataclasses.replace(lane, sent=lane.sent.copy())
    lane2.sent[0, 0] += 1
    assert pr.result_digest(lane2) != d0
    assert pr._mismatch(pt[0][0], lane, lane2) == "sent"


def test_grade_all_service_90(tmp_path):
    from gossip_protocol_tpu_torch.grader import grade_all_service
    res = grade_all_service("testcases", str(tmp_path), device="cpu")
    assert res["total"] == 90


def test_sweep_digests_equal_jax():
    """``sweep`` over a few catalog families, two seeds each, as one
    service run: all oracles green, and the verdict and outcome digests
    equal the JAX sweep's."""
    from gossip_protocol_tpu.models.scenarios import sweep as jax_sweep
    from gossip_protocol_tpu_torch.models.scenarios import sweep
    fams = ["dense_asym_drop", "dense_partition_blip", "overlay_wave"]
    got = sweep(families=fams, seeds_per_family=2, max_batch=2,
                device="cpu")
    want = jax_sweep(families=fams, seeds_per_family=2, max_batch=2)
    assert got["failed"] == 0 and got["variants"] == 6
    assert got["verdict_digest"] == want["verdict_digest"]
    assert got["outcome_digest"] == want["outcome_digest"]
    assert got["service_failures"]["retries"] == 0


def test_solo_fallback_is_counted():
    """A request the fleet cannot serve degrades to its solo run — and
    the failure is counted and named in stats(), never silent."""
    svc = FleetService(max_batch=2, device="cpu",
                       injector=__import__(
                           "gossip_protocol_tpu_torch.service.faults",
                           fromlist=["FaultInjector"]).FaultInjector(
                               schedule={1: "dispatch", 2: "dispatch",
                                         3: "dispatch", 4: "dispatch"}))
    c = _dense_drop(7)
    h = svc.submit(c)
    svc.drain()
    assert h.status == "degraded"
    st = svc.stats()
    assert st["failures"]["degraded_requests"] == 1
    assert st["failures"]["retries"] == 2
    assert any("InjectedDispatchFailure" in e for e in st["last_errors"])
    assert pr.result_digest(h.result()) == pr.result_digest(
        solo_run(h.request, "cpu"))


def test_default_device_is_cuda():
    """FleetService() runs on the card; without one it raises instead
    of moving to the CPU."""
    if torch.cuda.is_available():
        assert FleetService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FleetService()


def test_mesh_waits_for_the_multi_device_slice():
    with pytest.raises(NotImplementedError, match="M11"):
        FleetService(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="M11"):
        pr.elastic_replay(pr.grader_templates(), 1)


def test_pump_harvests_ready_batches():
    """Pipelined dispatch: a full bucket launches on submit, an idle
    pump harvests it once ready (on the CPU at once), and result()
    of a still-queued request flushes its bucket."""
    svc = FleetService(max_batch=2, device="cpu", pipeline_depth=2)
    h1 = svc.submit(_dense_drop(1))
    h2 = svc.submit(_dense_drop(2))
    assert svc.in_flight == 2 and h1.status == "in_flight"
    svc.pump()
    assert h1.done and h2.done and svc.in_flight == 0
    h3 = svc.submit(_dense_drop(3))
    assert h3.status == "pending"
    assert h3.result() is not None and h3.done
    assert np.array_equal(h1.result().removed,
                          solo_execute(_dense_drop(1), "trace",
                                       "cpu").removed)


def test_jax_service_api_parity():
    """The port's FleetService takes the JAX constructor's keywords
    (less ``block_size``, a TPU tile), plus ``device``."""
    import inspect
    jp = set(inspect.signature(JaxService.__init__).parameters)
    pp = set(inspect.signature(FleetService.__init__).parameters)
    assert jp - pp == {"block_size"} and pp - jp == {"device"}

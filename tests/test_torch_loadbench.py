"""The port's open-loop load bench (service/loadbench.py) against the
JAX package's.

``replay_check`` drives one seed twice through VIRTUAL pacing: its
arrival and outcome digests must equal run for run and equal the JAX
``replay_check``'s on the same catalog and seed (every scheduling
decision is a function of the schedule alone).  A small wall-paced
``measure_point`` may only end in typed load outcomes, on one device and
on a lane mesh.  Sizes are the JAX traffic tests' (dense N=16).
"""

import pytest
import torch

from gossip_protocol_tpu import service as jsvc
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.service import loadbench as jlb
from gossip_protocol_tpu_torch import service as psvc
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.parallel.fleet_mesh import make_lane_mesh
from gossip_protocol_tpu_torch.service import loadbench as plb

torch.set_num_threads(2)
pytestmark = [pytest.mark.service, pytest.mark.traffic]


def _catalog(pkg, pkg_cfg):
    churn = pkg_cfg(max_nnb=16, single_failure=False, drop_msg=False,
                    seed=0, total_ticks=22, fail_tick=20, rejoin_after=15)
    drop = pkg_cfg(max_nnb=16, single_failure=True, drop_msg=True,
                   msg_drop_prob=0.1, seed=0, total_ticks=26, fail_tick=10)
    return [pkg.Template("dense-churn", churn),
            pkg.Template("dense-drop", drop)]


def _slo(pkg, deadline=6.0, wall=0.25):
    return pkg.SLOPolicy(
        classes={"interactive": pkg.ClassPolicy(deadline_s=deadline,
                                                weight=1.0)},
        default_class="interactive", assumed_dispatch_wall_s=wall,
        safety_factor=1.0)


@pytest.mark.parametrize("seed", (4, 11))
def test_replay_check_digests_equal_jax(seed):
    got = plb.replay_check(_catalog(psvc, SimConfig), n_requests=8,
                           rate_rps=6.0, seed=seed, slo=_slo(psvc),
                           device="cpu")
    want = jlb.replay_check(_catalog(jsvc, JaxConfig), n_requests=8,
                            rate_rps=6.0, seed=seed, slo=_slo(jsvc))
    assert got["deterministic"] and want["deterministic"]
    assert got["runs"] == 2 and len(got["arrival_digest"]) == 16
    assert got["arrival_digest"] == want["arrival_digest"]
    assert got["outcome_digest"] == want["outcome_digest"]


@pytest.mark.parametrize("mesh", [False, True])
def test_measure_point_typed_outcomes(mesh):
    """A wall-paced point ends with every handle terminal and only typed
    load outcomes; the row carries the per-class table."""
    row = plb.measure_point(
        _catalog(psvc, SimConfig), n_requests=6, rate_rps=40.0, seed=3,
        slo=_slo(psvc, deadline=30.0), max_batch=2, max_wait_s=0.5,
        mesh=make_lane_mesh(2, device="cpu") if mesh else None,
        device="cpu")
    assert row["requests"] == 6
    assert row["completed"] + row["expired"] + row["shed"] == 6
    assert row["completed"] >= 1 and row["wall_s"] > 0.0
    assert set(row["classes"]) == {"interactive"}
    assert 0.0 <= row["deadline_miss_rate"] <= 1.0
    assert row["latency_p50_s"] <= row["latency_p99_s"]


def test_saturation_rule_and_catalog():
    """The saturation rule and the load catalog are the JAX module's."""
    row = dict(achieved_rps=1.0, offered_rps=2.0, wall_s=3.0, span_s=2.0)
    assert plb._saturated(row) == jlb._saturated(row) is True
    row["wall_s"] = 2.2
    assert plb._saturated(row) == jlb._saturated(row) is False
    assert plb.effective_saturation({"saturation_offered_rps": None}) \
        == float("inf")
    got = [(t.name, t.cfg.n, t.cfg.total_ticks, t.mode)
           for t in plb.load_catalog(n=256, ticks=48)]
    want = [(t.name, t.cfg.n, t.cfg.total_ticks, t.mode)
            for t in jlb.load_catalog(n=256, ticks=48)]
    assert got == want

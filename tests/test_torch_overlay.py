"""The port's overlay equals the JAX package's, tick by tick and run by
run (exact equality of every state field and metric).

* the per-tick tick (K3's route) against the JAX XLA tick, with the
  per-tick ``live_uncovered`` histogram, across join ramps, churn
  windows, slot-epoch boundaries, drops and the F=8 power-law hub cap;
* ``OverlaySimulation.run`` (K4's route at N=64) against the JAX run,
  with ``final_coverage``;
* checkpoints handed over both ways;
* the ``--model overlay`` CLI's JSON.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from tests.conftest import TESTCASES

torch.set_num_threads(2)

STATE_FIELDS = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
                "send_hist", "joinreq", "joinrep")

CASES = {
    "n64_ramp_fail": (dict(max_nnb=64, single_failure=True, seed=3,
                           total_ticks=120, fail_tick=40, step_rate=0.5),
                      100),
    # 160 ticks: the ramp, the churn window (ticks 50-150), the 30-tick
    # rejoins and ten slot-epoch boundaries
    "n64_churn": (dict(max_nnb=64, single_failure=False, seed=7,
                       total_ticks=200, churn_rate=0.25, rejoin_after=30,
                       step_rate=40.0 / 64), 160),
    "n128_drop": (dict(max_nnb=128, single_failure=True, drop_msg=True,
                       msg_drop_prob=0.3, seed=5, total_ticks=120,
                       fail_tick=60, step_rate=0.25, drop_open_tick=10,
                       drop_close_tick=100), 100),
    "n64_powerlaw_f8": (dict(max_nnb=64, single_failure=True, seed=6,
                             total_ticks=100, fail_tick=40,
                             topology="powerlaw", drop_msg=True,
                             msg_drop_prob=0.1, drop_open_tick=20,
                             drop_close_tick=80), 90),
    "n32_multi_rejoin": (dict(max_nnb=32, single_failure=False, seed=11,
                              total_ticks=90, fail_tick=30,
                              rejoin_after=25), 90),
}


def _pair(kw):
    kw = dict(kw, model="overlay")
    return JaxConfig(**kw), SimConfig(**kw)


def _assert_state(jstate, pstate, where=""):
    assert int(np.asarray(jstate.tick)) == pstate.tick, where
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(jstate, f)), getattr(pstate, f).numpy()
        assert np.array_equal(a, b), (where, f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tick_equals_jax_xla_tick(name):
    kw, ticks = CASES[name]
    jc, pc = _pair(kw)
    js = jov.make_overlay_schedule(jc)
    ps = pov.make_overlay_schedule(pc)
    tick_j = jax.jit(jov.make_overlay_tick(jc, use_pallas=False))
    tick_p = pov.make_overlay_tick(pc)
    cols = pov.schedule_columns(ps, pc.n, "cpu")
    sj, sp = jov.init_overlay_state(jc), pov.init_overlay_state(pc, "cpu")
    for t in range(ticks):
        sj, mj = tick_j(sj, js)
        sp, mp = tick_p(sp, ps, cols)
        _assert_state(sj, sp, t)
        want = [int(np.asarray(getattr(mj, f))) for f in pov.METRIC_FIELDS]
        assert want == mp.tolist(), (t, want, mp.tolist())
    assert int(np.asarray(mj.live_uncovered)) >= 0   # tracked at N <= 4096


def test_simulation_equals_jax_run():
    kw, _ = CASES["n64_churn"]
    jc, pc = _pair(kw)
    jr = jov.OverlaySimulation(jc, use_pallas=False).run()
    pr = pov.OverlaySimulation(pc, device="cpu").run()
    _assert_state(jr.final_state, pr.final_state)
    for f in pov.METRIC_FIELDS:
        if f == "live_uncovered":    # -1 on the K4 route, as on the TPU's
            assert (pr.metrics.live_uncovered == -1).all()
            continue
        assert np.array_equal(np.asarray(getattr(jr.metrics, f)),
                              getattr(pr.metrics, f)), f
    assert pr.final_coverage() == jr.final_coverage()
    assert np.array_equal(pr.uncovered_members(), jr.uncovered_members())
    assert pr.ticks_run == jr.ticks_run == pc.total_ticks
    assert int(pr.metrics.in_group[-1]) == pc.n


def test_checkpoint_hand_over_both_ways(tmp_path):
    """JAX k ticks -> npz -> the port continues, and the reverse; each
    continuation equals the uninterrupted JAX run."""
    kw, _ = CASES["n32_multi_rejoin"]
    jc, pc = _pair(kw)
    js = jov.make_overlay_schedule(jc)
    ps = pov.make_overlay_schedule(pc)
    whole, _ = jov.make_overlay_run(jc, 70, use_pallas=False)(
        jov.init_overlay_state(jc), js)

    jmid, _ = jov.make_overlay_run(jc, 33, use_pallas=False)(
        jov.init_overlay_state(jc), js)
    jov.save_overlay_checkpoint(jmid, str(tmp_path / "jax.npz"))
    pmid = pov.load_overlay_checkpoint(str(tmp_path / "jax.npz"), "cpu")
    assert pmid.tick == 33
    pend, _ = pov.make_overlay_run(pc, 37)(pmid, ps)
    _assert_state(whole, pend)

    p33, _ = pov.make_overlay_run(pc, 33, mega=False, grid=False)(
        pov.init_overlay_state(pc, "cpu"), ps)
    pov.save_overlay_checkpoint(p33, str(tmp_path / "port.npz"))
    jback = jov.load_overlay_checkpoint(str(tmp_path / "port.npz"))
    jend, _ = jov.make_overlay_run(jc, 37, use_pallas=False)(jback, js)
    _assert_state(jend, pend)
    host = pov.overlay_state_to_host(p33)
    assert set(host) == set(jov.overlay_state_to_host(jmid))
    for k, v in jov.overlay_state_to_host(jmid).items():
        assert host[k].dtype == v.dtype and host[k].shape == v.shape, k
    resumed = pov.OverlaySimulation(pc, device="cpu").run(resume_from=pmid,
                                                           ticks=37)
    _assert_state(whole, resumed.final_state)
    # a send history (the latency world) loads; a misshapen one raises
    hist = np.ones_like(host["send_hist"])
    back = pov.overlay_state_from_host(dict(host, send_hist=hist), "cpu")
    assert np.array_equal(back.send_hist.numpy(), hist)
    bad = dict(host, send_hist=hist[:, :1])
    with pytest.raises(ValueError):
        pov.overlay_state_from_host(bad, "cpu")


def test_cli_json_equals_jax_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(TESTCASES),
               JAX_PLATFORMS="cpu")
    conf = os.path.join(TESTCASES, "singlefailure.conf")
    args = [conf, "--model", "overlay", "-n", "64", "--ticks", "150"]
    out = {}
    for pkg, extra in (("gossip_protocol_tpu", ["--platform", "cpu"]),
                       ("gossip_protocol_tpu_torch", ["--device", "cpu"])):
        proc = subprocess.run([sys.executable, "-m", pkg, *args, *extra],
                              env=env, cwd=str(tmp_path), capture_output=True,
                              text=True, check=True)
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    a, b = out["gossip_protocol_tpu"], out["gossip_protocol_tpu_torch"]
    assert a.keys() == b.keys()
    for key in ("wall_s", "node_ticks_per_s"):
        a.pop(key)
        b.pop(key)
    assert a == b
    assert b["in_group_final"] == 64


def test_powerlaw_topology_through_the_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(TESTCASES))
    proc = subprocess.run(
        [sys.executable, "-m", "gossip_protocol_tpu_torch",
         os.path.join(TESTCASES, "singlefailure.conf"), "--model", "overlay",
         "--topology", "powerlaw", "-n", "32", "--ticks", "60",
         "--device", "cpu"], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, check=True)
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n"] == 32 and res["ticks"] == 60

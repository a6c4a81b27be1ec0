"""The port end to end against the JAX package, on the CPU.

* the CLI writes byte-identical ``dbg.log`` / ``stats.log`` /
  ``msgcount.log`` for the three course testcases, and the port's grader
  gives them 90;
* whole 700-tick trace runs at N=64 (the port routes them through K2's
  plain version, JAX through its per-tick XLA scan) give equal events,
  counters and final state;
* a bench run on the active corner gives equal counters and stream width;
* a checkpoint written by either package continues in the other.

Exact equality throughout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossip_protocol_tpu import state as jax_state
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core.sim import Simulation as JaxSimulation
from gossip_protocol_tpu.core.sim import run_scenario as jax_run_scenario
from gossip_protocol_tpu_torch import state as port_state
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.sim import Simulation
from tests.conftest import TESTCASES
from tests.test_torch_tick import assert_state_equal

torch.set_num_threads(2)

REPO = os.path.dirname(TESTCASES)
LOGS = ("dbg.log", "stats.log", "msgcount.log")


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("name", ("singlefailure", "multifailure",
                                  "msgdropsinglefailure"))
def test_cli_logs_byte_identical(name, tmp_path):
    conf = os.path.join(TESTCASES, f"{name}.conf")
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    subprocess.run([sys.executable, "-m", "gossip_protocol_tpu_torch", conf,
                    "--device", "cpu", "--quiet", "--outdir", str(port_dir)],
                   check=True, env=_port_env(), cwd=str(tmp_path))
    jax_run_scenario(JaxConfig.from_conf(conf), outdir=str(jax_dir))
    for log in LOGS:
        assert _read(port_dir, log) == _read(jax_dir, log), log
    assert _read(port_dir, "dbg.log").count(b"joined") == 90


def test_port_grader_gives_90(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gossip_protocol_tpu_torch.grader",
         "--testcases", TESTCASES, "--workdir", str(tmp_path),
         "--device", "cpu"],
        check=True, env=_port_env(), capture_output=True, text=True).stdout
    assert out.splitlines()[-1] == "Final grade 90"


def _assert_run_equal(res, jres):
    for name in ("added", "removed", "sent", "recv", "start_tick",
                 "fail_tick", "rejoin_tick"):
        a, b = getattr(res, name), np.asarray(getattr(jres, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert_state_equal(res.final_state, jres.final_state, "final")


@pytest.mark.parametrize("kw", [
    dict(single_failure=False, seed=5),
    dict(single_failure=True, drop_msg=True, msg_drop_prob=0.1, seed=6),
], ids=("multi", "drop"))
def test_trace_run_700_ticks_n64(kw):
    res = Simulation(SimConfig(max_nnb=64, **kw), device="cpu").run()
    jres = JaxSimulation(JaxConfig(max_nnb=64, **kw)).run()
    assert res.sent.shape == (64, 700)
    _assert_run_equal(res, jres)
    assert res.removed.any()


def test_bench_corner_counters():
    """N=256 over 32 ticks starts only peers < 128: both packages run
    the 128-wide corner and draw its drop stream at that width."""
    kw = dict(max_nnb=256, total_ticks=32, single_failure=False,
              drop_msg=True, msg_drop_prob=0.2, drop_open_tick=5,
              drop_close_tick=25, fail_tick=12, seed=8)
    res = Simulation(SimConfig(**kw), device="cpu").run_bench(warmup=False)
    jres = JaxSimulation(JaxConfig(**kw)).run_bench(warmup=False)
    assert res.counter_stream_width == jres.counter_stream_width == 128
    assert np.array_equal(res.sent, np.asarray(jres.sent))
    assert np.array_equal(res.recv, np.asarray(jres.recv))
    assert_state_equal(res.final_state, jres.final_state, "final")
    assert res.sent[:128].sum() > 0 and not res.sent[128:].any()


CKPT_KW = dict(max_nnb=32, single_failure=False, drop_msg=True,
               msg_drop_prob=0.1, seed=11, total_ticks=140)


def test_checkpoint_jax_to_port(tmp_path):
    jsim = JaxSimulation(JaxConfig(**CKPT_KW))
    head = jsim.run(ticks=60)
    path = str(tmp_path / "jax.npz")
    jax_state.save_checkpoint(head.final_state, path)
    jtail = jsim.run(resume_from=head.final_state)
    sim = Simulation(SimConfig(**CKPT_KW), device="cpu")
    for start in (port_state.state_from_host(
                      jax_state.state_to_host(head.final_state), "cpu"),
                  port_state.load_checkpoint(path, "cpu")):
        assert start.tick == 60
        tail = sim.run(resume_from=start)
        assert tail.first_tick == 60 and tail.resumed
        _assert_run_equal(tail, jtail)


def test_checkpoint_port_to_jax(tmp_path):
    sim = Simulation(SimConfig(**CKPT_KW), device="cpu")
    head = sim.run(ticks=75)
    path = str(tmp_path / "port.npz")
    port_state.save_checkpoint(head.final_state, path)
    tail = sim.run(resume_from=head.final_state)
    jsim = JaxSimulation(JaxConfig(**CKPT_KW))
    for start in (jax_state.state_from_host(
                      port_state.state_to_host(head.final_state)),
                  jax_state.load_checkpoint(path)):
        jtail = jsim.run(resume_from=start)
        _assert_run_equal(tail, jtail)
    # and the port reads its own checkpoint back unchanged
    again = port_state.load_checkpoint(path, "cpu")
    assert_state_equal(again, jax_state.load_checkpoint(path), "reload")


@pytest.mark.slow
def test_n512_multifailure_removal_ticks():
    """The BASELINE N=512 multifailure config (seed 0) through t=135:
    both packages remove the same victim entries at the same ticks —
    55,296 at fail + TREMOVE + 1 = 121 and 1,024 one tick later, where
    a victim's largest heartbeat was still being relayed one tick after
    the failure.  ``chip_smoke.py`` checks this split on the card."""
    kw = dict(max_nnb=512, single_failure=False, seed=0)
    res = Simulation(SimConfig(**kw), device="cpu").run(ticks=135)
    jres = JaxSimulation(JaxConfig(**kw)).run(ticks=135)
    _assert_run_equal(res, jres)
    victims = res.fail_tick != port_state.NEVER
    rm = res.removed[:, ~victims][:, :, victims].sum((1, 2))
    assert {t: int(c) for t, c in enumerate(rm) if c} == {121: 55296,
                                                          122: 1024}

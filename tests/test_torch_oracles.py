"""The port's copies of the reference's independent engines — the scalar
oracles (testing/oracle.py, testing/overlay_oracle.py, testing/dropsync.py)
and the native bindings (compat/native.py) — against the JAX package's,
and the port's runs against them (testing/checks.py).

These engines are neither the JAX package nor the port's tick, so the
card's check (``chip_smoke.py`` phase 4b) rests on them; here each copy
is first held equal to its JAX original on the parity configs of
tests/test_parity.py, test_churn.py, test_worlds.py and test_overlay.py.
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest
import torch

from gossip_protocol_tpu import worlds as jax_worlds
from gossip_protocol_tpu.compat import native as jax_native
from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.state import make_schedule_host as jax_sched_host
from gossip_protocol_tpu.testing.dropsync import \
    make_drop_masks as jax_drop_masks
from gossip_protocol_tpu.testing.oracle import \
    ReferenceOracle as JaxReferenceOracle
from gossip_protocol_tpu.testing.overlay_oracle import \
    OverlayOracle as JaxOverlayOracle
from gossip_protocol_tpu_torch import worlds
from gossip_protocol_tpu_torch.compat import native
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.models.overlay import OverlaySimulation
from gossip_protocol_tpu_torch.state import make_schedule_host
from gossip_protocol_tpu_torch.testing import checks
from gossip_protocol_tpu_torch.testing.dropsync import make_drop_masks
from gossip_protocol_tpu_torch.testing.oracle import ReferenceOracle
from gossip_protocol_tpu_torch.testing.overlay_oracle import OverlayOracle

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scenario(name, **kw):
    return dict(SimConfig.from_conf(f"testcases/{name}.conf").to_dict(), **kw)


def _dense_world(**kw):
    return dict(dict(max_nnb=16, single_failure=True, drop_msg=False,
                     seed=2, total_ticks=120, fail_tick=40), **kw)


DENSE = {
    "single_s0": _scenario("singlefailure"),
    "multi_s1": _scenario("multifailure", seed=1),
    "msgdrop_s2": _scenario("msgdropsinglefailure", seed=2),
    "churn40_drop": _scenario("msgdropsinglefailure", max_nnb=16, seed=2,
                              fail_tick=30, rejoin_after=40,
                              total_ticks=160),
    "churn10": _scenario("singlefailure", max_nnb=16, seed=2, fail_tick=30,
                         rejoin_after=10, total_ticks=160),
    "partition": _dense_world(partition_groups=2, partition_open_tick=30,
                              partition_close_tick=70),
    "asym_drop": _dense_world(drop_msg=True, msg_drop_prob=0.12,
                              asym_drop=True, drop_open_tick=10,
                              drop_close_tick=90),
    "wave": _dense_world(single_failure=False, wave_size=6, wave_tick=40,
                         wave_speed=2),
    "zombie": _dense_world(zombie=True),
    "flapping": _dense_world(flap_rate=0.4, flap_period=24, flap_down=6,
                             fail_tick=10_000),
}


def _overlay(**kw):
    return dict(dict(model="overlay", single_failure=True, drop_msg=False,
                     seed=0, max_nnb=32, total_ticks=80, fail_tick=30), **kw)


OVERLAY = {
    "plain": _overlay(),
    "drop": _overlay(drop_msg=True, msg_drop_prob=0.15, drop_open_tick=10,
                     drop_close_tick=60),
    "churn_rate": _overlay(single_failure=False, churn_rate=0.3,
                           rejoin_after=20, total_ticks=120, seed=5),
    "partition": _overlay(partition_groups=2, partition_open_tick=20,
                          partition_close_tick=55, seed=4),
    "flapping": _overlay(flap_rate=0.4, flap_period=24, flap_down=6,
                         fail_tick=10_000, total_ticks=100, seed=10),
}


def _oracle_inputs(cfg, sched, drops_fn, flap_fn):
    inject = cfg.drop_msg or cfg.partition_groups >= 2
    drops = drops_fn(cfg, sched) if inject else (None, None, None)
    return drops, (flap_fn(cfg) if cfg.flap_rate > 0 else None)


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_oracle_and_dropsync_equal_jax(name):
    """The port's ReferenceOracle and dropsync against the JAX ones on
    the same schedule: identical drop masks, events, tables and
    counters."""
    cfg, jcfg = SimConfig(**DENSE[name]), JaxConfig(**DENSE[name])
    sched, jsched = make_schedule_host(cfg), jax_sched_host(jcfg)
    drops, flap = _oracle_inputs(cfg, sched, make_drop_masks,
                                 worlds.make_flap_state)
    jdrops, jflap = _oracle_inputs(jcfg, jsched, jax_drop_masks,
                                   jax_worlds.make_flap_state)
    for a, b in zip(drops, jdrops):
        assert (a is None and b is None) or np.array_equal(a, b)
    cols = [np.asarray(getattr(sched, k)) for k in
            ("start_tick", "fail_tick")]
    o = ReferenceOracle(cfg, *cols, *drops, rejoin_tick=sched.rejoin_tick,
                        flap_state=flap).run()
    jo = JaxReferenceOracle(jcfg, *cols, *jdrops,
                            rejoin_tick=jsched.rejoin_tick,
                            flap_state=jflap).run()
    assert o.events.added == jo.events.added
    assert o.events.removed == jo.events.removed
    assert np.array_equal(o.sent, jo.sent) and np.array_equal(o.recv, jo.recv)
    assert np.array_equal(o.known_matrix(), jo.known_matrix())
    for what in ("hb", "ts"):
        assert np.array_equal(o.table(what), jo.table(what))


@pytest.mark.parametrize("name", sorted(OVERLAY))
def test_overlay_oracle_equals_jax(name):
    cfg, jcfg = SimConfig(**OVERLAY[name]), JaxConfig(**OVERLAY[name])
    o, jo = OverlayOracle(cfg), JaxOverlayOracle(jcfg)
    for t in range(cfg.total_ticks):
        assert o.step() == jo.step(), (name, t)
    for f in ("ids", "hb", "ts", "send_flags", "in_group", "own_hb",
              "joinreq", "joinrep"):
        assert np.array_equal(getattr(o, f), getattr(jo, f)), (name, f)


@pytest.mark.parametrize("name", sorted(DENSE))
def test_port_dense_run_against_port_oracle(name):
    res = Simulation(SimConfig(**DENSE[name]), device="cpu").run()
    summary = checks.check_dense_oracle(res)
    assert summary["joins"] > 0


@pytest.mark.parametrize("name,kw", [
    ("churn64", dict(model="overlay", max_nnb=64, single_failure=False,
                     drop_msg=False, seed=0, total_ticks=64,
                     churn_rate=0.25, rejoin_after=16, step_rate=8.0 / 64)),
    ("drop128", dict(model="overlay", max_nnb=128, single_failure=True,
                     drop_msg=True, msg_drop_prob=0.1, seed=3,
                     total_ticks=96, fail_tick=40, drop_open_tick=20,
                     drop_close_tick=70, step_rate=16.0 / 128)),
    ("partition", OVERLAY["partition"]),
])
def test_port_overlay_run_against_port_oracle(name, kw):
    res = OverlaySimulation(SimConfig(**kw), device="cpu").run()
    assert checks.check_overlay_oracle(res)["ticks"] == res.ticks_run


def test_oracle_checks_catch_a_wrong_run():
    """The checks fail on a run that is not the config's: a removal
    dropped from the events, or a heartbeat table off by one more than
    the join transient."""
    res = Simulation(SimConfig(**DENSE["single_s0"]), device="cpu").run()
    bad = dataclasses.replace(res, removed=np.zeros_like(res.removed))
    with pytest.raises(AssertionError):
        checks.check_dense_oracle(bad)
    ores = OverlaySimulation(SimConfig(**OVERLAY["drop"]), device="cpu").run()
    hb = ores.final_state.hb.clone()
    hb[3, 0] += 1
    with pytest.raises(AssertionError):
        checks.check_overlay_oracle(dataclasses.replace(
            ores, final_state=dataclasses.replace(ores.final_state,
                                                  hb=hb)))


NATIVE_SOURCES = ("params.cc", "logsink.cc", "bus.cc", "engine.cc")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The native library, built by one g++ call into a directory of this
    module's own (other test processes may be running ``make`` in the
    checkout at the same time), and both packages' bindings pointed at
    it for the module."""
    out = tmp_path_factory.mktemp("native") / native.LIB_NAME
    src = [os.path.join(REPO, "native", f) for f in NATIVE_SOURCES]
    try:
        res = subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                              *src, "-o", str(out)], capture_output=True,
                             timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"libgossip_native.so cannot be built here ({e})")
    if res.returncode != 0:
        pytest.skip("libgossip_native.so cannot be built here (g++: "
                    f"{res.stderr.decode()[-300:]})")
    mp = pytest.MonkeyPatch()
    for mod in (native, jax_native):
        mp.setattr(mod, "lib_path", lambda: str(out))
        mp.setattr(mod, "_lib", None)
    lib = native.load(auto_build=False)
    assert lib is not None and jax_native.load(auto_build=False) is not None
    yield lib
    mp.undo()


def test_native_bindings_equal_jax(lib):
    """The port's bindings and the JAX package's drive the same library
    to the same values: ``hash_uniform``, and the bus's drop and send /
    receive accounting over one scripted exchange."""
    for seed, a, b, c, d in [(0, 0, 0, 0, 7), (42, 1, 2, 3, 4),
                             (2**63, 699, 999, 1023, 0)]:
        assert native.hash_uniform(seed, a, b, c, d) == \
            jax_native.hash_uniform(seed, a, b, c, d)

    def drive(mod):
        with mod.NativeBus(max_nodes=6, total_ticks=20, drop_prob=0.4,
                           seed=9) as bus:
            peers = [bus.init() for _ in range(6)]
            kept, got = [], []
            for t in range(20):
                for s in peers:
                    kept.append(bus.send(s, (s + t) % 6, bytes([s, t]), t,
                                         drop_active=t >= 5))
                for r in peers:
                    got.append(tuple(bus.recv(r, t)))
            sent, recv = bus.counters()
            return kept, got, sent, recv, bus.inflight

    mine, theirs = drive(native), drive(jax_native)
    assert mine[:2] == theirs[:2] and mine[4] == theirs[4]
    assert np.array_equal(mine[2], theirs[2])
    assert np.array_equal(mine[3], theirs[3])
    assert not all(mine[0]) and any(mine[0])


@pytest.mark.parametrize("case", checks.NATIVE_CASES,
                         ids=[c[0] for c in checks.NATIVE_CASES])
def test_native_events_equal_port(lib, case):
    """The native message-level engine's join / removal event sets equal
    the port's run with the same pinned failure schedule."""
    got = checks.check_native_case(case, device="cpu")
    assert got["joins"] > 0

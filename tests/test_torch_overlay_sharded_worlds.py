"""The port's peer-sharded overlay runs the adversarial worlds.

Each overlay world (partition, asym drop, zombie, flap, byz, latency) at
N=64 over a ``cpu`` x P mesh, held bit for bit against the live JAX
``make_sharded_overlay_run(use_pallas=False)`` on the conftest's virtual
CPU devices and against the port's single-device run: every table
(``send_hist`` included), vector and per-tick metric.  The JAX builder's
``_SHARDED_CACHE`` keys leave out the world flags, so it is cleared
before each config and after it (a later test in the same process must
not get a world program for a plain config).
"""

import dataclasses

import numpy as np
import pytest

from gossip_protocol_tpu.config import SimConfig as JSimConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.models import overlay_sharded as jos
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models.overlay_sharded import (
    make_overlay_mesh, make_sharded_overlay_run, shard_overlay_state)

STATE_FIELDS = ("ids", "hb", "ts", "send_flags", "send_hist", "in_group",
                "own_hb", "joinreq", "joinrep")

WORLDS = {
    "partition": dict(partition_groups=2, partition_open_tick=30,
                      partition_close_tick=60),
    "asym_drop": dict(drop_msg=True, msg_drop_prob=0.1, asym_drop=True,
                      drop_open_tick=10, drop_close_tick=80),
    "zombie": dict(zombie=True),
    "flapping": dict(flap_rate=0.3, flap_period=24, flap_down=6,
                     fail_tick=10_000),
    "byz": dict(byz_rate=0.15, byz_boost=8),
    "latency": dict(link_latency=4),
}


@pytest.fixture(autouse=True)
def _fresh_jax_sharded_cache():
    jos._SHARDED_CACHE.clear()
    yield
    jos._SHARDED_CACHE.clear()


def _kw(world):
    kw = dict(model="overlay", max_nnb=64, seed=3, total_ticks=90,
              single_failure=True, drop_msg=False, fail_tick=30)
    kw.update(WORLDS[world])
    return kw


def _port_runs(cfg, p):
    sched = pov.make_overlay_schedule(cfg)
    state = pov.init_overlay_state(cfg, "cpu")
    solo = pov.make_overlay_run(cfg, mega=False, grid=False)(state, sched)
    mesh = make_overlay_mesh(p, device="cpu")
    sharded = make_sharded_overlay_run(cfg, mesh)(
        shard_overlay_state(state, mesh), sched)
    return solo, sharded


def _assert_equal(got, want, where):
    (final, met), (wfinal, wmet) = got, want
    for f in STATE_FIELDS:
        a, b = getattr(final, f).numpy(), np.asarray(getattr(wfinal, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f)
    assert final.tick == int(np.asarray(wfinal.tick))
    for f in dataclasses.fields(wmet):
        assert np.array_equal(getattr(met, f.name).numpy(),
                              np.asarray(getattr(wmet, f.name))), \
            (where, f.name)


@pytest.mark.parametrize("p,world", [(2, w) for w in WORLDS]
                         + [(8, "latency")])
def test_sharded_world_run_equals_jax_and_solo(world, p):
    kw = _kw(world)
    jcfg, cfg = JSimConfig(**kw), SimConfig(**kw)
    jmesh = jos.make_overlay_mesh(p)
    jrun = jos.make_sharded_overlay_run(jcfg, jmesh, use_pallas=False)(
        jos.shard_overlay_state(jov.init_overlay_state(jcfg), jmesh),
        jov.make_overlay_schedule(jcfg))
    solo, sharded = _port_runs(cfg, p)
    _assert_equal(sharded, jrun, (world, p, "jax"))
    _assert_equal(sharded, solo, (world, p, "solo"))
    assert sharded[0].tick == cfg.total_ticks
    if cfg.link_latency:
        assert int(sharded[0].send_hist.max()) > 1
    if cfg.partition_groups:
        assert int(sharded[1].removals.sum()) > 0


def test_one_shard_world_run_is_the_solo_run():
    """A one-entry mesh hands the tick a comm of one shard, which the
    worlds' exchange treats as none: the run is the single-device run
    and the JAX single-device run."""
    kw = dict(_kw("zombie"), drop_msg=True, msg_drop_prob=0.06,
              asym_drop=True, drop_open_tick=10, drop_close_tick=80)
    j = jov.OverlaySimulation(JSimConfig(**kw), use_pallas=False).run()
    solo, sharded = _port_runs(SimConfig(**kw), 1)
    _assert_equal(sharded, (j.final_state, j.metrics), "jax")
    _assert_equal(sharded, solo, "solo")

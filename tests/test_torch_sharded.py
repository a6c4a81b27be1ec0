"""The port's peer-sharded dense run equals the JAX package's.

``gossip_protocol_tpu_torch.parallel`` runs P shards of a one-process
mesh (here ``cpu`` x P, the counterpart of the JAX tests' virtual CPU
devices).  Held bit for bit, on the same numpy inputs and configs:

* ``RingComm``'s transpose, row gather, OR and ring merge against the
  JAX ``RingComm`` inside JAX ``shard_map``, P in {2, 4, 8};
* the rectangular ``masked_max3`` (plain, as the CPU wrapper runs it;
  with and without the lane axis) against JAX ``gossip_reductions_mxu``
  on the same blocks, 5 x 5 x 10 included;
* ``make_sharded_run`` against JAX ``make_sharded_run`` and against the
  port's single-device run on the ``test_sharded.py`` scenarios, every
  state field, event mask and counter.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

from gossip_protocol_tpu.compat.jaxapi import shard_map as jax_shard_map
from gossip_protocol_tpu.ops import merge as jax_merge
from gossip_protocol_tpu.parallel import comm as jax_comm
from gossip_protocol_tpu.parallel import sharded as jax_sharded
from gossip_protocol_tpu.state import init_state as jax_init_state
from gossip_protocol_tpu.state import make_schedule as jax_make_schedule
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.sim import Simulation
from gossip_protocol_tpu_torch.ops import merge
from gossip_protocol_tpu_torch.parallel import mesh as tmesh
from gossip_protocol_tpu_torch.parallel.comm import RingComm
from gossip_protocol_tpu_torch.parallel.sharded import (make_mesh,
                                                        make_sharded_run,
                                                        shard_state)
from gossip_protocol_tpu_torch.state import init_state, make_schedule
from tests.conftest import TESTCASES, scenario_cfg

NOW, T_REMOVE = 50, 20


def _jmesh(p):
    return JMesh(np.array(jax.devices()[:p]), ("peers",))


def _planes(rng, rows, cols):
    return (rng.random((rows, cols)) < 0.7,
            rng.integers(0, 60, (rows, cols), dtype=np.int32),
            rng.integers(NOW - 2 * T_REMOVE, NOW + 1, (rows, cols),
                         dtype=np.int32))


def _port_shard_map(body, p, in_specs, out_specs):
    return tmesh.shard_map(body, make_mesh(p, device="cpu"), in_specs,
                           out_specs)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_comm_collectives_match_jax(p):
    """transpose, gather_rows, or_across and merge_reduce of the port's
    RingComm equal the JAX RingComm's (``use_pallas=False`` and True) on
    the same row-sharded inputs."""
    n = 4 * p
    rng = np.random.default_rng(p)
    x = rng.random((n, n)) < 0.4
    v = rng.random(n) < 0.2
    known, hb, ts = _planes(rng, n, n)
    jc = jax_comm.RingComm("peers", p, use_pallas=True)

    mat = JP("peers", None)
    jout = jax.jit(jax_shard_map(
        lambda x, v, k, h, t: (jc.transpose(x),
                               jc.gather_rows(v),
                               jc.or_across(v)[None, :],
                               *jc.merge_reduce(jc.transpose(x), k, h, t,
                                                np.int32(NOW),
                                                t_remove=T_REMOVE,
                                                block_size=8)[:3]),
        mesh=_jmesh(p), in_specs=(mat, JP("peers"), mat, mat, mat),
        out_specs=(mat, JP(), JP("peers", None), mat, mat, mat),
        check_vma=False))(x, v, known, hb, ts)
    rc = RingComm("peers", p)

    def tbody(x, v, k, h, t):
        rf = rc.transpose(x)
        return (rf, rc.gather_rows(v), rc.or_across(v)[None, :],
                *rc.merge_reduce(rf, k, h, t, NOW, t_remove=T_REMOVE))

    tm = tmesh.P("peers", None)
    tout = _port_shard_map(
        tbody, p, (tm, tmesh.P("peers"), tm, tm, tm),
        (tm, tmesh.P(), tmesh.P("peers", None), tm, tm, tm))(
        *(torch.from_numpy(a) for a in (x, v, known, hb, ts)))
    for name, a, b in zip(("transpose", "gather", "or", "m_all", "m_fresh",
                           "t_fresh"), tout, jout):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert np.array_equal(tout[0].numpy(), x.T)


@pytest.mark.parametrize("r,s,c", [(5, 5, 10), (16, 16, 64), (7, 12, 30),
                                   (33, 2, 40)])
def test_rect_masked_max3_matches_jax(r, s, c):
    """The rectangular merge: an S x R delivery block against S x C
    payload rows, solo and with a lane axis of 2."""
    rng = np.random.default_rng(r * 100 + s)
    lanes = []
    for _ in range(2):
        gossip = rng.random((s, r)) < 0.5
        proc = rng.random(r) < 0.8
        known, hb, ts = _planes(rng, s, c)
        lanes.append((gossip, proc, known, hb, ts))
    got_l = merge.masked_max3(*(torch.from_numpy(np.stack(a))
                                for a in zip(*lanes)), NOW,
                              t_remove=T_REMOVE)
    for b, (gossip, proc, known, hb, ts) in enumerate(lanes):
        ref = jax_merge.gossip_reductions_mxu(
            (gossip & proc[None, :]).T, known, hb, ts, np.int32(NOW),
            t_remove=T_REMOVE)
        got = merge.masked_max3(*(torch.from_numpy(a) for a in
                                  (gossip, proc, known, hb, ts)), NOW,
                                t_remove=T_REMOVE)
        for a, a_l, e in zip((*got, got[2] >= 0), (*(g[b] for g in got_l),
                                                    got_l[2][b] >= 0), ref):
            assert a.shape == (r, c)
            assert np.array_equal(a.numpy(), np.asarray(e))
            assert np.array_equal(a_l.numpy(), np.asarray(e))


SCENARIOS = {
    "singlefailure": dict(name="singlefailure", seed=0, total_ticks=200),
    "msgdrop": dict(name="msgdropsinglefailure", seed=0, total_ticks=200),
    "msgdrop_seed3": dict(name="msgdropsinglefailure", seed=3,
                          total_ticks=150),
}


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("scen", list(SCENARIOS))
def test_sharded_run_matches_jax_and_local(scen, p):
    """The port's sharded run == the JAX sharded run == the port's
    single-device run: every event mask, counter and state field."""
    kw = dict(SCENARIOS[scen])
    name = kw.pop("name")
    jcfg = scenario_cfg(name, max_nnb=16, **kw)
    cfg = SimConfig.from_conf(f"{TESTCASES}/{name}.conf", max_nnb=16, **kw)
    jrun = jax_sharded.make_sharded_run(jcfg, _jmesh(p),
                                        use_pallas=scen == "msgdrop_seed3")
    jm = _jmesh(p)
    jfinal, jev = jrun(jax_sharded.shard_state(jax_init_state(jcfg), jm),
                       jax_make_schedule(jcfg))
    local = Simulation(cfg, device="cpu").run()
    mesh = make_mesh(p, device="cpu")
    final, ev = make_sharded_run(cfg, mesh)(
        shard_state(init_state(cfg, device="cpu"), mesh),
        make_schedule(cfg, device="cpu"))
    for f in ("added", "removed", "sent", "recv"):
        a = getattr(ev, f).numpy()
        assert np.array_equal(a, np.asarray(getattr(jev, f))), f
    assert np.array_equal(ev.added.numpy(), local.added)
    assert np.array_equal(ev.removed.numpy(), local.removed)
    assert np.array_equal(ev.sent.numpy().T, local.sent)
    assert np.array_equal(ev.recv.numpy().T, local.recv)
    for f in ("known", "hb", "ts", "in_group", "own_hb", "gossip",
              "gossip_age", "joinreq", "joinrep"):
        a = getattr(final, f).numpy()
        assert np.array_equal(a, np.asarray(getattr(jfinal, f))), f
        assert np.array_equal(a, getattr(local.final_state, f).numpy()), f
    assert final.tick == int(jfinal.tick) == cfg.total_ticks


def test_sharded_bench_mode_counters():
    """Bench mode (events off) over 4 shards: the counters and the final
    tables equal the single-device run's; the masks are placeholders."""
    cfg = SimConfig.from_conf(f"{TESTCASES}/msgdropsinglefailure.conf",
                              max_nnb=16, seed=5, total_ticks=80)
    mesh = make_mesh(4, device="cpu")
    final, ev = make_sharded_run(cfg, mesh, with_events=False)(
        shard_state(init_state(cfg, device="cpu"), mesh),
        make_schedule(cfg, device="cpu"))
    local = Simulation(cfg, device="cpu").run()
    assert ev.added.shape == (cfg.total_ticks,)
    assert np.array_equal(ev.sent.numpy().T, local.sent)
    assert np.array_equal(ev.recv.numpy().T, local.recv)
    assert np.array_equal(final.hb.numpy(), local.final_state.hb.numpy())


def test_sharded_rejects_non_dividing_n():
    """A peer count that does not divide the mesh raises, as in JAX."""
    cfg = SimConfig.from_conf(f"{TESTCASES}/singlefailure.conf",
                              total_ticks=10)          # N = 10
    with pytest.raises(ValueError, match="divide the mesh"):
        make_sharded_run(cfg, make_mesh(4, device="cpu"))
    jcfg = scenario_cfg("singlefailure", total_ticks=10)
    with pytest.raises(AssertionError, match="divide the mesh"):
        jax_sharded.make_sharded_run(jcfg, _jmesh(4))


def test_shard_error_fails_the_run_without_hanging():
    """A shard that raises aborts the others' barriers; the caller gets
    the shard's error."""
    def body(x):
        if tmesh.ctx().axis_index("peers") == 1:
            raise RuntimeError("shard 1 failed")
        return tmesh.ctx().psum(x, "peers")

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        _port_shard_map(body, 4, (tmesh.P("peers"),), tmesh.P("peers"))(
            torch.arange(8))

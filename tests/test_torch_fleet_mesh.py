"""Meshes of fleets on the port (parallel/fleet_mesh.py), bit for bit.

The ``test_fleet_mesh.py`` cases on ``cpu`` x D meshes (the counterpart
of the JAX tests' virtual CPU devices).  Dense mesh lanes are held
against the port's single-device fleet and the JAX SOLO runs (never the
JAX dense mesh programs, which stop on some jax releases' ``cond``
varying-axis check, ``ops/drop.py:63``); overlay mesh lanes also against
the live JAX ``MeshFleetSimulation``.  Mesh lanes equal fleet lanes
equal solo runs (``fleet_mesh.py`` docstring, "Bit-identical lanes").
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.core.sim import Simulation as JaxSimulation
from gossip_protocol_tpu.models.overlay import \
    OverlaySimulation as JaxOverlaySimulation
from gossip_protocol_tpu.parallel import fleet_mesh as jfm
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
from gossip_protocol_tpu_torch.core.tick import run_build_count
from gossip_protocol_tpu_torch.ops.merge import masked_max3
from gossip_protocol_tpu_torch.parallel.fleet_mesh import (
    MeshFleetSimulation, grow_mesh, make_lane_mesh, make_lane_peer_bench_fn,
    make_lane_peer_mesh, mesh_axis_sizes, mesh_descriptor, shrink_mesh)
from gossip_protocol_tpu_torch.parallel.mesh import Mesh
from gossip_protocol_tpu_torch.service import FleetService

DENSE_STATE = ("in_group", "own_hb", "known", "hb", "ts", "gossip",
               "joinreq", "joinrep")
OV_STATE = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
            "joinreq", "joinrep")
OV_METRICS = ("in_group", "view_slots", "adds", "removals",
              "false_removals", "victim_slots", "sent", "recv")
SEEDS = [1, 2, 3, 4]


def _dense_churn(n=32, ticks=60):
    return dict(max_nnb=n, single_failure=False, drop_msg=False, seed=0,
                total_ticks=ticks, fail_tick=20, rejoin_after=15)


def _dense_drop(n=24, ticks=40):
    return dict(max_nnb=n, single_failure=True, drop_msg=True,
                msg_drop_prob=0.1, seed=0, total_ticks=ticks, fail_tick=15)


def _overlay_churn(n=64, ticks=64):
    return dict(max_nnb=n, model="overlay", single_failure=False,
                drop_msg=False, seed=0, total_ticks=ticks, churn_rate=0.25,
                rejoin_after=16, step_rate=8.0 / n)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _dense_equal(got, want, ctx, events=True):
    for f in ("sent", "recv") + (("added", "removed") if events else ()):
        assert np.array_equal(_np(getattr(got, f)),
                              _np(getattr(want, f))), (ctx, f)
    for f in DENSE_STATE:
        assert np.array_equal(_np(getattr(got.final_state, f)),
                              _np(getattr(want.final_state, f))), (ctx, f)


def _overlay_equal(got, want, ctx):
    for f in OV_STATE:
        assert np.array_equal(_np(getattr(got.final_state, f)),
                              _np(getattr(want.final_state, f))), (ctx, f)
    for f in OV_METRICS:
        assert np.array_equal(_np(getattr(got.metrics, f)),
                              _np(getattr(want.metrics, f))), (ctx, f)


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_dense_bench_parity(d):
    """A D-entry lane mesh bench fleet == the port's fleet == the JAX
    solo ``run_bench``, per lane."""
    kw = _dense_drop()
    cfg = SimConfig(**kw)
    mesh = MeshFleetSimulation(cfg, make_lane_mesh(d, device="cpu")) \
        .run_bench(seeds=SEEDS)
    fleet = FleetSimulation(cfg, device="cpu").run_bench(seeds=SEEDS)
    jsim = JaxSimulation(JaxConfig(**kw))
    assert mesh.batch == len(SEEDS)
    assert 0.0 < mesh.device_seconds <= mesh.wall_seconds
    for i, s in enumerate(SEEDS):
        _dense_equal(mesh.lanes[i], fleet.lanes[i], f"D={d} fleet {i}",
                     events=False)
        _dense_equal(mesh.lanes[i], jsim.run_bench(seed=s),
                     f"D={d} jax solo {i}", events=False)


def test_mesh_dense_trace_parity():
    """Trace mode, whole and tick-chunked: events and tables equal the
    JAX solo runs and the port's fleet."""
    kw = _dense_drop()
    cfg = SimConfig(**kw)
    mesh = make_lane_mesh(2, device="cpu")
    whole = MeshFleetSimulation(cfg, mesh).run(seeds=SEEDS)
    parts = MeshFleetSimulation(cfg, mesh, chunk_ticks=16).run(seeds=SEEDS)
    fleet = FleetSimulation(cfg, device="cpu").run(seeds=SEEDS)
    jsim = JaxSimulation(JaxConfig(**kw))
    for i, s in enumerate(SEEDS):
        ref = jsim.run(seed=s)
        for tag, lane in (("whole", whole.lanes[i]),
                          ("chunk", parts.lanes[i])):
            _dense_equal(lane, ref, f"{tag} {i}")
            _dense_equal(lane, fleet.lanes[i], f"{tag} fleet {i}")


_OVERLAY_REFS: dict = {}


def _overlay_refs(seeds):
    """The port's single-device fleet and two JAX solo runs of the
    overlay churn config, computed once for every entry count."""
    if not _OVERLAY_REFS:
        kw = _overlay_churn()
        _OVERLAY_REFS["fleet"] = FleetSimulation(
            SimConfig(**kw), device="cpu").run(seeds=seeds)
        _OVERLAY_REFS["jax"] = [
            JaxOverlaySimulation(JaxConfig(**kw).replace(seed=s),
                                 use_pallas=False).run() for s in seeds[:2]]
    return _OVERLAY_REFS["fleet"], _OVERLAY_REFS["jax"]


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_overlay_parity(d):
    """The overlay mesh fleet across entry counts == the JAX solo runs
    and the port's fleet; ``live_uncovered`` is the fleet's -1."""
    cfg = SimConfig(**_overlay_churn())
    seeds = list(range(1, 9))
    got = MeshFleetSimulation(cfg, make_lane_mesh(d, device="cpu")) \
        .run(seeds=seeds)
    fleet, jax_solo = _overlay_refs(seeds)
    for i in range(len(seeds)):
        _overlay_equal(got.lanes[i], fleet.lanes[i], f"D={d} fleet {i}")
        if i < 2:
            _overlay_equal(got.lanes[i], jax_solo[i], f"D={d} jax solo {i}")
        assert np.all(_np(got.lanes[i].metrics.live_uncovered) == -1)


def test_mesh_overlay_equals_jax_mesh_fleet():
    """The overlay lane mesh also equals the live JAX
    ``MeshFleetSimulation`` on a 2-device mesh, lane for lane."""
    kw = _overlay_churn(ticks=32)
    jax_res = jfm.MeshFleetSimulation(
        JaxConfig(**kw), jfm.make_lane_mesh(2)).run(seeds=[5, 6])
    got = MeshFleetSimulation(SimConfig(**kw), make_lane_mesh(
        2, device="cpu")).run(seeds=[5, 6])
    for i in range(2):
        _overlay_equal(got.lanes[i], jax_res.lanes[i], f"lane {i}")


def test_mesh_rejects_indivisible_batch():
    cfg = SimConfig(**_overlay_churn())
    sim = MeshFleetSimulation(cfg, make_lane_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="divide.*lanes"):
        sim.run(seeds=[1, 2, 3])
    # foreign axis names are rejected once, at construction
    with pytest.raises(ValueError, match="serving meshes are 1-D"):
        MeshFleetSimulation(cfg, Mesh(
            np.array(["cpu", "cpu"], dtype=object).reshape(2, 1),
            ("a", "b")))
    with pytest.raises(ValueError, match="serving meshes are 1-D"):
        mesh_axis_sizes(object())
    m2 = MeshFleetSimulation(cfg, make_lane_peer_mesh(2, 2, device="cpu"))
    assert (m2.n_lanes, m2.n_peers, m2.n_devices) == (2, 2, 4)
    with pytest.raises(ValueError, match="divide.*lanes"):
        m2.run(seeds=[1, 2, 3])
    # the JAX error text, the same words
    with pytest.raises(ValueError, match="divide.*lanes"):
        jfm.MeshFleetSimulation(JaxConfig(**_overlay_churn()),
                                jfm.make_lane_mesh(2)).run(seeds=[1, 2, 3])


def test_mesh_descriptors_and_program_keys():
    """A 2x4 and a 4x2 mesh differ, a mesh's prefix differs from it, and
    a mesh fleet's programs never share a key with the solo fleet's."""
    a = make_lane_peer_mesh(2, 4, device="cpu")
    b = make_lane_peer_mesh(4, 2, device="cpu")
    assert mesh_descriptor(a) != mesh_descriptor(b)
    m4 = make_lane_mesh(4, device="cpu")
    assert mesh_descriptor(shrink_mesh(m4)) != mesh_descriptor(m4)
    cfg = SimConfig(**_dense_churn(n=16, ticks=12))
    built = run_build_count()
    FleetSimulation(cfg, device="cpu").run(seeds=[1, 2])
    MeshFleetSimulation(cfg, make_lane_mesh(2, device="cpu")).run(
        seeds=[1, 2])
    assert run_build_count() == built + 2


def test_mesh_service_shard_divisible_padding_parity():
    """A partial batch through a mesh service pads to a shard-divisible
    width; every real lane equals its JAX solo run."""
    kw = _dense_churn(n=16, ticks=22)
    cfg = SimConfig(**kw)
    svc = FleetService(max_batch=2, mesh=make_lane_mesh(2, device="cpu"))
    assert svc.capacity == 4 and svc.device.type == "cpu"
    handles = [svc.submit(cfg, seed=s) for s in (1, 2, 3)]
    svc.drain()
    jsim = JaxSimulation(JaxConfig(**kw))
    for s, h in zip((1, 2, 3), handles):
        _dense_equal(h.result(), jsim.run(seed=s), f"seed {s}")
        m = h.metrics
        assert m.batch == 3 and m.padded_batch == 4


def test_lane_peer_mesh_parity_with_fleet():
    """The standalone 2-D program (the fleet's bench tick with the
    RingComm exchange inside) == the 1-D fleet: final states and the
    per-tick counters.  Every peer-sharded merge runs the rectangular
    ``masked_max3`` with its lane axis."""
    cfg = SimConfig(max_nnb=16, total_ticks=30, drop_msg=True,
                    msg_drop_prob=0.1, single_failure=True)
    cfgs = [cfg.replace(seed=s) for s in (1, 2)]
    fsim = FleetSimulation(cfg, device="cpu")
    from gossip_protocol_tpu_torch.state import make_schedule_host
    staged = fsim._stage_dense(cfgs, [make_schedule_host(c) for c in cfgs],
                               True)
    run = make_lane_peer_bench_fn(cfg, make_lane_peer_mesh(2, 4,
                                                           device="cpu"))
    out, (sent, recv) = run(fsim._init_stacked(cfgs, cfg.n), staged)
    ref, ev = fsim._dense_fn("bench", 2, cfg.total_ticks, cfg.n, True)(
        fsim._init_stacked(cfgs, cfg.n), staged)
    assert torch.equal(sent, ev.sent) and torch.equal(recv, ev.recv)
    for f in DENSE_STATE:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert np.array_equal(out.rng, ref.rng)


def test_lane_peer_mesh_rejects_bad_shapes():
    cfg = SimConfig(**_dense_drop(n=24))
    with pytest.raises(ValueError, match="2-D"):
        make_lane_peer_bench_fn(cfg, make_lane_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        make_lane_peer_bench_fn(cfg.replace(max_nnb=25),
                                make_lane_peer_mesh(2, 2, device="cpu"))


def test_mesh2d_dense_trace_and_bench_parity():
    """A 2-D lanes x peers mesh runs the peer-sharded fleet tick where
    the width divides the peer axis: every lane == the JAX solo run."""
    kw = dict(max_nnb=16, total_ticks=30, drop_msg=True, msg_drop_prob=0.1,
              single_failure=True)
    cfg = SimConfig(**kw)
    m2 = MeshFleetSimulation(cfg, make_lane_peer_mesh(2, 4, device="cpu"))
    assert (m2.n_lanes, m2.n_peers) == (2, 4)
    assert m2._peer_comm(cfg.n) is not None
    jsim = JaxSimulation(JaxConfig(**kw))
    rect0 = masked_max3.rect_launches
    tr = m2.run(seeds=SEEDS)
    for i, s in enumerate(SEEDS):
        _dense_equal(tr.lanes[i], jsim.run(seed=s), f"2-D trace {i}")
    bench = m2.run_bench(seeds=SEEDS)
    for i, s in enumerate(SEEDS):
        _dense_equal(bench.lanes[i], jsim.run_bench(seed=s),
                     f"2-D bench {i}", events=False)
    assert masked_max3.rect_launches == rect0      # CPU: no launches


def test_mesh2d_replicated_fallback_parity():
    """Widths that do not divide the peer axis, and the overlay, serve
    peer-replicated: lanes still equal the JAX solo runs."""
    mesh2 = make_lane_peer_mesh(2, 4, device="cpu")
    kw = dict(max_nnb=10, total_ticks=30, drop_msg=True, msg_drop_prob=0.1,
              single_failure=True)
    m2 = MeshFleetSimulation(SimConfig(**kw), mesh2)
    assert m2._peer_comm(10) is None
    jsim = JaxSimulation(JaxConfig(**kw))
    tr = m2.run(seeds=SEEDS)
    for i, s in enumerate(SEEDS):
        _dense_equal(tr.lanes[i], jsim.run(seed=s), f"replicated {i}")
    okw = _overlay_churn(ticks=32)
    ov = MeshFleetSimulation(SimConfig(**okw), mesh2).run(seeds=SEEDS[:2])
    for i, s in enumerate(SEEDS[:2]):
        ref = JaxOverlaySimulation(JaxConfig(**okw).replace(seed=s),
                                   use_pallas=False).run()
        _overlay_equal(ov.lanes[i], ref, f"overlay 2-D {i}")


def test_mesh2d_service_mixed_replay_parity():
    """FleetService over the 2-D mesh: peer-sharded and peer-replicated
    buckets side by side, every request == its JAX solo run; capacity
    follows the lane axis, the stats speak the 2-D shape."""
    mesh2 = make_lane_peer_mesh(2, 4, device="cpu")
    sharded = dict(max_nnb=16, total_ticks=24, drop_msg=True,
                   msg_drop_prob=0.1, single_failure=True, seed=0)
    replicated = _dense_churn(n=10, ticks=24)
    svc = FleetService(max_batch=2, mesh=mesh2)
    assert svc.capacity == 4 and (svc.n_lanes, svc.n_peers) == (2, 4)
    handles = [(kw, s, svc.submit(SimConfig(**kw), seed=s))
               for kw in (sharded, replicated) for s in (1, 2, 3)]
    svc.drain()
    for kw, s, h in handles:
        _dense_equal(h.result(), JaxSimulation(JaxConfig(**kw)).run(seed=s),
                     f"n={kw['max_nnb']} seed {s}")
    st = svc.stats()
    assert st["devices"] == 8 and st["lanes"] == 2 and st["peers"] == 4
    assert st["failed"] == 0 and st["failures"]["degraded_requests"] == 0


def test_grow_mesh_ladder():
    """The 1-D ladder's descriptors are functions of the rung, and equal
    the JAX ladder's shapes."""
    assert grow_mesh(None, None) is None
    m4 = make_lane_mesh(4, device="cpu")
    full = tuple(m4.entries())
    m3 = shrink_mesh(m4)
    assert mesh_descriptor(grow_mesh(m3, full)) == mesh_descriptor(m4)
    m2 = shrink_mesh(m3)
    assert shrink_mesh(m2) is None
    assert mesh_descriptor(grow_mesh(None, full)) == mesh_descriptor(m2)
    assert grow_mesh(m4, full) is m4
    # the 2-D ladder: peers halve first, then the lanes; grow inverts it
    m24 = make_lane_peer_mesh(2, 4, device="cpu")
    full2 = tuple(m24.entries())
    m22 = shrink_mesh(m24)
    assert mesh_axis_sizes(m22) == (2, 2, "peers")
    m2l = shrink_mesh(m22)
    assert mesh_axis_sizes(m2l) == (2, 1, None)
    assert shrink_mesh(m2l) is None
    up = grow_mesh(m2l, full2, full_shape=(2, 4),
                   full_axes=("lanes", "peers"))
    assert mesh_descriptor(up) == mesh_descriptor(m22)
    up = grow_mesh(up, full2, full_shape=(2, 4),
                   full_axes=("lanes", "peers"))
    assert mesh_descriptor(up) == mesh_descriptor(m24)

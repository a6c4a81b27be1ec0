"""Elastic serving on the port's mesh (service/replay.py
``elastic_replay``, service/scheduler.py ``_degrade_mesh`` /
``_grow_mesh``), bit for bit.

The ``test_elastic.py`` cases on ``cpu`` x D meshes: a device loss
shrinks the mesh, a return grows it back, checkpointed lanes migrate
across both rebuilds and never restart from tick 0, and every result
equals the port's solo run and the JAX solo run.  ``elastic_replay``'s
in-line gate runs on a 4-entry mesh, twice, with equal digests; the 2-D
ladder (peers halve first) is held against the port's own solo runs.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models.overlay import \
    OverlaySimulation as JaxOverlaySimulation
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
from gossip_protocol_tpu_torch.core.tick import run_build_count
from gossip_protocol_tpu_torch.models.segments import checkpoint_ticks
from gossip_protocol_tpu_torch.parallel.fleet_mesh import (
    MeshFleetSimulation, make_lane_mesh, make_lane_peer_mesh)
from gossip_protocol_tpu_torch.service import (BreakerPolicy, FaultInjector,
                                               FleetService, RetryPolicy)
from gossip_protocol_tpu_torch.service.replay import (Template,
                                                      elastic_replay,
                                                      overlay_templates)
from gossip_protocol_tpu_torch.service.resilience import solo_execute

torch.set_num_threads(2)
pytestmark = [pytest.mark.service, pytest.mark.resilience]

OV_STATE = ("ids", "hb", "ts", "in_group", "own_hb", "send_flags",
            "joinreq", "joinrep")
OV_METRICS = ("in_group", "view_slots", "adds", "removals",
              "false_removals", "victim_slots", "sent", "recv")
DENSE_STATE = ("in_group", "own_hb", "known", "hb", "ts", "gossip",
               "joinreq", "joinrep")


def _overlay_churn_drop(n=64, ticks=96):
    return dict(max_nnb=n, model="overlay", single_failure=False,
                drop_msg=True, msg_drop_prob=0.1, seed=0, total_ticks=ticks,
                churn_rate=0.2, rejoin_after=30, step_rate=12 / n,
                drop_open_tick=ticks // 3, drop_close_tick=2 * ticks // 3)


def _dense_churn_drop(n=16, ticks=60):
    return dict(max_nnb=n, single_failure=False, drop_msg=True,
                msg_drop_prob=0.1, seed=0, total_ticks=ticks, fail_tick=30,
                rejoin_after=15, drop_open_tick=10, drop_close_tick=50)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _overlay_equal(ref, got, tag=""):
    for f in OV_STATE:
        assert np.array_equal(_np(getattr(ref.final_state, f)),
                              _np(getattr(got.final_state, f))), (tag, f)
    for f in OV_METRICS:
        assert np.array_equal(_np(getattr(ref.metrics, f)),
                              _np(getattr(got.metrics, f))), (tag, f)


def _dense_equal(ref, got, tag=""):
    for f in ("added", "removed", "sent", "recv"):
        assert np.array_equal(_np(getattr(ref, f)), _np(getattr(got, f))), \
            (tag, f)
    for f in DENSE_STATE:
        assert np.array_equal(_np(getattr(ref.final_state, f)),
                              _np(getattr(got.final_state, f))), (tag, f)


def _fast_retry():
    return RetryPolicy(max_retries=3, backoff_base_s=1e-4)


def test_mesh_leg_resume_and_cross_mesh_migration():
    """A checkpoint is mesh-independent: a leg run on a 2-entry mesh
    resumes on one device and the reverse, bit-identical to the
    uninterrupted fleet; the leg's checkpoints name the mesh."""
    cfg = SimConfig(**_overlay_churn_drop())
    cut = checkpoint_ticks(cfg)[0]
    cfgs = [cfg.replace(seed=s) for s in (1, 2, 3, 4)]
    full = FleetSimulation(cfg, device="cpu").run(configs=cfgs,
                                                  warmup=False)
    msim = MeshFleetSimulation(cfg, make_lane_mesh(2, device="cpu"))
    leg = msim.run_leg(configs=cfgs, ticks=cut)
    assert all(ck.mesh_desc == msim._mesh_entry()
               for ck in leg.checkpoints)
    leg = FleetSimulation(cfg, device="cpu").run_leg(
        resume=leg.checkpoints)
    for ref, got in zip(full.lanes, leg.results().lanes):
        _overlay_equal(ref, got, "mesh->solo")
    leg = FleetSimulation(cfg, device="cpu").run_leg(configs=cfgs,
                                                     ticks=cut)
    leg = msim.run_leg(resume=leg.checkpoints)
    for ref, got in zip(full.lanes, leg.results().lanes):
        _overlay_equal(ref, got, "solo->mesh")


def test_device_return_grows_mesh_migrates_lanes_and_rekeys():
    """Loss shrinks 2 entries -> one device (lanes migrate down), a
    return grows it back (lanes migrate up), the cache RE-KEYS to the
    restored mesh's handle and its programs, every result == the JAX
    solo run.  The port keys an overlay fleet program by its leg's start
    tick (K5 segments its plan from it), so a fresh batch on the
    restored mesh builds only the legs the mesh never ran before the
    loss; the batch after that builds nothing."""
    kw = _overlay_churn_drop()
    ov = SimConfig(**kw)
    svc = FleetService(max_batch=2, mesh=make_lane_mesh(2, device="cpu"),
                       checkpoint_every=16,
                       injector=FaultInjector(device_loss_at=2,
                                              device_return_at=4),
                       retry=_fast_retry(),
                       breaker=BreakerPolicy(reset_after_s=float("inf")))
    hs = [svc.submit(ov, seed=s) for s in (1, 2, 3, 4)]
    svc.pump()
    svc.drain()
    assert all(h.status == "completed" for h in hs)
    st = svc.stats()
    assert st["failures"]["device_losses"] == 1
    assert st["failures"]["device_returns"] == 1
    assert st["elastic"]["mesh_grows"] == 1
    assert st["elastic"]["lanes_migrated"] >= 8
    assert st["elastic"]["restarted_lanes"] == 0
    assert st["devices"] == 2 and svc.n_devices == 2
    assert st["cache"]["rekey_hits"] >= 1
    for s, h in zip((1, 2, 3, 4), hs):
        ref = JaxOverlaySimulation(JaxConfig(**kw).replace(seed=s),
                                   use_pallas=False).run()
        _overlay_equal(ref, h.result(), f"seed {s}")
    built = run_build_count()
    h2 = [svc.submit(ov, seed=s) for s in (5, 6, 7, 8)]
    svc.drain()
    assert all(h.status == "completed" for h in h2)
    assert run_build_count() - built < h2[0].metrics.legs, \
        "the restored mesh rebuilt its pre-loss programs"
    built = run_build_count()
    h3 = [svc.submit(ov, seed=s) for s in (9, 10, 11, 12)]
    svc.drain()
    assert all(h.status == "completed" for h in h3)
    assert run_build_count() == built


def test_shrink_grow_shrink_chaos_seed_replays_digest_for_digest():
    """shrink -> grow -> shrink reproduces its fault schedule and
    per-request outcomes across two runs, with zero restarts."""
    ov = SimConfig(**_overlay_churn_drop())

    def run_once():
        inj = FaultInjector(seed=11, schedule={2: "device_loss",
                                               4: "device_return",
                                               6: "device_loss"})
        svc = FleetService(max_batch=2, mesh=make_lane_mesh(2,
                                                            device="cpu"),
                           checkpoint_every=16, injector=inj,
                           retry=_fast_retry(),
                           breaker=BreakerPolicy(reset_after_s=float("inf")))
        hs = [svc.submit(ov, seed=s) for s in (1, 2, 3, 4)]
        svc.drain()
        st = svc.stats()
        assert st["elastic"]["restarted_lanes"] == 0
        return (inj.schedule_digest(), st["devices"],
                tuple((h.request.rid, h.status, h.metrics.retries,
                       h.metrics.legs) for h in hs))

    a, b = run_once(), run_once()
    assert a == b
    assert a[1] == 1 and all(o[1] == "completed" for o in a[2])


def test_elastic_replay_gate_on_four_entry_mesh():
    """elastic_replay's in-line gate on a 4-entry mesh: 100% completion,
    >= 1 loss and return, zero restarts, migration, the mesh back at 4
    entries, parity with the solo leg; a second run replays the fault
    schedule and the outcomes digest for digest."""
    tpls = [Template("churn-drop", SimConfig(**_overlay_churn_drop()))] \
        + overlay_templates(n=64, ticks=96)[:1]
    mesh = make_lane_mesh(4, device="cpu")
    m, seq = elastic_replay(tpls, seeds_per_template=4, max_batch=1,
                            mesh=mesh, checkpoint_every=32, fault_seed=7,
                            return_legs=True)
    assert m["completion_rate"] == 1.0 and m["parity_checked"]
    assert m["faults"]["device_loss"] >= 1
    assert m["faults"]["device_return"] >= 1
    assert m["restarted_from_zero"] == 0
    assert m["elastic"]["lanes_migrated"] >= 1
    assert m["devices_end"] == m["devices_start"] == 4
    assert m["mean_legs"] > 1.0
    m2 = elastic_replay(tpls, seeds_per_template=4, max_batch=1,
                        mesh=make_lane_mesh(4, device="cpu"),
                        checkpoint_every=32, fault_seed=7, sequential=seq)
    assert m2["schedule_digest"] == m["schedule_digest"]
    assert m2["outcome_digest"] == m["outcome_digest"]


def test_peer_shard_loss_on_2d_mesh_zero_restarts():
    """On a 2-D lanes x peers mesh a device loss halves the PEER axis
    (lanes untouched), a return doubles it back; the peer-sharded dense
    requests resume across both re-shardings and equal the port's solo
    runs."""
    kw = _dense_churn_drop()
    cfg = SimConfig(**kw)
    svc = FleetService(max_batch=2, mesh=make_lane_peer_mesh(2, 4,
                                                             device="cpu"),
                       checkpoint_every=16,
                       injector=FaultInjector(device_loss_at=2,
                                              device_return_at=4),
                       retry=_fast_retry(),
                       breaker=BreakerPolicy(reset_after_s=float("inf")))
    hs = [svc.submit(cfg, seed=s) for s in (1, 2, 3, 4)]
    svc.drain()
    st = svc.stats()
    assert all(h.status == "completed" for h in hs)
    assert st["failures"]["device_losses"] == 1
    assert st["elastic"]["mesh_grows"] == 1
    assert st["elastic"]["restarted_lanes"] == 0
    assert st["elastic"]["lanes_migrated"] >= 1
    assert (st["devices"], st["lanes"], st["peers"]) == (8, 2, 4)
    for s, h in zip((1, 2, 3, 4), hs):
        _dense_equal(solo_execute(cfg.replace(seed=s), "trace",
                                  device="cpu"), h.result(), f"seed {s}")

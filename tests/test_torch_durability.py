"""The port's durability plane (gossip_protocol_tpu_torch/store/) against
the JAX package's.

Spill files and journal records keep the JAX layout, so a run directory
written by either package is recovered by the other: a JAX service cut
mid-run (in process, its ``on_kill`` raising) is finished by the port's
``FleetService.recover`` to the uninterrupted run's digests, and the
reverse.  Journal records of the same stream are equal across the
packages (the port's meta record adds only ``device``).  Sizes are the
JAX durability tests' (tests/test_durability.py): overlay N <= 64,
dense N <= 12, at most 96 ticks beside the grader's N=10 scenarios.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.store import harness as jax_harness
from gossip_protocol_tpu.store.journal import read_journal as jax_read
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core.fleet import (FleetSimulation,
                                                  checkpoint_arrays,
                                                  checkpoint_from_arrays)
from gossip_protocol_tpu_torch.models.segments import checkpoint_ticks
from gossip_protocol_tpu_torch.service import FleetService
from gossip_protocol_tpu_torch.store import (CheckpointStore,
                                             CheckpointValidationError,
                                             RunStore, inspect_spill,
                                             read_journal, verify_spill)
from gossip_protocol_tpu_torch.store import harness
from gossip_protocol_tpu_torch.store.spill import (
    checkpoint_digest_from_arrays, save_spill)

pr = importlib.import_module("gossip_protocol_tpu_torch.service.replay")

torch.set_num_threads(2)
pytestmark = [pytest.mark.service, pytest.mark.resilience]

#: the mixed stream of the kill-and-restart gate at test size
STREAM = dict(seeds_per_template=1, n_overlay=64, t_overlay=48,
              max_batch=2, checkpoint_every=16)


def _overlay_churn_drop(n=32, ticks=96):
    return SimConfig(max_nnb=n, model="overlay", single_failure=False,
                     drop_msg=True, msg_drop_prob=0.1, seed=0,
                     total_ticks=ticks, churn_rate=0.2, rejoin_after=30,
                     step_rate=12 / n, drop_open_tick=ticks // 3,
                     drop_close_tick=2 * ticks // 3)


def _dense_churn_drop(n=12, ticks=60):
    return SimConfig(max_nnb=n, single_failure=False, drop_msg=True,
                     msg_drop_prob=0.1, seed=0, total_ticks=ticks,
                     fail_tick=30, rejoin_after=15, drop_open_tick=10,
                     drop_close_tick=50)


def _checkpoints(cfg, seeds=(1, 2)):
    cut = checkpoint_ticks(cfg)[0]
    return FleetSimulation(cfg, device="cpu").run_leg(
        seeds=list(seeds), ticks=cut).checkpoints


@pytest.mark.parametrize("family", ["overlay", "dense"])
def test_spill_roundtrip_and_digest(tmp_path, family):
    cfg = _overlay_churn_drop() if family == "overlay" \
        else _dense_churn_drop()
    for ck in _checkpoints(cfg):
        meta, arrays = checkpoint_arrays(ck)
        assert checkpoint_digest_from_arrays(meta, arrays) == ck.digest()
        path = str(tmp_path / f"{ck.digest()}.npz")
        save_spill(path, meta, arrays)
        meta2, arrays2 = verify_spill(path)
        back = checkpoint_from_arrays(meta2, arrays2)
        assert back.digest() == ck.digest() and back.tick == ck.tick
        for k in ck.state:
            assert np.array_equal(back.state[k], ck.state[k]), k
        assert len(back.chunks) == len(ck.chunks)


def test_corrupt_spill_raises_with_repro(tmp_path):
    store = CheckpointStore(str(tmp_path / "spill"), max_ram_snapshots=1)
    cks = _checkpoints(_dense_churn_drop(), seeds=(1, 2))
    refs = [store.ref(ck) for ck in cks]
    path = os.path.join(store.spill_dir, f"{refs[0].digest}.npz")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(CheckpointValidationError, match="inspect_spill"):
        store.fetch(refs[0].digest)
    v = inspect_spill(str(tmp_path), refs[0].digest)
    assert not v["ok"]
    ok = inspect_spill(str(tmp_path), refs[1].digest)
    assert ok["ok"] and ok["tick"] == cks[1].tick


def test_inspect_spill_needs_no_card(tmp_path):
    """inspect_spill runs in a process that sees no CUDA device and
    never initializes torch's CUDA."""
    store = CheckpointStore(str(tmp_path / "spill"))
    ref = store.ref(_checkpoints(_overlay_churn_drop(), seeds=(3,))[0])
    code = ("import sys, torch\n"
            "from gossip_protocol_tpu_torch.store import inspect_spill\n"
            f"v = inspect_spill({str(tmp_path)!r}, {ref.digest!r})\n"
            "assert v['ok'], v\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _baseline_digests():
    """The uninterrupted stream's per-rid result digests (equal in both
    packages, tests/test_torch_service.py)."""
    trace = pr.build_trace(harness._templates(STREAM["n_overlay"],
                                              STREAM["t_overlay"]),
                           STREAM["seeds_per_template"])
    svc = FleetService(max_batch=STREAM["max_batch"],
                       checkpoint_every=STREAM["checkpoint_every"],
                       device="cpu")
    pr.warm(trace, svc)
    results, svc, _ = pr.run_service(trace, service=svc)
    return {i: pr.result_digest(r) for i, r in enumerate(results)}, \
        svc._dispatch_count


@pytest.fixture(scope="module")
def baseline():
    return _baseline_digests()


class _Killed(Exception):
    pass


def _kill():
    raise _Killed


def _finish(pre_records, svc, handles, drive, digest, want):
    pre = {r["rid"]: r.get("digest") for r in pre_records
           if r.get("rec") == "outcome"}
    assert drive(svc)
    post = {rid: digest(h.result()) for rid, h in handles.items()}
    assert not set(pre) & set(post)
    got = {**pre, **post}
    assert got == want
    assert svc.stats()["elastic"]["restarted_lanes"] == 0
    return len(pre), len(post)


@pytest.mark.parametrize("frac", [0.3, 0.7])
def test_jax_run_dir_recovered_by_the_port(tmp_path, baseline, frac):
    """A JAX service cut mid-run; the port recovers its run directory
    on the CPU and finishes every request to the uninterrupted digests,
    with no lane restarted from tick 0."""
    want, dispatches = baseline
    run_dir = str(tmp_path / "run")
    with pytest.raises(_Killed):
        jax_harness._serve(run_dir, kill_after=max(1, int(dispatches
                                                          * frac)),
                           on_kill=_kill, **STREAM)
    svc, handles = FleetService.recover(run_dir, device="cpu")
    assert svc.device.type == "cpu" and svc.checkpoint_every == 16
    n_pre, n_post = _finish(read_journal(run_dir), svc, handles,
                            harness._drive, pr.result_digest, want)
    assert n_post > 0


@pytest.mark.parametrize("frac", [0.3, 0.7])
def test_port_run_dir_recovered_by_jax(tmp_path, baseline, frac):
    """The reverse: the port's service cut mid-run, the JAX package
    recovers the run directory and finishes it to the same digests."""
    from gossip_protocol_tpu.service import FleetService as JaxService
    from gossip_protocol_tpu.service.replay import result_digest as jdig
    want, dispatches = baseline
    run_dir = str(tmp_path / "run")
    with pytest.raises(_Killed):
        harness._serve(run_dir, kill_after=max(1, int(dispatches * frac)),
                       on_kill=_kill, device="cpu", **STREAM)
    recs = jax_read(run_dir)
    assert recs[0]["service"]["device"] == "cpu"
    svc, handles = JaxService.recover(run_dir)
    n_pre, n_post = _finish(recs, svc, handles, jax_harness._drive, jdig,
                            want)
    assert n_post > 0


def _by_request(records):
    """Journal records grouped per request, in append order: where a
    cut lands between other requests' records depends on when an idle
    pump finds a batch ready (wall time), what each request's own
    records say does not."""
    out = {}
    for r in records:
        if "rid" in r:
            out.setdefault(r["rid"], []).append(r)
    return out


def test_journal_records_equal_jax(tmp_path):
    """The same stream served to completion by each package writes the
    same journal: the meta record (the port's adds ``device``), the
    submits in order, and each request's cut and outcome records,
    checkpoint and result digests included.  No record holds a
    wall-clock time."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert harness._serve(a, kill_after=None, device="cpu", **STREAM)
    assert jax_harness._serve(b, kill_after=None, **STREAM)
    ra, rb = read_journal(a), jax_read(b)
    assert ra[0]["service"].pop("device") == "cpu"
    assert ra[0] == rb[0] and len(ra) == len(rb)
    assert [r for r in ra if r["rec"] == "submit"] \
        == [r for r in rb if r["rec"] == "submit"]
    assert _by_request(ra) == _by_request(rb)
    kinds = {r["rec"] for r in ra}
    assert {"meta", "submit", "cut", "outcome"} <= kinds


def test_kill_restart_replay_in_process(tmp_path):
    """The acceptance harness on the CPU, in process: the gate (every
    request terminal once, zero restarted lanes, digests equal to the
    uninterrupted baseline) holds."""
    m, base = harness.kill_restart_replay(
        child=False, device="cpu", run_dir=str(tmp_path / "run"),
        kill_frac=0.5, **STREAM)
    assert m["digest_match"] and m["restarted_lanes"] == 0
    assert m["completed"] == m["requests"] == 6
    assert m["completed_before_kill"] + m["recovered_requests"] == 6
    assert m["failures"]["retries"] == 0
    assert m["durability"]["spills"] > 0


def test_run_store_stats_and_meta_keys(tmp_path):
    """The meta record carries the JAX key set (recovery's
    _META_PARAMS), so the JAX package reads a port run directory."""
    from gossip_protocol_tpu.store.recovery import _META_PARAMS
    svc = FleetService(max_batch=2, checkpoint_every=16, device="cpu",
                       store=RunStore(str(tmp_path)))
    meta = read_journal(str(tmp_path))[0]["service"]
    assert set(_META_PARAMS) <= set(meta)
    assert svc.stats()["durability"]["journal_records"] == 1

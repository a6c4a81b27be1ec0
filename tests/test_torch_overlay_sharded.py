"""The port's peer-sharded overlay equals the JAX package's.

The per-tick overlay tick over a ``cpu`` x P mesh (the counterpart of
the JAX tests' virtual CPU devices), K3's sharded contract in its plain
version, held bit for bit against the live JAX ``make_sharded_overlay_run``
(the XLA phases, and the Pallas kernel in interpret mode where
``test_overlay_sharded.py`` runs it) and against the port's
single-device run: every table, vector and metric.  K3's sharded
arguments (``masks_local``, ``row_start``, ``aux_rounds``,
``pw_rounds``) are also held against the JAX kernel on the inputs a
sharded run gives one shard.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gossip_protocol_tpu.config import SimConfig as JSimConfig
from gossip_protocol_tpu.models import overlay as jov
from gossip_protocol_tpu.models import overlay_sharded as jos
from gossip_protocol_tpu.ops.pallas.overlay_exchange import \
    fused_overlay_tick as jax_fused_overlay_tick
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import overlay as pov
from gossip_protocol_tpu_torch.models.overlay_sharded import (
    RingOverlayComm, make_overlay_mesh, make_sharded_overlay_run,
    shard_overlay_state)
from gossip_protocol_tpu_torch.ops.cuda.overlay_exchange import \
    fused_overlay_tick_plain

STATE_FIELDS = ("ids", "hb", "ts", "send_flags", "in_group", "own_hb",
                "joinreq", "joinrep")


def _kw(scenario):
    kw = dict(model="overlay", max_nnb=64, seed=3, total_ticks=90,
              single_failure=True, drop_msg=False, fail_tick=30)
    if scenario == "drop":
        kw.update(drop_msg=True, msg_drop_prob=0.15, drop_open_tick=10,
                  drop_close_tick=70)
    elif scenario == "churn":
        kw.update(single_failure=False, churn_rate=0.3, rejoin_after=20,
                  total_ticks=120)
    elif scenario == "kernel":
        kw = dict(model="overlay", max_nnb=128, seed=7, total_ticks=90,
                  single_failure=True, drop_msg=True, msg_drop_prob=0.1,
                  fail_tick=40, drop_open_tick=10, drop_close_tick=80,
                  step_rate=0.5)
    return kw


def _check(p, scenario, use_pallas):
    kw = _kw(scenario)
    jcfg, cfg = JSimConfig(**kw), SimConfig(**kw)
    jsched = jov.make_overlay_schedule(jcfg)
    jmesh = jos.make_overlay_mesh(p)
    jfinal, jmet = jos.make_sharded_overlay_run(
        jcfg, jmesh, use_pallas=use_pallas)(
        jos.shard_overlay_state(jov.init_overlay_state(jcfg), jmesh), jsched)
    sched = pov.make_overlay_schedule(cfg)
    state = pov.init_overlay_state(cfg, "cpu")
    lfinal, lmet = pov.make_overlay_run(cfg, mega=False, grid=False)(
        state, sched)
    mesh = make_overlay_mesh(p, device="cpu")
    final, met = make_sharded_overlay_run(cfg, mesh)(
        shard_overlay_state(state, mesh), sched)
    for f in STATE_FIELDS:
        a = getattr(final, f).numpy()
        assert np.array_equal(a, np.asarray(getattr(jfinal, f))), f
        assert np.array_equal(a, getattr(lfinal, f).numpy()), f
    assert final.tick == int(jfinal.tick) == cfg.total_ticks
    for f in dataclasses.fields(jmet):
        a = getattr(met, f.name).numpy()
        assert np.array_equal(a, np.asarray(getattr(jmet, f.name))), f.name
        assert np.array_equal(a, getattr(lmet, f.name).numpy()), f.name


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("scenario", ["plain", "drop", "churn"])
def test_sharded_overlay_bit_parity(scenario, p):
    _check(p, scenario, use_pallas=False)


@pytest.mark.parametrize("p", [2, 8])
def test_sharded_overlay_kernel_contract_parity(p):
    """The JAX run with its Pallas kernel in interpret mode (the comm
    routes the shard bits, the kernel the local ones) == the port's."""
    _check(p, "kernel", use_pallas=True)


def test_plain_k3_sharded_contract_equals_jax_kernel():
    """On the inputs a 4-shard run hands each shard (P=4, N=64, Nl=16),
    the plain K3 with the sharded arguments equals the JAX kernel in
    interpret mode: every output, at every tick and shard."""
    cfg = SimConfig(**dict(_kw("drop"), total_ticks=40), overlay_view=16)
    seen = []

    def both(idsaux, pw, intro, masks, scalars, **kk):
        got = fused_overlay_tick_plain(idsaux, pw, intro, masks, scalars,
                                       **kk)
        want = jax_fused_overlay_tick(
            jnp.asarray(idsaux.numpy()), jnp.asarray(pw.numpy()),
            jnp.asarray(intro.numpy()), jnp.asarray(masks, jnp.int32),
            jnp.asarray(scalars, jnp.int32), k=kk["k"],
            t_remove=kk["t_remove"], churn_lo=kk["churn_lo"],
            churn_span=kk["churn_span"],
            masks_local=jnp.asarray(kk["masks_local"], jnp.int32),
            row_start=jnp.int32(kk["row_start"]),
            aux_rounds=jnp.stack([jnp.asarray(a.numpy())
                                  for a in kk["aux_rounds"]]),
            pw_rounds=jnp.stack([jnp.asarray(a.numpy())
                                 for a in kk["pw_rounds"]]))
        for field, a, b in zip(("ids", "hb", "ts", "counters"), got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), \
                (scalars[0], kk["row_start"], field)
        seen.append((kk["row_start"], int(got[3][:, 0].sum())))
        return got

    sched = pov.make_overlay_schedule(cfg)
    mesh = make_overlay_mesh(4, device="cpu")
    make_sharded_overlay_run(cfg, mesh, exchange=both)(
        shard_overlay_state(pov.init_overlay_state(cfg, "cpu"), mesh), sched)
    assert {r for r, _ in seen} == {0, 16, 32, 48}
    assert len(seen) == 4 * 40 and sum(c for _, c in seen) > 0


def test_sharded_rejects_non_power_of_two_mesh():
    with pytest.raises(AssertionError, match="power of two"):
        RingOverlayComm("peers", 3)
    with pytest.raises(AssertionError, match="power of two"):
        jos.RingOverlayComm("peers", 3)
    cfg = SimConfig(**_kw("plain"))
    with pytest.raises(AssertionError, match="power of two"):
        make_sharded_overlay_run(cfg, make_overlay_mesh(3, device="cpu"))


def test_sharded_rejects_world_configs():
    cfg = SimConfig(**_kw("plain"), zombie=True)
    with pytest.raises(ValueError, match="peer-sharded"):
        make_sharded_overlay_run(cfg, make_overlay_mesh(2, device="cpu"))

"""Hold a run of the port against the independent engines: the scalar
oracles (``oracle.py``, ``overlay_oracle.py``) and the native C++ engine
(``compat/native.py``).  Neither is the JAX package nor this package's
tick, so a fault both packages share would still show here.

The rules are the JAX package's own tests' (``tests/test_parity.py``,
``test_churn.py``, ``test_worlds.py`` for the dense oracle,
``test_overlay.py`` for the overlay oracle, ``test_native.py`` for the
native engine): the message-level dense oracle meets the tick exactly
on event sets, membership and loss-free accounting, and within the
documented canonical-order transient (a heartbeat off by one or two, a
lossy removal a tick or two apart) elsewhere; the overlay oracle and
the native engine meet it bit for bit.  Each check raises
``AssertionError`` naming what diverged, and returns a summary dict.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from .. import worlds
from ..config import SimConfig
from ..state import NEVER, make_schedule_host
from .dropsync import make_drop_masks
from .oracle import ReferenceOracle
from .overlay_oracle import OverlayOracle


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def dense_oracle(cfg: SimConfig, res) -> ReferenceOracle:
    """The message-level oracle run over ``res``'s schedule, on the same
    drop decisions (dropsync) and worlds."""
    inject = cfg.drop_msg or cfg.partition_groups >= 2
    drops = make_drop_masks(cfg, make_schedule_host(cfg)) if inject \
        else (None, None, None)
    flap = worlds.make_flap_state(cfg) if cfg.flap_rate > 0 else None
    return ReferenceOracle(cfg, res.start_tick, res.fail_tick, *drops,
                           rejoin_tick=res.rejoin_tick,
                           flap_state=flap).run()


def check_dense_oracle(res) -> dict:
    """A trace-mode :class:`~..core.sim.SimResult` against the dense
    oracle."""
    cfg = res.cfg
    o = dense_oracle(cfg, res)
    gv = res.grader_view()
    joins = {(i, j) for (_, i, j) in o.events.added}
    assert joins == gv["joins"], "oracle joins differ"
    removals = {}
    for (t, i, j) in o.events.removed:
        removals.setdefault((i, j), t)
    lossy = cfg.drop_msg or cfg.partition_groups >= 2
    if lossy:
        assert set(removals) == set(gv["removal_ticks"]), \
            "oracle removal set differs"
        for k, t_o in removals.items():
            assert abs(t_o - gv["removal_ticks"][k]) <= 2, \
                f"removal of {k} at {gv['removal_ticks'][k]}, oracle {t_o}"
    else:
        assert removals == gv["removal_ticks"], "oracle removal ticks differ"
        assert np.array_equal(o.sent, res.sent), "sent counters differ"
        assert np.array_equal(o.recv, res.recv), "recv counters differ"
    if cfg.rejoin_after is not None:
        tick_adds = {(int(t), int(i), int(j))
                     for t, i, j in zip(*np.nonzero(res.added))}
        assert {tuple(a) for a in o.events.added} == tick_adds, \
            "oracle join ticks differ"
    km = o.known_matrix()
    fs = res.final_state
    assert np.array_equal(km, _np(fs.known)), "final membership differs"
    if not cfg.has_worlds and cfg.rejoin_after is None:
        ts_diff = o.table("ts") - _np(fs.ts) * km
        hb_diff = o.table("hb") - _np(fs.hb) * km
        if cfg.drop_msg:
            frozen = (np.asarray(res.fail_tick) <= cfg.total_ticks)[:, None]
            assert not (ts_diff * ~frozen).any(), "live ts rows differ"
            assert np.abs(ts_diff).max() <= 1, "ts off by more than 1"
            assert np.abs(o.sent - res.sent).sum() <= 6, "sent drifts"
            assert np.abs(o.recv - res.recv).sum() <= 6, "recv drifts"
        else:
            assert not ts_diff.any(), "ts tables differ"
        assert np.abs(hb_diff).max() <= (2 if cfg.drop_msg else 1), \
            "heartbeats beyond the join transient"
    return {"joins": len(joins), "removals": len(removals),
            "lossy": bool(lossy)}


def check_overlay_oracle(res) -> dict:
    """An :class:`~..models.overlay.OverlayResult` from tick 0 against
    the overlay oracle: the final tables and flags bit for bit, and the
    per-tick sent / recv / removals series."""
    cfg = res.cfg
    o = OverlayOracle(cfg)
    m = res.metrics
    for t in range(res.ticks_run):
        c = o.step()
        for name in ("sent", "recv", "removals"):
            got = int(np.asarray(getattr(m, name))[t])
            assert got == c[name], f"tick {t}: {name} {got}, oracle {c[name]}"
    fs = res.final_state
    for name in ("ids", "hb", "ts", "send_flags", "in_group", "own_hb",
                 "joinreq", "joinrep"):
        assert np.array_equal(_np(getattr(fs, name)), getattr(o, name)), \
            f"final {name} differs"
    return {"ticks": res.ticks_run,
            "removals": int(np.asarray(m.removals).sum())}


_NATIVE_EVENT = re.compile(r" (\d+)\.0\.0\.0:0 \[(\d+)\] Node (\d+)\.0\.0\.0:0 "
                           r"(joined|removed)")


def parse_native_events(dbg_path: str):
    """dbg.log -> ({(observer, subject, tick)} joins, {...} removals)."""
    adds, rems = set(), set()
    with open(dbg_path) as f:
        for ln in f.read().splitlines():
            m = _NATIVE_EVENT.match(ln)
            if m:
                obs, t, subj = (int(m.group(1)) - 1, int(m.group(2)),
                                int(m.group(3)) - 1)
                (adds if m.group(4) == "joined" else rems).add((obs, subj, t))
    return adds, rems


def native_events(cfg: SimConfig, fail, rejoin=None):
    """The native engine's join / removal events of a loss-free config
    with a pinned failure (and rejoin) schedule."""
    from ..compat import native
    with tempfile.TemporaryDirectory() as d:
        if rejoin is None:
            rc = native.run_scenario(cfg.n, cfg.single_failure, False, 0.0,
                                     cfg.total_ticks, seed=cfg.seed,
                                     fail_ticks=fail, outdir=d)
        else:
            rc = native.run_scenario_churn(
                cfg.n, cfg.single_failure, False, 0.0, cfg.total_ticks,
                seed=cfg.seed, fail_ticks=fail, rejoin_ticks=rejoin,
                outdir=d)
        if rc != 0:
            raise RuntimeError(f"native engine returned {rc}")
        return parse_native_events(os.path.join(d, "dbg.log"))


def port_events(cfg: SimConfig, fail, rejoin=None, device=None):
    """The port's join / removal events of ``cfg`` with the failure (and
    rejoin) ticks pinned, on ``device``."""
    from ..core.tick import make_run
    from ..state import init_state, make_schedule
    sched = make_schedule(cfg, device)
    dev = sched.start_tick.device
    sched = sched.replace(fail_tick=torch.as_tensor(
        np.asarray(fail, np.int32), device=dev))
    if rejoin is not None:
        sched = sched.replace(rejoin_tick=torch.as_tensor(
            np.asarray(rejoin, np.int32), device=dev))
    _, ev = make_run(cfg, with_events=True)(init_state(cfg, device), sched)
    added, removed = ev.added.cpu().numpy(), ev.removed.cpu().numpy()
    return ({(int(i), int(j), int(t)) for t, i, j in zip(*np.nonzero(added))},
            {(int(i), int(j), int(t))
             for t, i, j in zip(*np.nonzero(removed))})


#: the native engine's event-parity cases (JAX tests/test_native.py):
#: (name, config keywords, failed peers, fail tick, rejoin_after)
NATIVE_CASES = (
    ("single_n10", dict(max_nnb=10, single_failure=True, total_ticks=200),
     (6,), 100, None),
    ("multi_n10", dict(max_nnb=10, single_failure=False, total_ticks=200),
     tuple(range(2, 7)), 100, None),
    ("start_after_fail_n24", dict(max_nnb=24, single_failure=False,
                                  total_ticks=80), tuple(range(16, 24)), 3,
     None),
    ("churn_rejoin10", dict(max_nnb=16, single_failure=True, seed=2,
                            total_ticks=160, fail_tick=30, rejoin_after=10),
     (5,), 30, 10),
    ("churn_rejoin25", dict(max_nnb=16, single_failure=True, seed=2,
                            total_ticks=160, fail_tick=30, rejoin_after=25),
     (5,), 30, 25),
)


def check_native_case(case, device=None) -> dict:
    """One :data:`NATIVE_CASES` entry: the native engine's event sets
    equal the port's on ``device``."""
    name, kw, victims, fail_t, rejoin_after = case
    cfg = SimConfig(drop_msg=False, **{"seed": 0, **kw})
    n = cfg.n
    fail = np.full(n, NEVER, np.int32)
    fail[list(victims)] = fail_t
    rejoin = None
    if rejoin_after is not None:
        rejoin = np.full(n, NEVER, np.int32)
        rejoin[list(victims)] = fail_t + rejoin_after
    want = native_events(cfg, fail, rejoin)
    got = port_events(cfg, fail, rejoin, device)
    assert got[0] == want[0], f"{name}: join events differ from native"
    assert got[1] == want[1], f"{name}: removal events differ from native"
    return {"joins": len(want[0]), "removals": len(want[1])}

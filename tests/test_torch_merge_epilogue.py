"""The K1 tick's merge and epilogue as one op (``ops/merge.py
merge_epilogue``), on the CPU.

The tick body (``core/tick.py _make_body``) takes the fused op where the
merge builds a witness ladder (``uses_ladder``: N > 1024) on the K1
route, and the ``masked_max3`` / ``tick_epilogue`` pair at N <= 1024, on
the sharded route and on the composable route.  On the CPU the fused op
is the two plain versions in turn, so a run through it equals the run
through the pair bit for bit; its kernel is held to both on the card
(tests/test_torch_cuda.py).
"""

import pytest
import torch

from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.core import tick as tick_mod
from gossip_protocol_tpu_torch.ops import merge
from gossip_protocol_tpu_torch.state import init_state, make_schedule

torch.set_num_threads(2)


class _Reached(Exception):
    """Raised by a spied phase: the tick got there."""


def _spy(monkeypatch, names):
    """Replace each of ``names`` in core/tick.py by a spy that records its
    call and stops the tick; returns the list of the calls' names."""
    calls = []

    def make(name):
        def spy(*a, **k):
            calls.append(name)
            raise _Reached(name)
        return spy

    for name in names:
        monkeypatch.setattr(tick_mod, name, make(name))
    return calls


class _RingLike:
    """Just enough of a peer-sharded comm to route a tick as sharded."""
    n_shards = 4

    @staticmethod
    def rows_of(x):
        return x


PHASES = ("merge_epilogue", "masked_max3", "tick_epilogue",
          "_composable_phases")


@pytest.mark.parametrize("n,world,comm,want", [
    (1100, {}, None, "merge_epilogue"),
    (1025, {}, None, "merge_epilogue"),
    (1024, {}, None, "masked_max3"),
    (64, {}, None, "masked_max3"),
    (1100, {}, _RingLike(), "_composable_phases"),
    (1100, {"zombie": True}, None, "_composable_phases"),
    (1100, {"link_latency": 2}, None, "_composable_phases"),
])
def test_tick_body_routes_the_merge_by_shape(monkeypatch, n, world, comm,
                                             want):
    """The solo tick reaches the fused op only on the K1 route at a shape
    whose merge builds a witness ladder (N > 1024); the pair at N <=
    1024; the sharded and composable routes their own phases."""
    cfg = SimConfig(max_nnb=n, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, **world)
    assert merge.uses_ladder(n, n) == (n > 1024)
    calls = _spy(monkeypatch, PHASES)
    tick = tick_mod.make_tick(cfg, with_events=False, comm=comm)
    with pytest.raises(_Reached):
        tick(init_state(cfg, "cpu"), make_schedule(cfg, "cpu"))
    assert calls == [want]


@pytest.mark.parametrize("n,want", [(1100, "merge_epilogue"),
                                    (1024, "masked_max3")])
def test_fleet_tick_body_routes_the_merge_by_shape(monkeypatch, n, want):
    """The fleet tick shares the solo tick's body: the fused op over the
    lane axis where the merge builds a witness ladder."""
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    cfg = SimConfig(max_nnb=n, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, total_ticks=4)
    calls = _spy(monkeypatch, PHASES)
    with pytest.raises(_Reached):
        FleetSimulation(cfg, device="cpu").run(seeds=[1, 2])
    assert calls == [want]


def _merge_once(monkeypatch):
    """Route both ticks' ``masked_max3`` through one memo: a call whose
    arguments all equal the last call's returns copies of its maxima (the
    plain merge is a pure function, and at N=1100 the costliest step of a
    CPU tick).  Returns the list of the calls' kinds, "merge" or "same"."""
    real, last, calls = merge.masked_max3, {}, []

    def same(x, y):
        if torch.is_tensor(x) or torch.is_tensor(y):
            return (torch.is_tensor(x) and torch.is_tensor(y)
                    and x.shape == y.shape and torch.equal(x, y))
        return x == y

    def memo(*a, **k):
        k = {key: v for key, v in k.items() if v is not None}  # counts
        hit = last.get("args")
        if (hit is not None and len(hit[0]) == len(a) and hit[1] == k
                and all(same(x, y) for x, y in zip(hit[0], a))):
            calls.append("same")
            return tuple(m.clone() for m in last["out"])
        calls.append("merge")
        last["out"] = real(*a, **k)
        last["args"] = (a, k)
        return tuple(m.clone() for m in last["out"])

    monkeypatch.setattr(merge, "masked_max3", memo)
    monkeypatch.setattr(tick_mod, "masked_max3", memo)
    return calls


def test_fused_op_equals_the_pair_over_dense_drop_ticks(monkeypatch):
    """The first ticks of the N=1100 10% drop run (joins, JOINREQ /
    JOINREP, the first gossip): the tick through the fused op equals the
    tick through the pair, tick by tick (states, event masks, and the
    sent / recv rows the op adds onto the vector step's), and both merge
    the same inputs."""
    cfg = SimConfig(max_nnb=1100, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0)
    sched = make_schedule(cfg, "cpu")
    fused = tick_mod.make_tick(cfg, with_events=True)
    monkeypatch.setattr(tick_mod, "uses_ladder", lambda r, s: False)
    pair = tick_mod.make_tick(cfg, with_events=True)
    monkeypatch.undo()
    calls = []
    real = merge.merge_epilogue

    def counted(*a, **k):
        calls.append(a[10])
        return real(*a, **k)

    monkeypatch.setattr(tick_mod, "merge_epilogue", counted)
    merges = _merge_once(monkeypatch)
    ticks = 4
    a = b = init_state(cfg, "cpu")
    for t in range(ticks):
        a, ea = fused(a, sched)
        b, eb = pair(b, sched)
        for f in ("known", "hb", "ts", "gossip", "in_group", "own_hb",
                  "joinreq", "joinrep"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (t, f)
        for f in ("added", "removed", "sent", "recv"):
            assert torch.equal(getattr(ea, f), getattr(eb, f)), (t, f)
    assert calls == list(range(ticks))
    assert merges == ["merge", "same"] * ticks
    assert int(a.known.sum()) > 0 and bool(a.gossip.any())
    assert bool(ea.added.any())

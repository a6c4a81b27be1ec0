"""The port's gossip merge maxima equal the JAX package's.

``gossip_protocol_tpu_torch.ops.merge`` keeps the FILL=-1 / +1-shift
contract of ``gossip_reductions`` (blockwise product-max) and
``gossip_reductions_mxu`` (level descent); on the CPU the
``masked_max3`` wrapper runs its plain version, and
``masked_max3_descent`` mirrors the CUDA kernel's descent on the witness
ladder (the kernel itself runs only on the card:
tests/test_torch_cuda.py).  Exact equality.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops import merge as jax_merge
from gossip_protocol_tpu_torch.ops import merge
from test_torch_merge_cases import (CASES, LADDER_CASES, NOW, T_REMOVE,
                                    merge_case)

torch.set_num_threads(2)


def _inputs(n, seed, p_recv):
    rng = np.random.default_rng(seed)
    return dict(
        recv_from=rng.random((n, n)) < p_recv,
        known=rng.random((n, n)) < 0.7,
        hb=rng.integers(0, 400, (n, n), dtype=np.int32),
        # spans both sides of the freshness gate now - ts < t_remove
        ts=rng.integers(NOW - 2 * T_REMOVE, NOW + 1, (n, n), dtype=np.int32))


@pytest.mark.parametrize("n", (10, 64, 100))
@pytest.mark.parametrize("p_recv", (0.0, 0.05, 0.6, 1.0) + CASES
                         + LADDER_CASES)
def test_gossip_reductions_match(n, p_recv):
    """The port's merge (the plain version, as the CPU wrapper runs it)
    and the plain mirror of the kernel's level descent equal both JAX
    merges; the descent runs no product without a delivery and at least
    the pre-resolve where there is one (a few row tiles: no ladder)."""
    gossip, proc, known, hb, ts = merge_case(p_recv, n, seed=n)
    recv_from = (gossip & proc[None, :]).T
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (gossip, proc, known, hb, ts)]
    m = merge.masked_max3(*t, NOW, t_remove=T_REMOVE)
    desc = merge.masked_max3_descent(*t, NOW, t_remove=T_REMOVE)
    assert not desc.ladder
    m_d, levels = desc.maxima, desc.products
    args = (recv_from, known, hb, ts, np.int32(NOW))
    for ref in (jax_merge.gossip_reductions(*args, t_remove=T_REMOVE,
                                            block_size=32),
                jax_merge.gossip_reductions_mxu(*args, t_remove=T_REMOVE)):
        for got in (m, m_d):
            for a, b in zip((*got, got[2] >= 0), ref):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype and np.array_equal(
                    a.numpy(), b)
    for lv in levels.values():
        assert lv.shape == (-(-n // merge.TILE_ROWS),
                            -(-n // merge.TILE_COLS))
        assert (lv == 0).all() if not recv_from.any() else (lv >= 1).any()


def test_masked_max3_reads_delivery_sender_major():
    """``masked_max3(gossip, proc, ...)`` is the merge of the delivery
    ``recv_from = (gossip & proc[None, :]).T`` with no transposed copy."""
    n = 48
    rng = np.random.default_rng(1)
    x = _inputs(n, seed=2, p_recv=0.5)
    gossip = rng.random((n, n)) < 0.5
    proc = rng.random(n) < 0.8
    want = jax_merge.gossip_reductions(
        (gossip & proc[None, :]).T, x["known"], x["hb"], x["ts"],
        np.int32(NOW), t_remove=T_REMOVE)
    before = merge.masked_max3.launches
    got = merge.masked_max3(
        torch.from_numpy(gossip), torch.from_numpy(proc),
        torch.from_numpy(x["known"]), torch.from_numpy(x["hb"]),
        torch.from_numpy(x["ts"]), NOW, t_remove=T_REMOVE)
    assert merge.masked_max3.launches == before   # CPU: plain version
    for a, b in zip(got, want[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _ladder_input(case, r, s, c, seed):
    """A merge case on an S x R delivery block against S x C payload rows
    (the square case's planes cut or tiled to shape)."""
    n = max(r, s, c)
    gossip, proc, known, hb, ts = merge_case(case, n, seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        gossip[:s, :r], proc[:r], known[:s, :c], hb[:s, :c], ts[:s, :c]))


#: (case, S, R, C, what the ladder's fallback does): "none" (the rungs
#: and level 0 close every cell), "all" (every tile with a delivering
#: row falls back in planes a and f), "most" (most tiles do), "cols"
#: (exactly the column tiles holding the case's distinct columns do)
LADDER_SHAPES = [
    ("ladder", 300, 300, 300, "none"),
    ("top_ties", 600, 600, 600, "none"),
    ("ladder_dead_cols", 300, 300, 300, "none"),
    ("distinct", 300, 300, 300, "all"),
    ("mixed_fallback", 600, 600, 600, "cols"),
    ("ladder", 300, 260, 700, "none"),
    ("mixed_fallback", 257, 520, 333, "cols"),
    ("spread", 300, 300, 300, "most"),
]


@pytest.mark.parametrize("case,s,r,c,fallback", LADDER_SHAPES)
def test_ladder_descent_equals_plain(case, s, r, c, fallback):
    """The witness ladder (built here at a size below the kernel's rule),
    its maxima equal to the plain merge's where the two rungs suffice and
    where some or every column overflows them, on square and rectangular
    blocks.  A column no sender knows is FILL; a tile whose cells the
    ladder closes runs no fallback, and one that falls back closes its
    cells there; ties at the top rung cost no fallback."""
    x = _ladder_input(case, r, s, c, seed=r + c)
    want = merge.masked_max3_plain(*x, NOW, t_remove=T_REMOVE)
    got = merge.masked_max3_descent(*x, NOW, t_remove=T_REMOVE,
                                    ladder=True)
    assert got.ladder
    for a, b in zip(got.maxima, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fb = got.fallback
    if fallback == "none":
        assert not any(v.any() for v in fb.values())
        assert all(v == 0 for v in got.fallback_cells.values())
    elif fallback in ("all", "most"):
        for name in "af":
            assert fb[name].all() if fallback == "all" \
                else fb[name].float().mean() > 0.5
            assert got.fallback_cells[name] > 0
    else:
        cols = (torch.arange(c) % 37 == 5).view(-1)
        tiles = torch.zeros(-(-c // merge.TILE_COLS), dtype=torch.bool)
        tiles[torch.arange(c)[cols] // merge.TILE_COLS] = True
        for name in "af":
            assert fb[name].any() and not fb[name][:, ~tiles].any()
    if case == "ladder_dead_cols":
        dead = ~x[2].any(0)
        assert dead.any() and (want[0][:, dead] == merge.FILL).all()
    # each product multiplies at least one word, and a tile runs none
    # beyond its rungs and level 0 unless it fell back
    for name in "aft":
        p, w = got.products[name], got.words[name]
        assert ((w >= p) & ((p <= merge.LADDER + 1) | fb[name])).all()


def test_ladder_descent_lanes_of_differing_depth():
    """A fleet's lanes, each its own ladder: one lane the rungs close, one
    that overflows them everywhere and one silent lane; the mirror lane
    by lane equals the lane-axis plain merge, and only the overflowing
    lane falls back."""
    cases = ("ladder", "spread", 0.0)
    lanes = [_ladder_input(case, 300, 300, 300, seed=7) for case in cases]
    x = tuple(torch.stack(parts) for parts in zip(*lanes))
    want = merge.masked_max3_lanes_plain(*x, NOW, t_remove=T_REMOVE)
    for i, case in enumerate(cases):
        got = merge.masked_max3_descent(*(a[i] for a in x), NOW,
                                        t_remove=T_REMOVE, ladder=True)
        assert all(torch.equal(a, b[i]) for a, b in zip(got.maxima, want))
        falls = sum(int(v.sum()) for v in got.fallback.values())
        assert (falls > 0) == (case == "spread")
        if case == 0.0:
            assert all(int(v.sum()) == 0 for v in got.products.values())


@pytest.mark.parametrize("r,s,ladder", [
    (300, 300, False), (1024, 4096, False), (1025, 64, True),
    (2816, 2816, True), (4096, 32 * 1228, True), (4096, 32 * 1229, False)])
def test_ladder_rule(r, s, ladder):
    """The kernel builds the ladder for more than four row tiles whose
    sender words fit its word lists; the mirror follows the same rule."""
    assert merge.uses_ladder(r, s) is ladder


def test_witness_ladder_rungs():
    """The rungs are each column's largest distinct positive values in
    descending order, 0 past the last."""
    v = torch.tensor([[5, 0, 3, -1], [5, 0, 7, 2], [4, 0, 3, 2],
                      [1, 0, 7, 9]], dtype=torch.int32)
    got = merge.witness_ladder(v, 3)
    assert got.tolist() == [[5, 0, 7, 9], [4, 0, 3, 2], [1, 0, 0, 0]]


def test_merge_counts_reach_spans_once(monkeypatch):
    """A bench fleet hands the merge a counter only while spans record,
    and its fetch adds what the merges counted, over every lane and tick,
    to ``merge.tiles`` / ``merge.fallback_tiles`` once; the lanes'
    results are the same with spans on and off.  The merge stands in for
    the kernel: three plane descents a lane a tick, one fell back."""
    from gossip_protocol_tpu_torch.config import SimConfig
    from gossip_protocol_tpu_torch.core import tick as tick_mod
    from gossip_protocol_tpu_torch.core.fleet import FleetSimulation
    from gossip_protocol_tpu_torch.utils import spans
    real, seen = tick_mod.masked_max3, []

    def counting(*args, counts=None, **kw):
        seen.append(counts)
        if counts is not None:
            counts += torch.tensor([3, 1])
        return real(*args, **kw)

    monkeypatch.setattr(tick_mod, "masked_max3", counting)
    cfg = SimConfig(max_nnb=16, single_failure=False, drop_msg=True,
                    msg_drop_prob=0.1, seed=0, total_ticks=12)
    sim = FleetSimulation(cfg, device="cpu")
    spans.clear()
    off = sim.run_bench(seeds=[1, 2, 3], warmup=False)
    assert len(seen) == 12 and all(c is None for c in seen)
    assert spans.snapshot()["counters"] == {}
    seen.clear()
    with spans.enable():
        on = sim.run_bench(seeds=[1, 2, 3], warmup=False)
        got = spans.snapshot()["counters"]
    spans.clear()
    assert len(seen) == 12 and all(c is seen[0] for c in seen)
    assert tuple(seen[0].shape) == (3, 2)
    assert got["merge.tiles"] == 3 * 3 * 12
    assert got["merge.fallback_tiles"] == 3 * 12
    for a, b in zip(off.lanes, on.lanes):
        assert np.array_equal(a.sent, b.sent)
        assert np.array_equal(a.recv, b.recv)

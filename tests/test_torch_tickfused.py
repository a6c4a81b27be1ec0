"""K1: the plain ``tick_epilogue`` equals the TPU kernel
``fused_tick_update`` run in Pallas interpret mode.

Inputs are random but valid: the merge maxima come from the JAX merge
of the same delivery (``recv_from = (gossip & proc).T``), the tables
straddle the TREMOVE horizon, and every row/column vector is mixed.
Exact equality on every output, events on and off.
"""

import numpy as np
import pytest
import torch

from gossip_protocol_tpu.ops.merge import gossip_reductions
from gossip_protocol_tpu.ops.pallas.tickfused import fused_tick_update
from gossip_protocol_tpu_torch.ops.cuda.tickfused import tick_epilogue

torch.set_num_threads(2)

T = 300
T_REMOVE = 20


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    b = lambda p, shape: rng.random(shape) < p          # noqa: E731
    x = dict(gossip=b(0.6, (n, n)), proc=b(0.9, n), known=b(0.7, (n, n)),
             hb=rng.integers(0, 400, (n, n), dtype=np.int32),
             ts=rng.integers(T - 2 * T_REMOVE, T + 1, (n, n),
                             dtype=np.int32),
             gdrop=b(0.1, (n, n)), ops=b(0.85, n), jrep=b(0.2, n),
             jreq=b(0.2, n), live_hold=b(0.1, n))
    # exercise the row-0 / column-0 rules on cells that are still empty
    x["known"][0, : n // 2] = False
    x["known"][: n // 2, 0] = False
    x["recv_from"] = (x["gossip"] & x["proc"][None, :]).T
    m = gossip_reductions(x["recv_from"], x["known"], x["hb"], x["ts"],
                          np.int32(T), t_remove=T_REMOVE)
    x["m_all"], x["m_fresh"], x["t_fresh"] = (np.asarray(v) for v in m[:3])
    return x


@pytest.mark.parametrize("n", (64, 128))
@pytest.mark.parametrize("with_events", (True, False))
def test_tick_epilogue_plain_equals_pallas_interpret(n, with_events):
    x = _inputs(n, seed=n + with_events)
    want = fused_tick_update(
        x["m_all"], x["m_fresh"], x["t_fresh"], x["recv_from"], x["known"],
        x["hb"], x["ts"], x["gossip"], x["gdrop"], x["ops"], x["jrep"],
        x["jreq"], x["live_hold"], np.int32(T), t_remove=T_REMOVE,
        tile_r=64, with_events=with_events, interpret=True)
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    before = tick_epilogue.launches
    seeds = (torch.arange(n, dtype=torch.int32),
             torch.arange(n, 0, -1, dtype=torch.int32))
    got = tick_epilogue(
        t["m_all"], t["m_fresh"], t["t_fresh"], t["gossip"], t["proc"],
        t["known"], t["hb"], t["ts"], t["gdrop"], t["ops"], t["jrep"],
        t["jreq"], t["live_hold"], T, rows=seeds, t_remove=T_REMOVE,
        with_events=with_events)
    assert tick_epilogue.launches == before      # CPU: plain version
    known, hb, ts, gossip, sent, recv, added, removed = got
    # the gossip counts are added onto the rows passed in
    sent, recv = sent - seeds[0], recv - seeds[1]
    w_known, w_hb, w_ts, w_gossip, w_sent, w_added, w_removed = want
    for a, b in ((known, w_known), (hb, w_hb), (ts, w_ts),
                 (gossip, w_gossip), (sent, w_sent)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    assert np.array_equal(recv.numpy(), x["recv_from"].sum(1))
    if with_events:
        assert np.array_equal(added.numpy(), np.asarray(w_added))
        assert np.array_equal(removed.numpy(), np.asarray(w_removed))
        assert added.any() and removed.any()
    else:
        assert added is None and removed is None

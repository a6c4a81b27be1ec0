"""Gossip merge reductions (counterpart of ``gossip_protocol_tpu/ops/merge.py``).

The whole receive-and-merge phase of one tick is three masked maxima
over the sender axis:

    M[r, j] = max over s of  payload[s, j]  where  recv_from[r, s]

with the payloads shifted up by one (``a1 = known ? hb + 1 : 0``, and
the fresh-only ``f1``/``t1``), so that "no contributing sender" is 0
before and ``FILL = -1`` after shifting back down.  That contract is
the JAX package's ``gossip_reductions``.

:func:`masked_max3` is the tick's entry: it reads the delivery mask as
``gossip[s, r] & proc[r]`` (sender-major, as the state holds it), so no
transposed copy is made.  On a CUDA tensor it launches the
``masked_max3`` kernels (csrc/dense_tick.cu): the TPU's level descent
(``gossip_reductions_mxu`` / ``_masked_max_mxu``) on the int8 tensor
cores, one tile-local descent per block, as
:func:`masked_max3_descent` runs it; on a CPU tensor it runs
:func:`masked_max3_plain`.  All are exact, so they agree bit for bit.
"""

from __future__ import annotations

import torch

FILL = -1

#: element budget of one product-max block in the plain version
_PLAIN_BLOCK_ELEMS = 1 << 24


def merge_payloads(known, hb, ts, now: int, t_remove: int):
    """Shift-encoded payload planes ``(a1, f1, t1)``, i32[S, J]."""
    k = known.to(torch.int32)
    fresh = k * (now - ts < t_remove)
    return k * (hb + 1), fresh * (hb + 1), fresh * (ts + 1)


def masked_max3_plain(gossip, proc, known, hb, ts, now: int, *,
                      t_remove: int):
    """Plain PyTorch version of the ``masked_max3`` kernel: a blockwise
    product-max over the sender axis.  ``gossip`` bool[S, R] is the
    delivery block (sender, receiver), ``proc`` bool[R], ``known`` /
    ``hb`` / ``ts`` [S, C] the senders' payload rows.  Returns ``(m_all,
    m_fresh, t_fresh)`` i32[R, C] (FILL where no sender contributes)."""
    s_dim, r_dim = gossip.shape
    c_dim = known.shape[1]
    recv_from = (gossip & proc[None, :]).t()           # [r, s]
    a1, f1, t1 = merge_payloads(known, hb, ts, now, t_remove)
    b = max(1, min(s_dim, _PLAIN_BLOCK_ELEMS // max(1, r_dim * c_dim)))
    m = [torch.zeros((r_dim, c_dim), dtype=torch.int32, device=known.device)
         for _ in range(3)]
    zero = torch.zeros((), dtype=torch.int32, device=known.device)
    for s0 in range(0, s_dim, b):
        d = recv_from[:, s0:s0 + b, None]                # [R, B, 1]
        for acc, v in zip(m, (a1, f1, t1)):
            blk = torch.where(d, v[None, s0:s0 + b, :], zero).amax(1)
            torch.maximum(acc, blk, out=acc)
    return m[0] - 1, m[1] - 1, m[2] - 1


#: output tile of the ``masked_max3`` kernel (csrc/dense_tick.cu MM_ROWS,
#: MM_COLS): a block runs the whole descent of one tile
TILE_ROWS = 256
TILE_COLS = 64
#: senders per delivery word (one bit each; csrc/dense_tick.cu WORD)
WORD = 32


def masked_max3_descent(gossip, proc, known, hb, ts, now: int, *,
                        t_remove: int):
    """Plain mirror of the ``masked_max3`` kernel's algorithm, the JAX
    package's level descent (``_masked_max_mxu``) as the kernel runs it.

    Per row tile of ``TILE_ROWS`` receivers only the 32-sender words
    with a delivery to one of its rows take part (the tile's live
    words).  Per plane and column, the levels are the distinct positive
    values of those senders in descending order.  Level 0 is the
    pre-resolve product ``d @ (v > 0)``: cells it does not hit are FILL.
    Level k > 0 is the witness product ``d @ (v == cur)``: the cells it
    hits first take ``cur``.  A ``TILE_ROWS x TILE_COLS`` tile stops
    after the first level that leaves none of its cells open.

    Returns ``((m_all, m_fresh, t_fresh), levels)``: the same maxima as
    :func:`masked_max3_plain`, and per plane (``"a"``, ``"f"``, ``"t"``)
    the products each tile ran, i64[row tiles, column tiles] (0 for a
    tile without live words).  Used by the tests and ``chip_smoke.py``.
    """
    n = known.shape[0]
    dev = known.device
    d = (gossip & proc[None, :]).t()                       # [r, s]
    w = -(-n // WORD)
    dpad = torch.zeros((n, w * WORD), dtype=torch.bool, device=dev)
    dpad[:, :n] = d
    live_word = dpad.view(n, w, WORD).any(2)               # [r, W]
    rt, ct = -(-n // TILE_ROWS), -(-n // TILE_COLS)
    col_tile = torch.arange(n, device=dev) // TILE_COLS
    outs, levels = [], {}
    for name, v in zip("aft", merge_payloads(known, hb, ts, now, t_remove)):
        m = torch.full((n, n), FILL, dtype=torch.int32, device=dev)
        lv = torch.zeros((rt, ct), dtype=torch.int64, device=dev)
        for i in range(rt):
            rows = slice(i * TILE_ROWS, min(n, (i + 1) * TILE_ROWS))
            live = live_word[rows].any(0).repeat_interleave(WORD)[:n]
            if not live.any():
                continue
            dd = d[rows].to(torch.float32)
            vl = v * live[:, None]
            # level 0: the pre-resolve product (exact: counts <= N < 2^24)
            done = (dd @ (vl > 0).to(torch.float32)) == 0
            lv[i] += 1
            cur = vl.amax(0)
            open_ = ~done
            while open_.any():
                tiles = torch.zeros(ct, dtype=torch.bool, device=dev)
                tiles[col_tile[open_.any(0)]] = True
                lv[i] += tiles
                hit = (dd @ ((vl == cur) & (cur > 0)).to(torch.float32)) > 0
                newly = hit & open_
                m[rows] = torch.where(newly, cur - 1, m[rows])
                open_ &= ~newly
                cur = torch.where(vl < cur, vl, 0).amax(0)
        outs.append(m)
        levels[name] = lv
    return tuple(outs), levels


def masked_max3_lanes_plain(gossip, proc, known, hb, ts, now: int, *,
                            t_remove: int):
    """Plain version of the lane-axis ``masked_max3``: inputs with a
    leading lane axis B, :func:`masked_max3_plain` applied lane by
    lane, the maxima stacked to i32[B, N, N]."""
    outs = [masked_max3_plain(gossip[b], proc[b], known[b], hb[b], ts[b],
                              now, t_remove=t_remove)
            for b in range(known.shape[0])]
    return tuple(torch.stack(planes) for planes in zip(*outs))


def masked_max3(gossip, proc, known, hb, ts, now: int, *, t_remove: int):
    """The three merge maxima of one tick (see the module docstring).

    ``gossip`` bool[S, R] (sender, receiver) delivers from S senders to R
    receivers, ``proc`` bool[R] says which receivers consume this tick,
    ``known`` bool / ``hb``, ``ts`` i32 [S, C] are the senders' payload
    rows over C columns; the maxima are i32[R, C].  A tick merges the
    square N x N block; the ring merge of a peer-sharded run
    (parallel/comm.py ``RingComm.merge_reduce``) merges an Nl x Nl block
    against Nl x N payload rows.  With a leading lane axis (``known``
    [B, S, C], ``proc`` [B, R], ...) it merges B independent lanes of a
    fleet at the shared clock ``now``, in one launch on a card.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  A call whose block is not square also counts on
    ``masked_max3.rect_launches``.
    """
    lanes = known.dim() == 3
    if known.device.type == "cpu":
        fn = masked_max3_lanes_plain if lanes else masked_max3_plain
        return fn(gossip, proc, known, hb, ts, now, t_remove=t_remove)
    from .cuda._build import (check, check_args, count_launch,
                              library, ptr, stream_ptr)
    s_dim, r_dim = gossip.shape[-2:]
    c_dim = known.shape[-1]
    b = known.shape[0] if lanes else 1
    lead = (b,) if lanes else ()
    payload = lead + (s_dim, c_dim)
    check_args("masked_max3", (gossip, torch.bool, lead + (s_dim, r_dim)),
               (proc, torch.bool, lead + (r_dim,)),
               (known, torch.bool, payload), (hb, torch.int32, payload),
               (ts, torch.int32, payload))
    out = lead + (r_dim, c_dim)
    m_all, m_fresh, t_fresh = (torch.empty(out, dtype=torch.int32,
                                           device=known.device)
                               for _ in range(3))
    lib = library()
    scratch = torch.empty(b * lib.gp_merge_scratch_words(r_dim, s_dim),
                          dtype=torch.int32, device=known.device)
    code = lib.gp_masked_max3(
        ptr(gossip), ptr(proc), ptr(known), ptr(hb), ptr(ts),
        ptr(m_all), ptr(m_fresh), ptr(t_fresh), ptr(scratch), r_dim, s_dim,
        c_dim, b, int(now), int(t_remove), stream_ptr(known.device))
    count_launch(masked_max3)
    if not r_dim == s_dim == c_dim:
        count_launch(masked_max3, "rect_launches")
    check(code, "masked_max3")
    return m_all, m_fresh, t_fresh


masked_max3.launches = 0
masked_max3.rect_launches = 0

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
(``gossip_reductions_mxu`` / ``_masked_max_mxu``) on the tensor cores,
its levels taken from a witness ladder built once a call, as
:func:`masked_max3_descent` runs it; on a CPU tensor it runs
:func:`masked_max3_plain`.  All are exact, so they agree bit for bit.
Given ``counts``, the kernel counts its plane descents and those that
fell back past the ladder; a bench fleet passes them while spans record
and adds them to the span counters ``merge.tiles`` and
``merge.fallback_tiles`` (core/fleet.py).

:func:`merge_epilogue` is the K1 tick's merge and epilogue as one op:
where the merge builds a witness ladder (:func:`uses_ladder`), the card
applies the tick's cell rules inside the descent's tiles, and the three
maxima are never written.
"""

from __future__ import annotations

from typing import NamedTuple

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
#: rungs of the witness ladder (csrc/dense_tick.cu LADDER)
LADDER = 2
#: a block of more row tiles than this builds the ladder when its sender
#: words fit the kernel's word lists (csrc/dense_tick.cu use_ladder)
LADDER_MIN_ROW_TILES = 4
_LADDER_MAX_WORDS = (48 * 1024) // (4 * (1 + 3 + 3 * LADDER))
PLANES = "aft"


def uses_ladder(r_dim: int, s_dim: int) -> bool:
    """Whether the ``masked_max3`` kernel builds a witness ladder for an
    S x R delivery block (csrc/dense_tick.cu ``use_ladder``)."""
    return (r_dim > LADDER_MIN_ROW_TILES * TILE_ROWS
            and -(-s_dim // WORD) <= _LADDER_MAX_WORDS)


class Descent(NamedTuple):
    """What :func:`masked_max3_descent` computed and how.

    ``maxima`` is ``(m_all, m_fresh, t_fresh)``; the other fields are
    per plane (``"a"``, ``"f"``, ``"t"``): ``products`` and ``words``
    i64[row tiles, column tiles], the tensor-core products each tile
    ran and the 32-sender words they multiplied together; ``fallback``
    bool[row tiles, column tiles], the tiles whose descent went on past
    the ladder; ``rung_cells`` and ``fallback_cells``, the cells a rung
    and the fallback closed (the rest are FILL).  ``ladder`` is False
    for a block that runs the per-tile descent alone.
    """
    maxima: tuple
    products: dict
    words: dict
    fallback: dict
    rung_cells: dict
    fallback_cells: dict
    ladder: bool


def witness_ladder(v, rungs: int = LADDER):
    """i32[rungs, C]: the ``rungs`` largest distinct positive values of
    each column of the payload plane ``v`` [S, C], 0 past the last."""
    out = torch.zeros((rungs, v.shape[1]), dtype=v.dtype, device=v.device)
    cur = v
    for k in range(rungs):
        out[k] = cur.amax(0).clamp_min(0)
        cur = torch.where(cur < out[k], cur, 0)
    return out


def masked_max3_descent(gossip, proc, known, hb, ts, now: int, *,
                        t_remove: int, ladder: bool | None = None) -> Descent:
    """Plain mirror of the ``masked_max3`` kernel's algorithm: the JAX
    package's level descent (``_masked_max_mxu``) on a witness ladder.

    ``gossip`` bool[S, R] delivers to R receivers, ``known`` / ``hb`` /
    ``ts`` [S, C] are the senders' payload rows.  Per row tile of
    ``TILE_ROWS`` receivers only the 32-sender words with a delivery to
    one of its rows take part (the tile's live words).

    The ladder is built once a call: per plane and column, the top
    ``LADDER`` distinct positive values over every sender row
    (:func:`witness_ladder`), with one witness bit a (sender, column)
    for each rung (``v == rung``) and for level 0 (``v > 0``: known for
    plane a, fresh for f and t).  Ladder values are those of a superset
    of the senders that deliver, so for a cell no rung above its true
    maximum has a witness among its senders, and the true maximum is a
    rung or lies below the last.  A ``TILE_ROWS x TILE_COLS`` tile then
    runs, per plane, the product ``d @ (v == rung k)`` for k = 1, 2, ...
    (a cell it hits first takes ``rung - 1``), closes the cells of
    columns whose ladder holds every value as FILL, runs level 0
    ``d @ (v > 0)`` (a cell it misses is FILL) and, if cells are still
    open, falls back to the per-tile descent from below the last rung:
    each level is the next distinct value below the last among the
    tile's live senders.  A product over no word with a witness in the
    tile's columns is skipped, and a tile stops once none of its cells
    is open.  A block of at most ``LADDER_MIN_ROW_TILES`` row tiles
    builds no ladder (:func:`uses_ladder`; ``ladder`` overrides the rule,
    so a test can run either at any size): its tiles run the per-tile
    descent from level 0.
    """
    s_dim, r_dim = gossip.shape
    c_dim = known.shape[1]
    dev = known.device
    d = (gossip & proc[None, :]).t()                      # [r, s]
    w = -(-s_dim // WORD)
    dpad = torch.zeros((r_dim, w * WORD), dtype=torch.bool, device=dev)
    dpad[:, :s_dim] = d
    live_word = dpad.view(r_dim, w, WORD).any(2)          # [r, W]
    rt, ct = -(-r_dim // TILE_ROWS), -(-c_dim // TILE_COLS)
    col_tile = torch.arange(c_dim, device=dev) // TILE_COLS
    if ladder is None:
        ladder = uses_ladder(r_dim, s_dim)
    vs = merge_payloads(known, hb, ts, now, t_remove)

    def per_tile(mask):
        """bool[R', C] -> bool[ct]: the column tiles with a set cell."""
        out = torch.zeros(ct, dtype=torch.bool, device=dev)
        out[col_tile[mask.any(0)]] = True
        return out

    def word_tiles(bits):
        """bool[S, C] -> bool[W, ct]: the words with a set bit in each
        column tile."""
        pad = torch.zeros((w * WORD, ct * TILE_COLS), dtype=torch.bool,
                          device=dev)
        pad[:s_dim, :c_dim] = bits
        return pad.view(w, WORD, ct, TILE_COLS).any(3).any(1)

    maxima, products, words, fallback = [], {}, {}, {}
    rung_cells, fallback_cells = {}, {}
    for p, (name, v) in enumerate(zip(PLANES, vs)):
        m = torch.full((r_dim, c_dim), FILL, dtype=torch.int32, device=dev)
        prod = torch.zeros((rt, ct), dtype=torch.int64, device=dev)
        nw = torch.zeros((rt, ct), dtype=torch.int64, device=dev)
        fb = torch.zeros((rt, ct), dtype=torch.bool, device=dev)
        n_rung = n_fb = 0
        lad = witness_ladder(v) if ladder else None
        for i in range(rt):
            rows = slice(i * TILE_ROWS, min(r_dim, (i + 1) * TILE_ROWS))
            lw = live_word[rows].any(0)                    # [W]
            nlive = int(lw.sum())
            if not nlive:
                continue
            live = lw.repeat_interleave(WORD)[:s_dim]
            dd = d[rows].to(torch.float32)
            vl = v * live[:, None]
            mi = m[rows]

            def product(bits, tiles, skip_empty=True):
                # exact: counts <= S < 2^24
                k = (word_tiles(bits) & lw[:, None]).sum(0) if skip_empty \
                    else torch.full((ct,), nlive, device=dev)
                run = tiles & (k > 0)
                prod[i] += run
                nw[i] += k * run
                return (dd @ bits.to(torch.float32)) > 0

            if ladder:
                open_ = proc[rows][:, None].expand(-1, c_dim).clone()
                for k in range(LADDER):
                    tiles = per_tile(open_)
                    if not tiles.any():
                        break
                    hit = product((v == lad[k]) & (lad[k] > 0), tiles)
                    newly = hit & open_
                    mi[newly] = (lad[k] - 1).expand_as(mi)[newly]
                    n_rung += int(newly.sum())
                    open_ &= ~newly
                # a column whose ladder holds all its values: FILL
                open_ &= (lad[-1] > 0)[None, :]
                tiles = per_tile(open_)
                if tiles.any():
                    open_ &= product(v > 0, tiles)
                tiles = per_tile(open_)
                fb[i] = tiles
                if not tiles.any():
                    continue
                # the probe pass: the next value below the last rung
                cur = torch.where(vl < lad[-1], vl, 0).amax(0)
            else:
                open_ = torch.ones_like(mi, dtype=torch.bool)
                open_ &= product(v > 0, torch.ones(
                    ct, dtype=torch.bool, device=dev), skip_empty=False)
                cur = vl.amax(0)
            while open_.any():
                tiles = per_tile(open_)
                hit = product((vl == cur) & (cur > 0), tiles,
                              skip_empty=False)
                newly = hit & open_
                mi[newly] = (cur - 1).expand_as(mi)[newly]
                if ladder:
                    n_fb += int(newly.sum())
                open_ &= ~newly
                cur = torch.where(vl < cur, vl, 0).amax(0)
        maxima.append(m)
        products[name], words[name], fallback[name] = prod, nw, fb
        rung_cells[name], fallback_cells[name] = n_rung, n_fb
    return Descent(tuple(maxima), products, words, fallback, rung_cells,
                   fallback_cells, ladder)


def masked_max3_lanes_plain(gossip, proc, known, hb, ts, now: int, *,
                            t_remove: int):
    """Plain version of the lane-axis ``masked_max3``: inputs with a
    leading lane axis B, :func:`masked_max3_plain` applied lane by
    lane, the maxima stacked to i32[B, N, N]."""
    outs = [masked_max3_plain(gossip[b], proc[b], known[b], hb[b], ts[b],
                              now, t_remove=t_remove)
            for b in range(known.shape[0])]
    return tuple(torch.stack(planes) for planes in zip(*outs))


def masked_max3(gossip, proc, known, hb, ts, now: int, *, t_remove: int,
                counts=None):
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

    ``counts`` (CUDA i64[B, 2], or [2] for every lane together): a launch
    that builds a witness ladder (:func:`uses_ladder`) adds each lane's
    plane descents, three a tile, and those that fell back past the
    ladder.
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
    cstride = _counts_stride("masked_max3", counts, known, b)
    out = lead + (r_dim, c_dim)
    m_all, m_fresh, t_fresh = (torch.empty(out, dtype=torch.int32,
                                           device=known.device)
                               for _ in range(3))
    lib = library()
    lane_words = lib.gp_masked_max3_scratch_words(r_dim, s_dim, c_dim)
    if lane_words < 0:
        raise ValueError(f"masked_max3: a {s_dim} x {r_dim} x {c_dim} "
                         "block's scratch is too large")
    scratch = torch.empty(b * lane_words, dtype=torch.int32,
                          device=known.device)
    code = lib.gp_masked_max3(
        ptr(gossip), ptr(proc), ptr(known), ptr(hb), ptr(ts),
        ptr(m_all), ptr(m_fresh), ptr(t_fresh), ptr(scratch), r_dim, s_dim,
        c_dim, b, int(now), int(t_remove), ptr(counts), cstride,
        stream_ptr(known.device))
    count_launch(masked_max3)
    if not r_dim == s_dim == c_dim:
        count_launch(masked_max3, "rect_launches")
    check(code, "masked_max3")
    return m_all, m_fresh, t_fresh


masked_max3.launches = 0
masked_max3.rect_launches = 0


def _counts_stride(what: str, counts, known, b: int) -> int:
    """Check a launch's merge counters (CUDA i64[B, 2] or [2], beside
    ``known``); the kernel's lane stride into them (0: one pair)."""
    if counts is None:
        return 0
    from .cuda._build import check_args
    check_args(what, (counts, torch.int64, tuple(counts.shape)),
               (known, torch.bool, tuple(known.shape)))
    if counts.shape not in ((2,), (b, 2)):
        raise ValueError(f"{what}: counts must be [{b}, 2] or [2], "
                         f"got {tuple(counts.shape)}")
    return 2 if counts.dim() == 2 else 0


def merge_epilogue(gossip, proc, known, hb, ts, gdrop, ops, jrep, jreq,
                   live_hold, t: int, *, rows, t_remove: int,
                   with_events: bool = True, counts=None):
    """One tick's merge and post-merge update in one op: what
    :func:`masked_max3` and then ``ops/cuda/tickfused.py``
    ``tick_epilogue`` compute, from the same inputs less the maxima,
    returning what ``tick_epilogue`` returns (``rows`` added onto in
    place on a card).  With or without a leading lane axis.

    CPU tensors take the two plain versions in turn.  CUDA tensors launch
    csrc/dense_tick.cu ``merge_epilogue`` (the merge's prep, then one
    launch in which each ladder tile applies the cell rules to the maxima
    it found, so they never reach HBM), which needs the merge's witness
    ladder: an N x N tick with ``uses_ladder(N, N)`` (N > 1024); a
    smaller one raises, as its tick runs the pair.  ``counts`` as
    :func:`masked_max3`'s.  Adds one to ``merge_epilogue.launches`` a
    launch (two kernels: the prep and the fused descent).
    """
    if known.device.type == "cpu":
        from .cuda.tickfused import tick_epilogue
        m = masked_max3(gossip, proc, known, hb, ts, t, t_remove=t_remove)
        return tick_epilogue(*m, gossip, proc, known, hb, ts, gdrop, ops,
                             jrep, jreq, live_hold, t, rows=rows,
                             t_remove=t_remove, with_events=with_events)
    from .cuda._build import (check, check_args, count_launch, library,
                              ptr, stream_ptr)
    n = known.shape[-1]
    lanes = known.dim() == 3
    b = known.shape[0] if lanes else 1
    lead = (b,) if lanes else ()
    if not uses_ladder(n, n):
        raise ValueError(f"merge_epilogue: N={n} builds no witness ladder; "
                         "its tick runs masked_max3 and tick_epilogue")
    ins = (gossip, proc, known, hb, ts, gdrop, ops, jrep, jreq, live_hold)
    sent_row, recv_row = rows
    i32, b8, plane, vec = torch.int32, torch.bool, lead + (n, n), lead + (n,)
    check_args("merge_epilogue", *zip(
        ins + (sent_row, recv_row),
        (b8, b8, b8, i32, i32, b8, b8, b8, b8, b8, i32, i32),
        (plane, vec, plane, plane, plane, plane) + (vec,) * 6))
    cstride = _counts_stride("merge_epilogue", counts, known, b)
    dev = known.device

    def out(shape, dt):
        return torch.empty(shape, dtype=dt, device=dev)

    known_o, gossip_o = out(plane, b8), out(plane, b8)
    hb_o, ts_o = out(plane, i32), out(plane, i32)
    added = out(plane, b8) if with_events else None
    removed = out(plane, b8) if with_events else None
    lib = library()
    scratch = out(b * lib.gp_masked_max3_scratch_words(n, n, n), i32)
    # the cells of tiles that fall back past the ladder: written and read
    # back by their own block only
    fallback = out(b * 3 * n * n, i32)
    code = lib.gp_merge_epilogue(
        *(ptr(x) for x in ins), ptr(known_o), ptr(hb_o), ptr(ts_o),
        ptr(gossip_o), ptr(sent_row), ptr(recv_row), ptr(added),
        ptr(removed), ptr(scratch), ptr(fallback), n, b, int(t),
        int(t_remove), ptr(counts), cstride, stream_ptr(dev))
    count_launch(merge_epilogue)
    check(code, "merge_epilogue")
    return known_o, hb_o, ts_o, gossip_o, sent_row, recv_row, added, removed


merge_epilogue.launches = 0

"""The yardstick's roofline arithmetic reproduces the bounds PERF.md's
kernel table lists (chip_smoke.py's, on the same shapes)."""

import pytest

from benchmark import roofline as rl
from benchmark.reference.dense import active_width


def test_the_draw_at_2816():
    """``drop_masks`` N=2816, S=1, tick 300: 0.0332 ms (operations)."""
    ms, by = rl.draw_bound(2816, 2816, 1, 1)
    assert (round(ms, 4), by) == (0.0332, "operations")
    assert round(4 * ms, 4) == 0.1328              # /fleet, B=4


def test_the_boot_pre_pass_at_2_20():
    """K5's boot pre-pass, N=2^20: 0.0100 ms (bytes), 0.0016 needed."""
    assert (round(rl.boot_bound(1 << 20, 64)[0], 4), rl.boot_bound(
        1 << 20, 64)[1]) == (0.0100, "bytes")
    assert round(rl.boot_bound(1 << 20, 64, needed=True)[0], 4) == 0.0016


def test_k5_fleet_at_65536():
    """K5 ``/fleet``: B=8 N=65,536, the call of ticks 592-607: 2.0973 ms
    (operations).  By then every churned peer has rejoined (failures fall
    in ticks 152-455, rejoins 40 later) and the run drops nothing, so
    each of the 65,536 peers receives on all 3 rounds a tick."""
    n, k = 65536, 64
    recv = 16 * 3 * n
    ms = sum(rl.bound(*rl.k5_work(n, k, recv, 16, 1))[0] for _ in range(8))
    assert round(ms, 4) == 2.0973
    assert rl.bound(*rl.k5_work(n, k, recv, 16, 1))[1] == "operations"


def test_k5_at_2_20_is_bound_by_its_plane():
    """K5 at N=2^20, F=8: 5.1283 ms (bytes), the plane read and written
    every tick since it does not fit on the chip."""
    ms, by = rl.bound(*rl.k5_work(1 << 20, 64, 0, 16, 1))
    assert (round(ms, 4), by) == (5.1283, "bytes")


def test_the_epilogue_at_2816():
    """``tick_epilogue`` N=2816: 0.0781 ms (bytes); B=4: 0.3125."""
    nbytes, ops = rl.epilogue_work(2816)
    ms, by = rl.bound(nbytes, ops)
    assert (round(ms, 4), by) == (0.0781, "bytes")
    assert round(4 * ms, 4) == 0.3125


def test_overlay_run_least_sums_its_launches():
    conf = {"max_nnb": 65536, "overlay_view": 0}
    recv = [[3 * 65536] * 608] * 2
    s = rl.overlay_run_least_s(conf, recv)
    one = rl.bound(*rl.k5_work(65536, 64, 16 * 3 * 65536, 16, 1))[0]
    assert s == pytest.approx(2 * 38 * one / 1e3)


def test_dense_least_counts_the_state_and_the_draw():
    conf = {"max_nnb": 4096, "total_ticks": 700, "step_rate": 0.25,
            "fail_tick": 100, "rejoin_after": None, "drop_msg": True,
            "drop_open_tick": 50, "drop_close_tick": 300}
    a = active_width(conf)
    assert a == 2816
    closed = rl.dense_tick_least_ms(a, False)
    drawn = rl.dense_tick_least_ms(a, True)
    assert closed == pytest.approx(20 * a * a / rl.HBM_BYTES_PER_S * 1e3)
    assert drawn > closed
    s = rl.dense_run_least_s(conf, a, 8)
    assert s == pytest.approx(8 * (250 * drawn + 450 * closed) / 1e3)
    # below the kernels' own bounds at this width: the merge's needed
    # bytes alone with every sender delivering, the epilogue, the draw
    per_kernel = rl.bound(rl.merge_needed_bytes(a, a), 0)[0] \
        + rl.bound(*rl.epilogue_work(a))[0] + rl.draw_bound(a, a, 1, 1)[0]
    assert drawn < per_kernel

"""The port's segment planner equals the JAX package's.

Plans (segment starts, lengths and phase flags), checkpoint cuts,
``cut_for_budget``, ``plan_signature``, the phase windows and
``quantize_tick`` are compared on the scenarios of
``tests/test_segments.py`` and on BASELINE's two grid-route
configurations at full size (the planner reads the config only).
"""

import dataclasses

import pytest

from gossip_protocol_tpu.config import SimConfig as JaxConfig
from gossip_protocol_tpu.models import segments as jseg
from gossip_protocol_tpu.ops.pallas.overlay_grid import \
    GRID_TICKS as JAX_GRID_TICKS
from gossip_protocol_tpu_torch.config import SimConfig
from gossip_protocol_tpu_torch.models import segments as pseg
from gossip_protocol_tpu_torch.ops.cuda.overlay_grid import GRID_TICKS

CONFIGS = {
    # tests/test_segments.py:37-55
    "churn": dict(max_nnb=64, single_failure=False, seed=7, total_ticks=200,
                  churn_rate=0.25, rejoin_after=30, step_rate=40.0 / 64),
    "fail_rejoin": dict(max_nnb=64, single_failure=False, seed=3,
                        total_ticks=180, fail_tick=70, rejoin_after=25,
                        step_rate=0.5),
    "drop10": dict(max_nnb=64, single_failure=True, drop_msg=True,
                   msg_drop_prob=0.1, seed=5, total_ticks=160, fail_tick=60,
                   step_rate=0.25, drop_open_tick=20, drop_close_tick=90),
    # chip_smoke.py's BASELINE configurations routed to K5
    "churn65k": dict(max_nnb=65536, single_failure=False, total_ticks=608,
                     churn_rate=0.2, rejoin_after=40, step_rate=64.0 / 65536),
    "powerlaw1m": dict(max_nnb=1 << 20, single_failure=True,
                       total_ticks=272, fail_tick=136,
                       step_rate=40.0 / (1 << 20), topology="powerlaw"),
}


def _pair(name):
    kw = dict(CONFIGS[name], model="overlay")
    return JaxConfig(**kw), SimConfig(**kw)


def _plan(plan):
    return [(s.start, s.ticks, dataclasses.astuple(s.flags)) for s in plan]


@pytest.mark.parametrize("start", [0, 17, 48, 160, None])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_equals_jax(name, start):
    jc, pc = _pair(name)
    first = 0 if start is None else start
    for length in (pc.total_ticks - first, 44, 12, 0):
        want = jseg.plan_segments(jc, length, start, JAX_GRID_TICKS)
        got = pseg.plan_segments(pc, length, start, GRID_TICKS)
        assert _plan(got) == _plan(want), (length, pseg.describe_plan(got))
        assert pseg.describe_plan(got) == jseg.describe_plan(want)
        for seg in got:
            assert seg.flags.as_kernel_kwargs() == \
                jseg.PhaseFlags(**seg.flags.as_kernel_kwargs()) \
                .as_kernel_kwargs()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_windows_signature_and_cuts_equal_jax(name):
    jc, pc = _pair(name)
    assert dataclasses.astuple(pseg.phase_windows(pc)) == \
        dataclasses.astuple(jseg.phase_windows(jc))
    assert pseg.plan_signature(pc) == jseg.plan_signature(jc)
    assert pseg.checkpoint_ticks(pc) == jseg.checkpoint_ticks(jc)
    assert pseg.checkpoint_ticks(pc, 8) == jseg.checkpoint_ticks(jc, 8)
    total = pc.total_ticks
    for start in (0, 1, 17, 64, total // 2, total - 1):
        for budget in (1, 16, 40, 100, total):
            assert pseg.cut_for_budget(pc, start, budget) == \
                jseg.cut_for_budget(jc, start, budget), (start, budget)
    for bad in (-1, total):
        with pytest.raises(ValueError):
            pseg.cut_for_budget(pc, bad, 16)


def test_flags_tags_and_constants_equal_jax():
    assert pseg.CHECKPOINT_GRID_TICKS == jseg.CHECKPOINT_GRID_TICKS \
        == GRID_TICKS == JAX_GRID_TICKS
    assert pseg.ALL_LIVE.tag == jseg.ALL_LIVE.tag
    for bits in range(16):
        flags = [bool(bits >> i & 1) for i in range(4)]
        assert pseg.PhaseFlags(*flags).tag == jseg.PhaseFlags(*flags).tag
    for t in (-1, 0, 1, 15, 16, 17, 607, 1 << 30):
        for up in (False, True):
            assert pseg.quantize_tick(t, up=up) == jseg.quantize_tick(t, up=up)
    for rate in (0.25, 0.5, 40.0 / 64, 64.0 / 65536, 40.0 / (1 << 20)):
        assert pseg.step_fraction(rate) == jseg.step_fraction(rate)


def test_steady_tail_and_invariant():
    """The churn run ends in the fully dead variant, and every join-dead
    segment of every plan has no ramp and no rejoin window."""
    _, pc = _pair("churn")
    plan = pseg.plan_segments(pc, pc.total_ticks, 0, GRID_TICKS)
    assert plan[-1].flags == pseg.PhaseFlags(False, False, False, False)
    assert len({s.flags for s in plan}) >= 3
    _, pl = _pair("powerlaw1m")
    tags = {s.flags.tag for s in pseg.plan_segments(pl, 272, 0, GRID_TICKS)}
    assert "steady" in tags and "churn" in tags

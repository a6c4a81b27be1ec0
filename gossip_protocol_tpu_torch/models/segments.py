"""Start-ramp fraction (copy of ``gossip_protocol_tpu/models/segments.py``
``step_fraction``).

The segment planner of that module (``plan_segments``, ``PhaseFlags``)
serves the grid kernel, which is not ported yet; only the fraction the
overlay schedule needs lives here.
"""

from __future__ import annotations

from fractions import Fraction


def step_fraction(step_rate: float) -> tuple[int, int]:
    """(num, den) of the start-ramp rate: node ``i`` starts at tick
    ``i * num // den``."""
    frac = Fraction(step_rate).limit_denominator(1 << 15)
    return frac.numerator, max(frac.denominator, 1)

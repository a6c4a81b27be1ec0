"""Chip-side tools of the benchmark: the knee sweep and the control readings."""

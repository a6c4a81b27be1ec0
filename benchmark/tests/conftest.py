"""Pytest set-up of the benchmark's own tests (no JAX here: the benchmark
never loads it)."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an sm_90 CUDA device (the port's kernels); "
        "skips elsewhere")

"""Tests of the benchmark itself: ``python -m pytest portbench/tests``
from the checkout's root. Tests marked ``gpu`` need a CUDA card and skip
without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's hand-written kernels "
        "and its captured frame run only there)")

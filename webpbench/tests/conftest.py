"""Tests of the benchmark harness.  Run from the repo root:

    python -m pytest webpbench/tests -q

Tests marked ``cuda`` need the card and skip without one."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")

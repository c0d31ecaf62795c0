"""Tests of the benchmark harness. Run them with
``python -m pytest portbench/tests -q``; the ``chip`` tests run only where a
CUDA card is present (decided inside each test) and skip elsewhere."""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")

"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the
repository root (the card's tests, marked ``gpu``, skip without a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")

"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q` from the
root of a checkout. Tests marked `gpu` need a CUDA card and skip without
one; run them on the card with `python -m pytest benchmark/tests -m gpu`."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips itself without one")

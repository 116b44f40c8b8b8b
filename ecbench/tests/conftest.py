"""ecbench's tests: CPU tests at small sizes, and `cuda` tests that run a
cell on a CUDA card and skip without one (decided inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a benchmark cell on a CUDA card; skips "
        "without one")

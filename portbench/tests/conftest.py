"""Settings of the benchmark's own tests (`python -m pytest portbench/tests`).

Registers the `cuda` marker the repository's tests use for what needs a
card, and puts the checkout's root on the path. Imports no JAX.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skipped without one)")

"""Test bootstrap: make ``src`` importable and shim optional dev deps.

``hypothesis`` is a dev dependency (requirements-dev.txt).  In hermetic
containers without it, a minimal deterministic shim is registered instead so
all test modules still collect and the property tests still execute (real
hypothesis wins whenever it is installed — e.g. in CI).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.testing import install_hypothesis_shim  # noqa: E402

install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a card")

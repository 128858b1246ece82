"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the root of a checkout (CPU, about a minute). A test that needs the card
takes the `cuda` marker and decides inside a fixture, never at import,
whether there is one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def root():
    return ROOT

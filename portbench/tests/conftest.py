"""Test settings of portbench's own tests (run with
`python -m pytest portbench/tests`; the repository's tier-1 run collects
tests/ only). Registers the `card` marker: a test that needs the CUDA
card decides inside itself and skips here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "card" in item.keywords:
            item.add_marker(pytest.mark.card)

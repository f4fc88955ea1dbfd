"""Test settings of the benchmark: the ``card`` marker, the ``card``
fixture that skips without a CUDA card (decided when a test runs, never at
import), and a throwaway copy of the benchmark with tiny CPU cells
(``tests/tiny.py``)."""

from __future__ import annotations

import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "1")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the measured path and its control run there")
    return "cuda"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    from benchmark.tests.tiny import tiny_copy

    return tiny_copy(tmp_path_factory.mktemp("bench"))

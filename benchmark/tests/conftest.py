"""The benchmark's tests: CPU tests at tiny sizes, and tests marked ``chip``
that need the CUDA card (they skip without one, decided in a fixture)."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("PROJECT_ROOT", str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

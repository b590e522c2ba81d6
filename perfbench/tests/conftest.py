"""Fixtures of the benchmark's tests."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


@pytest.fixture(scope="session")
def bench() -> dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def cpu() -> torch.device:
    return torch.device("cpu")


@pytest.fixture
def card():
    """The first CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)

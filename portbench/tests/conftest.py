"""The benchmark's tests: run from the repository root with

    python -m pytest -q -p no:cacheprovider portbench/tests

on the CPU; the tests marked `cuda` skip without a card and run on one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA card the test runs on; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU "
                    "mode at the cells' sizes)")
    return torch.device("cuda", 0)

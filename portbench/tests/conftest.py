"""The benchmark's own CPU tests.  They run the port's plain path on the
CPU at small sizes; tests that need the card carry the `gpu` marker."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
for p in (ROOT, PB):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)    # several workers share the CPU's cores


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

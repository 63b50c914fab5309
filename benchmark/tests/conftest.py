"""The benchmark's tests: the checkout's root on sys.path, torch on a few
threads, and the `card` fixture of the tests that need a CUDA device."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="session")
def _threads():
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

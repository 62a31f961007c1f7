"""Tests of the port's benchmark. Run from the repository root:

    python -m pytest port_bench/tests -q

Tests marked `card` need a CUDA device and skip without one (decided inside
the `card` fixture, never at import).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test workers share the host's cores: one torch thread each."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)

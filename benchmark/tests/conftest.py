"""Test set-up of the benchmark's own tests: the harness and the program on
the path, tiny cells that run on the CPU, and the card fixture of the
tests that need the chip. Run from the repository root:

    python -m pytest benchmark/tests -q                 # the CPU tests
    python -m pytest benchmark/tests -q -m cuda         # on the card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

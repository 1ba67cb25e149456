"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository, on the CPU at small sizes.  Tests that need a
card are marked ``cuda`` and skip without one."""

import os
import sys

import pytest
import torch

# many small CPU operators a test: one thread each, so that test workers
# running side by side do not oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skip without a CUDA card (decided inside the test, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

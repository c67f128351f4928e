"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

Tests that need the card are marked ``cuda`` and skip inside the ``card``
fixture when there is none."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

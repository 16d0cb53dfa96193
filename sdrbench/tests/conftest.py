"""Shared helpers of the benchmark's tests: a tiny run of the cell on the
CPU, and the card's fixture (the decision whether a card is there is made
here, inside a fixture, never while a module is imported)."""

from __future__ import annotations

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# a tiny run of the spectrum cell on the CPU: its own traffic at 4,096-sample
# frames, the capture cut to a few dispatches (so the stream wraps)
TINY = dict(frame=4096, capture_samples=4096 * 4 * 8, warmup_dispatches=4,
            check_dispatches=4, trace_dispatches=8)


@pytest.fixture
def cuda():
    """The card, or a skip with the reason."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

"""FIR filter design: the windowed-sinc lowpass of
``futuresdr_tpu/dsp/firdes.py``. Cutoffs are normalized to the sample rate
(cycles/sample, 0.5 = Nyquist)."""

from __future__ import annotations

import numpy as np

from . import windows as _win

__all__ = ["lowpass"]


def lowpass(cutoff: float, n_taps: int, window="hamming") -> np.ndarray:
    """Windowed-sinc lowpass, unit DC gain."""
    k = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * k)
    w = _win.get_window(window, n_taps) if not isinstance(window, np.ndarray) else window
    h = h * w
    return h / h.sum()

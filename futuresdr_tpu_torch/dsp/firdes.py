"""FIR filter design: the windowed-sinc lowpass, the Kaiser auto-order
lowpass and the root-raised-cosine pulse of ``futuresdr_tpu/dsp/firdes.py``.
Cutoffs are normalized to the sample rate (cycles/sample, 0.5 = Nyquist)."""

from __future__ import annotations

import numpy as np

from . import windows as _win

__all__ = ["lowpass", "kaiser_order", "kaiser_lowpass", "root_raised_cosine"]


def lowpass(cutoff: float, n_taps: int, window="hamming") -> np.ndarray:
    """Windowed-sinc lowpass, unit DC gain."""
    k = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * k)
    w = _win.get_window(window, n_taps) if not isinstance(window, np.ndarray) else window
    h = h * w
    return h / h.sum()


def kaiser_order(atten_db: float, transition_width: float) -> tuple:
    """Kaiser order and beta from the stopband attenuation and the normalized
    transition width."""
    a = float(atten_db)
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    n = int(np.ceil((a - 7.95) / (2.285 * 2 * np.pi * transition_width))) + 1
    return n, beta


def kaiser_lowpass(cutoff: float, transition_width: float,
                   atten_db: float = 60.0) -> np.ndarray:
    """Lowpass from its spec through a Kaiser window of odd length."""
    n, beta = kaiser_order(atten_db, transition_width)
    if n % 2 == 0:
        n += 1
    return lowpass(cutoff, n, _win.kaiser(n, beta))


def root_raised_cosine(span_symbols: int, sps: int, rolloff: float) -> np.ndarray:
    """RRC pulse (`firdes/basic.rs` root_raised_cosine); unit energy."""
    n = span_symbols * sps + 1
    t = (np.arange(n) - (n - 1) / 2.0) / sps
    b = rolloff
    h = np.empty(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 + b * (4.0 / np.pi - 1.0)
        elif b > 0 and abs(abs(ti) - 1.0 / (4.0 * b)) < 1e-9:
            h[i] = (b / np.sqrt(2.0)) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * b))
                                         + (1 - 2 / np.pi) * np.cos(np.pi / (4 * b)))
        else:
            num = np.sin(np.pi * ti * (1 - b)) + 4 * b * ti * np.cos(np.pi * ti * (1 + b))
            den = np.pi * ti * (1 - (4 * b * ti) ** 2)
            h[i] = num / den
    return h / np.sqrt(np.sum(h ** 2))

"""FIR filter design, the designs of ``futuresdr_tpu/dsp/firdes.py``:
windowed-sinc lowpass, highpass, bandpass and bandstop, the Hilbert
transformer, the Kaiser auto-order lowpass, the root-raised-cosine pulse and
the Parks-McClellan equiripple design (:mod:`.remez`). Host numpy; cutoffs
are normalized to the sample rate (cycles/sample, 0.5 = Nyquist)."""

from __future__ import annotations

import numpy as np

from . import windows as _win

__all__ = ["lowpass", "highpass", "bandpass", "bandstop", "root_raised_cosine",
           "hilbert", "kaiser_order", "kaiser_lowpass", "remez"]


def _windowed(h: np.ndarray, window) -> np.ndarray:
    """``h`` times ``window`` (a name for :func:`.windows.get_window`, or
    the window's samples)."""
    w = _win.get_window(window, len(h)) if not isinstance(window, np.ndarray) else window
    return h * w


def _odd(n_taps: int, design: str) -> None:
    if n_taps % 2 == 0:
        raise ValueError(f"{design} needs odd tap count")


def lowpass(cutoff: float, n_taps: int, window="hamming") -> np.ndarray:
    """Windowed-sinc lowpass, unit DC gain."""
    k = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = _windowed(2.0 * cutoff * np.sinc(2.0 * cutoff * k), window)
    return h / h.sum()


def highpass(cutoff: float, n_taps: int, window="hamming") -> np.ndarray:
    """The windowed lowpass spectrally inverted; odd length."""
    _odd(n_taps, "highpass")
    h = -lowpass(cutoff, n_taps, window)
    h[(n_taps - 1) // 2] += 1.0
    return h


def bandpass(f_lo: float, f_hi: float, n_taps: int, window="hamming") -> np.ndarray:
    """The difference of two windowed sincs, unit gain at the band's center."""
    k = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = _windowed(2.0 * f_hi * np.sinc(2.0 * f_hi * k)
                  - 2.0 * f_lo * np.sinc(2.0 * f_lo * k), window)
    fc = (f_lo + f_hi) / 2.0
    gain = np.abs(np.sum(h * np.exp(-2j * np.pi * fc * np.arange(n_taps))))
    return h / gain


def bandstop(f_lo: float, f_hi: float, n_taps: int, window="hamming") -> np.ndarray:
    """The bandpass spectrally inverted; odd length."""
    _odd(n_taps, "bandstop")
    h = -bandpass(f_lo, f_hi, n_taps, window)
    h[(n_taps - 1) // 2] += 1.0
    return h


def hilbert(n_taps: int, window="hamming") -> np.ndarray:
    """Windowed Hilbert transformer, ``2/(πk)`` at odd offsets ``k`` from the
    center; odd length."""
    _odd(n_taps, "hilbert")
    k = np.arange(n_taps) - (n_taps - 1) // 2
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(k % 2 != 0, 2.0 / (np.pi * k), 0.0)
    return _windowed(h, window)


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


def remez(n_taps: int, bands, desired, weight=None, kind: str = "bandpass") -> np.ndarray:
    """Parks-McClellan equiripple design (:func:`.remez.remez_exchange`).

    ``bands``: edge pairs in cycles/sample (0..0.5), flat or as pairs;
    ``desired``: one gain a band; ``weight``: one a band (default 1). The
    design is symmetric (types I and II) whatever ``kind`` says, as in the
    JAX package; antisymmetric designs go through ``remez_exchange(...,
    filter_type=)``."""
    from .remez import remez_exchange
    return remez_exchange(n_taps, np.asarray(bands).ravel(), desired, weight)

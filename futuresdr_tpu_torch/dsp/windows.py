"""Window functions (a copy of ``futuresdr_tpu/dsp/windows.py``), computed in
float64 and cast by the caller."""

from __future__ import annotations

import numpy as np

__all__ = ["rect", "bartlett", "blackman", "hamming", "hann", "kaiser", "gaussian",
           "get_window"]


def rect(n: int) -> np.ndarray:
    return np.ones(n)


def bartlett(n: int) -> np.ndarray:
    return np.bartlett(n)


def blackman(n: int, exact: bool = False) -> np.ndarray:
    if not exact:
        return np.blackman(n)
    a0, a1, a2 = 7938 / 18608, 9240 / 18608, 1430 / 18608
    k = np.arange(n)
    return a0 - a1 * np.cos(2 * np.pi * k / (n - 1)) + a2 * np.cos(4 * np.pi * k / (n - 1))


def hamming(n: int) -> np.ndarray:
    return np.hamming(n)


def hann(n: int) -> np.ndarray:
    return np.hanning(n)


def kaiser(n: int, beta: float) -> np.ndarray:
    return np.kaiser(n, beta)


def gaussian(n: int, alpha: float = 2.5) -> np.ndarray:
    k = np.arange(n) - (n - 1) / 2.0
    sigma = (n - 1) / (2.0 * alpha)
    return np.exp(-0.5 * (k / sigma) ** 2)


_WINDOWS = {
    "rect": rect,
    "rectangular": rect,
    "bartlett": bartlett,
    "blackman": blackman,
    "hamming": hamming,
    "hann": hann,
    "hanning": hann,
}


def get_window(name, n: int, **kw) -> np.ndarray:
    """Window by name; ``kaiser`` needs ``beta``, ``gaussian`` takes ``alpha``."""
    if callable(name):
        return name(n, **kw)
    name = name.lower()
    if name == "kaiser":
        return kaiser(n, kw.get("beta", 8.6))
    if name == "gaussian":
        return gaussian(n, kw.get("alpha", 2.5))
    try:
        return _WINDOWS[name](n)
    except KeyError:
        raise ValueError(f"unknown window {name!r}") from None

"""Plain DSP for the references: tap designs worked out from their
published formulas, the wrapped capture read as an endless stream, direct
FIR sums, and the rounding that stands in for a lower precision.

Nothing here imports the program under test. Everything computes in
float64 (complex128) unless ``precision="tf32"`` asks for less: each
product's operands rounded to TF32's 10-bit mantissa and the sums in
float32, as a TF32 tensor-core product does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# --- tap designs (windowed sinc, FutureSDR's firdes) -----------------------


def hamming(n: int) -> np.ndarray:
    """The symmetric Hamming window ``0.54 - 0.46 cos(2πk/(n-1))``."""
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def windowed_lowpass(cutoff: float, window: np.ndarray) -> np.ndarray:
    """Windowed-sinc lowpass at ``cutoff`` cycles a sample, unit DC gain."""
    n = len(window)
    k = np.arange(n) - (n - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * k) * window
    return h / h.sum()


def design(spec: dict) -> np.ndarray:
    """Taps from a configuration's design entry."""
    if spec["design"] == "hamming_lowpass":
        return windowed_lowpass(spec["cutoff"], hamming(spec["n_taps"]))
    raise ValueError(f"unknown tap design {spec['design']!r}")


# --- the capture as a stream ------------------------------------------------


def stream(capture: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Samples ``start .. start+n-1`` of the endless stream that repeats
    ``capture``, zeros before sample 0, as complex128 on the capture's
    device."""
    size = capture.shape[0]
    out = torch.zeros(n, dtype=torch.complex128, device=capture.device)
    pos = start
    while pos < start + n:
        if pos < 0:
            pos = min(0, start + n)
            continue
        at = pos % size
        take = min(size - at, start + n - pos)
        out[pos - start:pos - start + take] = capture[at:at + take].to(torch.complex128)
        pos += take
    return out


# --- lower precisions -------------------------------------------------------


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32 (nearest, ties to even at mantissa bit 13), in
    float32."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def rounded(v: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """``v`` rounded to TF32 and held in float32 (complex64) for
    ``precision="tf32"``; ``None`` leaves it in float64 (complex128)."""
    if precision is None:
        return v.to(torch.complex128 if v.is_complex() else torch.float64)
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    if v.is_complex():
        return torch.complex(_tf32(v.real), _tf32(v.imag))
    return _tf32(v)


def work_dtype(precision: Optional[str], complex_: bool) -> torch.dtype:
    if precision is None:
        return torch.complex128 if complex_ else torch.float64
    return torch.complex64 if complex_ else torch.float32


# --- direct FIR sums --------------------------------------------------------


def fir(x: torch.Tensor, taps: torch.Tensor, first: int, count: int,
        precision: Optional[str] = None) -> torch.Tensor:
    """``y[i] = Σ_t taps[t]·x[first + i − t]`` for ``i < count``: the causal
    FIR of ``x`` from sample ``first`` (``first >= len(taps) - 1``), summed
    tap by tap."""
    nt = taps.shape[0]
    if first < nt - 1:
        raise ValueError("fir: the first output needs len(taps) - 1 samples before it")
    xs = rounded(x, precision)
    ts = rounded(taps, precision)
    y = torch.zeros(count, dtype=work_dtype(precision, xs.is_complex() or ts.is_complex()),
                    device=x.device)
    for t in range(nt):
        lo = first - t
        y += ts[t] * xs[lo:lo + count]
    return y

"""Streaming filter cores: stateful, vectorized, frame-in/frame-out.

A copy of ``futuresdr_tpu/dsp/kernels.py``, a
re-design of ``crates/futuredsp/src/`` (reference ``Filter``/``StatefulFilter`` traits,
``fir.rs:31``, ``iir.rs``, ``polyphase_resampling_fir.rs:41``, ``rotator.rs``): each core
carries its history/phase state internally and exposes ``process(x) -> y``, so a block's
``work`` is "read window → process → write". The same cores back the CPU block path
(numpy) while the device path re-expresses them as overlap-save stages
(``futuresdr_tpu_torch/ops``) with explicit carry — the streaming contract is identical.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.signal import lfilter

__all__ = ["FirFilter", "DecimatingFirFilter", "PolyphaseResamplingFir", "IirFilter",
           "Rotator", "poly_resample_m_hi"]


def poly_resample_m_hi(total: int, interp: int, decim: int) -> int:
    """Outputs producible once ``total`` absolute inputs are visible: the
    largest m with ``(m·D)//I ≤ total−1`` is ``(I·total−1)//D``, plus one.

    THE single Python source of the resampler's producible-output contract
    (used by :class:`PolyphaseResamplingFir` and the native fast-chain's sink
    bound; mirrored once in C, ``csrc/host/fastchain.cpp resample_m_hi``). The
    closed form also guarantees ``n_{m_hi} ≥ total``, so K−1 kept history
    always covers the next chunk's windows — the former decrement-loop could
    undershoot the boundary (e.g. I=12, D=5, total=37), deferring a producible
    output past the kept history and making results CHUNK-DEPENDENT (round-5
    fast-chain A/B finding)."""
    if total <= 0:
        return 0
    return (interp * total - 1) // decim + 1


class FirFilter:
    """Plain FIR with per-call state carry (`futuredsp/fir.rs:31`).

    Implementation: explicit input history + direct ``np.convolve``.
    """

    def __init__(self, taps, dtype=None):
        self.taps = np.asarray(taps)
        self._hist: Optional[np.ndarray] = None

    @property
    def n_taps(self) -> int:
        return len(self.taps)

    def process(self, x: np.ndarray) -> np.ndarray:
        if len(x) == 0:
            return x
        nt = len(self.taps)
        # preserve the stream's item dtype (float32/complex64 streams stay narrow)
        out_dtype = x.dtype if x.dtype.kind in "fc" else \
            np.result_type(self.taps.dtype, x.dtype)
        if self._hist is None:
            self._hist = np.zeros(nt - 1, dtype=out_dtype)
        ext = np.concatenate([self._hist, x])
        if nt > 1:
            y = np.convolve(ext, self.taps)[nt - 1:nt - 1 + len(x)]
            self._hist = ext[len(ext) - (nt - 1):]
        else:
            y = ext * self.taps[0]
        return y.astype(out_dtype, copy=False)

    def reset(self):
        self._hist = None


class DecimatingFirFilter:
    """FIR + keep-every-Nth with phase carried across calls (`DecimatingFirFilter`)."""

    def __init__(self, taps, decim: int):
        self.fir = FirFilter(taps)
        self.decim = int(decim)
        self._phase = 0  # offset of next kept sample within the incoming filtered stream

    @property
    def n_taps(self) -> int:
        return self.fir.n_taps

    def process(self, x: np.ndarray) -> np.ndarray:
        y = self.fir.process(x)
        if len(y) == 0:
            return y[:0]
        out = y[self._phase::self.decim]
        taken = len(out)
        if taken:
            last = self._phase + (taken - 1) * self.decim
            self._phase = last + self.decim - len(y)
        else:
            self._phase -= len(y)
        return out

    def reset(self):
        self.fir.reset()
        self._phase = 0


class PolyphaseResamplingFir:
    """Rational interp/decim polyphase resampler (`polyphase_resampling_fir.rs:41`).

    Output ``y[m] = Σ_k h[k·I + p_m] · x[n_m − k]`` with ``p_m = (m·D) mod I``,
    ``n_m = (m·D) div I``. History and the absolute output counter are carried so frame
    boundaries are seamless.
    """

    def __init__(self, interp: int, decim: int, taps):
        from math import gcd
        g = gcd(int(interp), int(decim))
        self.interp = int(interp) // g
        self.decim = int(decim) // g
        self.taps = np.asarray(taps)
        # polyphase sub-filters, padded to equal length K
        L = len(self.taps)
        self.K = -(-L // self.interp)
        padded = np.zeros(self.K * self.interp, dtype=self.taps.dtype)
        padded[:L] = self.taps
        self.poly = padded.reshape(self.K, self.interp).T   # [interp, K]
        self._hist = None          # last K-1 input samples
        self._m = 0                # absolute output index
        self._consumed = 0         # absolute count of inputs fully behind history

    @property
    def n_taps(self) -> int:
        return len(self.taps)

    def process(self, x: np.ndarray) -> np.ndarray:
        if self._hist is None:
            self._hist = np.zeros(self.K - 1, dtype=np.result_type(self.taps.dtype, x.dtype))
            self._consumed = -(self.K - 1)   # history is virtual zero-padding
        buf = np.concatenate([self._hist, x])
        total = self._consumed + len(buf)     # inputs available: absolute indices < total
        # produce ALL m with n_m <= total - 1 (see poly_resample_m_hi for why
        # the closed form, and why the former decrement-loop was a
        # chunk-dependence bug)
        m_hi = poly_resample_m_hi(total, self.interp, self.decim)
        ms = np.arange(self._m, m_hi)
        if len(ms) == 0:
            out = np.zeros(0, dtype=buf.dtype)
        else:
            pos = (ms * self.decim) // self.interp - self._consumed   # index into buf
            phase = (ms * self.decim) % self.interp
            # gather K-sample windows ending at pos (reversed for dot with poly rows)
            idx = pos[:, None] - np.arange(self.K)[None, :]
            windows = np.where(idx >= 0, buf[np.clip(idx, 0, None)], 0)
            out = np.einsum("mk,mk->m", windows, self.poly[phase])
            self._m = m_hi
        # retain K-1 samples of history
        keep = min(self.K - 1, len(buf))
        self._hist = buf[len(buf) - keep:]
        self._consumed = total - keep
        return out.astype(buf.dtype, copy=False)

    def reset(self):
        self._hist = None
        self._m = 0
        self._consumed = 0


class IirFilter:
    """Direct-form IIR with carried state (`futuredsp` IirFilter)."""

    def __init__(self, b, a=(1.0,)):
        self.b = np.asarray(b, dtype=np.float64)
        self.a = np.asarray(a, dtype=np.float64)
        self._zi: Optional[np.ndarray] = None

    def process(self, x: np.ndarray) -> np.ndarray:
        if len(x) == 0:
            return x
        if self._zi is None:
            n = max(len(self.b), len(self.a)) - 1
            self._zi = np.zeros(n, dtype=np.result_type(x.dtype, np.float64))
        y, self._zi = lfilter(self.b, self.a, x, zi=self._zi)
        return y.astype(x.dtype, copy=False) if np.iscomplexobj(x) else y

    def reset(self):
        self._zi = None


class Rotator:
    """Oscillator-corrected complex rotator (`futuredsp` Rotator): multiplies by
    ``exp(j·(φ₀ + k·Δφ))``, renormalizing periodically to stop drift."""

    def __init__(self, phase_inc: float, phase: float = 0.0):
        self.phase_inc = float(phase_inc)
        self._phase = float(phase)

    def set_phase_inc(self, inc: float):
        self.phase_inc = float(inc)

    def process(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        if n == 0:
            return x
        ph = self._phase + self.phase_inc * np.arange(n)
        y = x * np.exp(1j * ph).astype(np.complex64 if x.dtype == np.complex64 else complex)
        self._phase = float((self._phase + self.phase_inc * n) % (2 * np.pi))
        return y.astype(x.dtype, copy=False)

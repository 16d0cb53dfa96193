"""DSP blocks on the CPU: filters, FFT, frequency translation, FM demod.

A reduced copy of ``futuresdr_tpu/blocks/dsp.py`` (reference:
``src/blocks/{fft.rs,fir.rs,xlating_fir.rs}``): ``Fir``/``FirBuilder``,
``Fft``, ``XlatingFir`` and ``QuadratureDemod``, the blocks of the apps'
CPU paths, on the stateful numpy cores of :mod:`futuresdr_tpu_torch.dsp.kernels`.
The device execution of the same chains lives in :mod:`futuresdr_tpu_torch.tpu`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..dsp import firdes
from ..dsp.kernels import (DecimatingFirFilter, FirFilter, PolyphaseResamplingFir,
                           Rotator)
from ..runtime.kernel import Kernel, message_handler
from ..runtime.tag import filter_tags
from ..types import Pmt

__all__ = ["Fir", "FirBuilder", "Fft", "XlatingFir", "QuadratureDemod"]


class Fir(Kernel):
    """FIR filter block (`fir.rs`), generic over the filter core: plain, decimating, or
    polyphase-resampling (pass ``decim``/``interp``). ``min_items`` is set from the tap
    count as in `fir.rs:49`."""

    def __init__(self, taps, dtype=np.float32, decim: int = 1, interp: int = 1,
                 tap_dtype=None):
        super().__init__()
        taps = np.asarray(taps, dtype=tap_dtype)
        if interp != 1:
            self.core = PolyphaseResamplingFir(interp, decim, taps)
        elif decim != 1:
            self.core = DecimatingFirFilter(taps, decim)
        else:
            self.core = FirFilter(taps)
        self.decim, self.interp = decim, interp
        self.input = self.add_stream_input("in", dtype, min_items=min(len(taps), 1 << 14))
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        if self.interp > 1:
            # the resampler emits up to (I·n−1)//D + 1 outputs for n inputs
            # (closed-form m_hi marginal); bound n so that never exceeds the
            # out window
            n_in = min(len(inp),
                       max(0, ((len(out) - 1) * self.decim + 1) // self.interp))
        else:
            # decimating/plain: ceil(n/decim) outputs for n inputs
            n_in = min(len(inp), len(out) * self.decim)
        if n_in > 0:
            y = self.core.process(inp[:n_in])
            if len(y) > len(out):
                raise RuntimeError("resampler produced more than negotiated")
            out[:len(y)] = y
            # tag transport with rate-change index remapping
            for t in filter_tags(self.input.tags(), n_in):
                self.output.add_tag(min(t.index * self.interp // self.decim,
                                        max(len(y) - 1, 0)), t.tag)
            self.input.consume(n_in)
            self.output.produce(len(y))
        # available() re-reads the buffer: the ring's slices stop at its wrap
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n_in > 0 and rest > 0:
            io.call_again = True


class FirBuilder:
    """Convenience constructors (`fir.rs` FirBuilder)."""

    @staticmethod
    def lowpass(cutoff: float, n_taps: int = 64, dtype=np.float32, **kw) -> Fir:
        return Fir(firdes.lowpass(cutoff, n_taps), dtype=dtype, **kw)

    @staticmethod
    def resampling(interp: int, decim: int, dtype=np.complex64,
                   atten_db: float = 60.0) -> Fir:
        """Rational resampler with auto-designed Kaiser lowpass (`FirBuilder::resampling`)."""
        from math import gcd
        g = gcd(interp, decim)
        interp, decim = interp // g, decim // g
        r = max(interp, decim)
        taps = firdes.kaiser_lowpass(0.5 / r * 0.8, 0.1 / r, atten_db) * interp
        return Fir(taps, dtype=dtype, decim=decim, interp=interp)

    @staticmethod
    def decimating(decim: int, cutoff: Optional[float] = None, n_taps: int = 64,
                   dtype=np.complex64) -> Fir:
        cutoff = cutoff if cutoff is not None else 0.4 / decim
        return Fir(firdes.lowpass(cutoff, n_taps), dtype=dtype, decim=decim)


class Fft(Kernel):
    """Frame-wise FFT (`fft.rs`): forward/inverse, optional fftshift and 1/√N
    normalization, runtime-switchable ``fft_size`` message port."""

    def __init__(self, fft_size: int = 2048, direction: str = "forward",
                 shift: bool = False, normalize: bool = False, dtype=np.complex64,
                 window=None):
        """``window``: optional name ("hann", "blackman", …) or array applied per
        frame before a forward FFT (spectral-leakage control for spectrum display)."""
        super().__init__()
        if direction not in ("forward", "inverse"):
            raise ValueError(f"direction {direction!r}: want 'forward' or 'inverse'")
        self.fft_size = int(fft_size)
        self.direction = direction
        self.shift = shift
        self.normalize = normalize
        if window is not None:
            from ..dsp.windows import get_window
            window = np.asarray(window) if not isinstance(window, str) \
                else get_window(window, self.fft_size)
            if len(window) != self.fft_size:
                raise ValueError(f"window of {len(window)} for fft_size {self.fft_size}")
        self.window = window
        self.input = self.add_stream_input("in", dtype, min_items=self.fft_size)
        self.output = self.add_stream_output("out", dtype, min_items=self.fft_size)

    @message_handler(name="fft_size")
    async def fft_size_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            new = p.to_int()
        except Exception:
            return Pmt.invalid_value()
        if new <= 0:
            return Pmt.invalid_value()
        cap = self.input.reader.capacity_items() if self.input.reader else None
        if cap is not None and new > cap // 2:
            return Pmt.invalid_value()    # would exceed the negotiated buffer window
        self.fft_size = new
        if self.window is not None and len(self.window) != new:
            self.window = None            # window length no longer matches; drop it
        return Pmt.ok()

    async def work(self, io, mio, meta):
        n = self.fft_size
        inp = self.input.slice()
        out = self.output.slice()
        k = min(len(inp) // n, len(out) // n)
        if k > 0:
            frames = inp[:k * n].reshape(k, n)
            if self.direction == "forward":
                if self.window is not None:
                    frames = frames * self.window[None, :]
                y = np.fft.fft(frames, axis=1)
            else:
                y = np.fft.ifft(frames, axis=1) * n   # match reference's unscaled inverse
            if self.normalize:
                y = y / np.sqrt(n)
            if self.shift:
                y = np.fft.fftshift(y, axes=1)
            out[:k * n] = y.reshape(-1).astype(out.dtype, copy=False)
            self.input.consume(k * n)
            self.output.produce(k * n)
        if self.input.finished() and self.input.available() < n:
            io.finished = True
        elif k > 0:
            io.call_again = True


class XlatingFir(Kernel):
    """Frequency-translating decimating FIR (`xlating_fir.rs`): rotate to baseband,
    lowpass, decimate — the front half of every receiver."""

    def __init__(self, taps, decim: int, offset_freq: float, sample_rate: float,
                 dtype=np.complex64):
        super().__init__()
        self.rotator = Rotator(-2.0 * np.pi * offset_freq / sample_rate)
        self.fir = DecimatingFirFilter(np.asarray(taps), decim)
        self.sample_rate = sample_rate
        self.input = self.add_stream_input("in", dtype, min_items=len(taps))
        self.output = self.add_stream_output("out", dtype)
        self.decim = decim

    @message_handler(name="freq")
    async def freq_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.rotator.set_phase_inc(-2.0 * np.pi * p.to_float() / self.sample_rate)
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n_in = min(len(inp), len(out) * self.decim)
        if n_in > 0:
            y = self.fir.process(self.rotator.process(inp[:n_in]))
            out[:len(y)] = y
            self.input.consume(n_in)
            self.output.produce(len(y))
        # available() re-reads the buffer: the ring's slices stop at its wrap
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n_in > 0 and rest > 0:
            io.call_again = True


class QuadratureDemod(Kernel):
    """FM quadrature demodulator: ``gain · arg(x[n] · conj(x[n-1]))`` (the reference
    builds this as an `Apply` in `examples/fm-receiver/src/main.rs:106-113`; it is a
    named block here because every analog receiver needs it)."""

    def __init__(self, gain: float = 1.0):
        super().__init__()
        self.gain = float(gain)
        self.input = self.add_stream_input("in", np.complex64, min_items=2)
        self.output = self.add_stream_output("out", np.float32)
        self._last = np.complex64(1.0)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n > 0:
            prev = np.concatenate(([self._last], inp[:n - 1]))
            out[:n] = self.gain * np.angle(inp[:n] * np.conj(prev))
            self._last = inp[n - 1]
            self.input.consume(n)
            self.output.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True

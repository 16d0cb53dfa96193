"""DSP blocks on the CPU: filters, FFT, NCO signal source, frequency
translation, FM demod, AGC and symbol timing recovery.

A copy of ``futuresdr_tpu/blocks/dsp.py`` (reference:
``src/blocks/{fft.rs,fir.rs,iir.rs,xlating_fir.rs,signal_source/,agc.rs}``) on
the stateful numpy cores of :mod:`futuresdr_tpu_torch.dsp.kernels`; the
Mueller-Müller loop of ``ClockRecoveryMm`` runs in the port's own host C++
(``csrc/host/mm.cpp``). The device execution of the same chains lives in
:mod:`futuresdr_tpu_torch.tpu`. The end-of-stream checks read
``available()``, since the pure-Python ring's slices stop at its wrap.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..dsp import firdes, fxpt
from ..dsp.kernels import (DecimatingFirFilter, FirFilter, IirFilter,
                           PolyphaseResamplingFir, Rotator)
from ..runtime.kernel import Kernel, message_handler
from ..runtime.tag import filter_tags
from ..types import Pmt


def _load_mm_native():
    """Bind the native MM work loop (``csrc/host/mm.cpp``, built on first use
    by ``ops/_build.load_host``); returns ``(lib, state_type)``, or None with
    ``FSDR_NO_NATIVE=1``, which runs the Python loop. A failed build raises
    with the compiler's output. The MM control loop is sequential per symbol:
    the reference runs it compiled (``clock_recovery_mm.rs``), and so does
    this, with the Python loop kept beside it as the twin it is held to."""
    if os.environ.get("FSDR_NO_NATIVE"):
        return None
    import ctypes

    from ..ops import _build

    class MmState(ctypes.Structure):
        _fields_ = [("omega", ctypes.c_double), ("omega0", ctypes.c_double),
                    ("mu", ctypes.c_double), ("last", ctypes.c_double),
                    ("last_d", ctypes.c_double), ("gain_omega", ctypes.c_double),
                    ("gain_mu", ctypes.c_double), ("limit", ctypes.c_double)]

    lib = _build.load_host("mm")
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fsdr_mm_work.restype = ctypes.c_int64
    lib.fsdr_mm_work.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                                 ctypes.POINTER(MmState), ctypes.POINTER(ctypes.c_int64)]
    return lib, MmState

__all__ = ["Fir", "FirBuilder", "Iir", "Fft", "XlatingFir", "SignalSource",
           "QuadratureDemod", "Agc", "ClockRecoveryMm"]


class ClockRecoveryMm(Kernel):
    """Mueller-Müller symbol timing recovery on a real-valued waveform.

    Library-block form of the ZigBee example's ``ClockRecoveryMm``
    (``examples/zigbee/src/clock_recovery_mm.rs``): emits one sample per recovered
    symbol; ``omega`` is the nominal samples/symbol, adapted within ``±limit``.

    The per-symbol adaptation is sequential by construction (each symbol's timing
    error steers the next sample position), so the hot loop runs as native C++
    (``csrc/host/mm.cpp``, bit-matched to the Python loop kept below, which
    runs with ``FSDR_NO_NATIVE=1``): the same answer the reference gives by
    being compiled Rust.
    """

    _native = None      # class-level cache: (lib, MmState) | False

    def __init__(self, omega: float, gain_omega: float = 0.25e-3,
                 mu: float = 0.5, gain_mu: float = 0.03, omega_limit: float = 0.05):
        super().__init__()
        self.omega0 = float(omega)
        self.omega = float(omega)
        self.gain_omega = gain_omega
        self.mu = mu
        self.gain_mu = gain_mu
        self.limit = omega_limit
        self._last = 0.0
        self._last_d = 0.0
        if ClockRecoveryMm._native is None:
            ClockRecoveryMm._native = _load_mm_native() or False
        self.input = self.add_stream_input("in", np.float32,
                                           min_items=int(np.ceil(omega)) + 2)
        self.output = self.add_stream_output("out", np.float32)

    def _work_native(self, inp: np.ndarray, out: np.ndarray) -> tuple:
        import ctypes
        lib, MmState = ClockRecoveryMm._native
        st = MmState(self.omega, self.omega0, self.mu, self._last, self._last_d,
                     self.gain_omega, self.gain_mu, self.limit)
        consumed = ctypes.c_int64(0)
        f32p = ctypes.POINTER(ctypes.c_float)
        inp = np.ascontiguousarray(inp)
        n_out = int(lib.fsdr_mm_work(
            inp.ctypes.data_as(f32p), len(inp), out.ctypes.data_as(f32p),
            len(out), ctypes.byref(st), ctypes.byref(consumed)))
        self.omega, self.mu = st.omega, st.mu
        self._last, self._last_d = st.last, st.last_d
        return consumed.value, n_out

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        # entry-omega window requirement — the SAME value the native loop derives
        # internally (mm.cpp computes it from st->omega before iterating), so the
        # finished check below agrees with where either loop actually stopped
        need = int(np.ceil(self.omega * (1 + self.limit))) + 2
        if ClockRecoveryMm._native:
            i, n_out = self._work_native(inp, out)
        else:
            n_out = 0
            i = 0
            while i + need < len(inp) and n_out < len(out):
                s = inp[i] * (1 - self.mu) + inp[i + 1] * self.mu
                d = 1.0 if s > 0 else -1.0
                err = self._last_d * s - d * self._last
                self._last, self._last_d = s, d
                out[n_out] = s
                n_out += 1
                self.omega += self.gain_omega * err
                self.omega = min(max(self.omega, self.omega0 * (1 - self.limit)),
                                 self.omega0 * (1 + self.limit))
                step = self.omega + self.gain_mu * err
                pos = i + self.mu + step
                i = int(pos)
                self.mu = pos - i
        if i > 0:
            self.input.consume(i)
        if n_out:
            self.output.produce(n_out)
        # available() re-reads the buffer: the ring's slices stop at its wrap
        if self.input.finished() and self.input.available() <= need:
            io.finished = True
        elif n_out and n_out == len(out):
            io.call_again = True


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


class Iir(Kernel):
    """IIR filter block (`iir.rs`)."""

    def __init__(self, b, a=(1.0,), dtype=np.float32):
        super().__init__()
        self.core = IirFilter(b, a)
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n > 0:
            out[:n] = self.core.process(inp[:n])
            self.input.consume(n)
            self.output.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True


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


class SignalSource(Kernel):
    """NCO signal source (`signal_source/`): sin/cos/complex-exponential/square at a
    given frequency, with ``freq``/``amplitude`` message ports.

    ``nco="fxpt"`` (the reference's `fxpt_phase.rs:11-19` semantics) keeps phase in
    a wrapping i32 — the increment is an exact integer, so the oscillator never
    accumulates floating-point phase drift over arbitrarily long runs (frequency
    quantized to fs/2^32). ``nco="float"`` is the plain float accumulator, kept for
    comparison; see ``dsp/fxpt.py`` for why the reference's sine LUT is not
    reproduced."""

    def __init__(self, waveform: str, frequency: float, sample_rate: float,
                 amplitude: float = 1.0, offset: float = 0.0, dtype=None,
                 nco: str = "fxpt"):
        super().__init__()
        if waveform not in ("sin", "cos", "complex", "square"):
            raise ValueError(f"waveform {waveform!r}: want sin, cos, complex or square")
        if nco not in ("fxpt", "float"):
            raise ValueError(f"nco {nco!r}: want 'fxpt' or 'float'")
        self.waveform = waveform
        self.sample_rate = float(sample_rate)
        self.amplitude = float(amplitude)
        self.offset = float(offset)
        self.nco = nco
        self._phase = 0.0
        self._inc = 2.0 * np.pi * frequency / sample_rate
        self._phase_i = 0                 # wrapping-i32 domain (nco="fxpt")
        self._inc_i = fxpt.FixedPointPhase.increment_for(frequency, sample_rate)
        if dtype is None:
            dtype = np.complex64 if waveform == "complex" else np.float32
        self.output = self.add_stream_output("out", dtype)

    @message_handler(name="freq")
    async def freq_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            f = p.to_float()
            self._inc = 2.0 * np.pi * f / self.sample_rate
            self._inc_i = fxpt.FixedPointPhase.increment_for(f, self.sample_rate)
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    @message_handler(name="amplitude")
    async def amplitude_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.amplitude = p.to_float()
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    async def work(self, io, mio, meta):
        out = self.output.slice()
        n = len(out)
        if n == 0:
            return
        if self.nco == "fxpt":
            ph = fxpt.i32_to_radians(fxpt.phase_ramp_i32(self._phase_i, self._inc_i, n))
            self._phase_i = fxpt.advance_u32(self._phase_i, self._inc_i, n)
        else:
            ph = self._phase + self._inc * np.arange(n)
            self._phase = float((self._phase + self._inc * n) % (2.0 * np.pi))
        if self.waveform == "sin":
            y = np.sin(ph)
        elif self.waveform == "cos":
            y = np.cos(ph)
        elif self.waveform == "square":
            y = np.sign(np.sin(ph))
        else:
            y = np.exp(1j * ph)
        out[:n] = (self.amplitude * y + self.offset).astype(out.dtype, copy=False)
        self.output.produce(n)
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


class Agc(Kernel):
    """Automatic gain control: exponential power tracking toward a reference level,
    with ``max_gain``/locking via message ports (reference `blocks/agc.rs`)."""

    def __init__(self, dtype=np.complex64, reference: float = 1.0,
                 adjustment_rate: float = 1e-3, max_gain: float = 65536.0,
                 mode: str = "sample"):
        """``mode``: "sample" = per-sample feedback exactly as the reference;
        "block" = vectorized block-floating gain (64-sample control granularity,
        ~50× faster on long streams — the CPU twin of ``ops.agc_stage``)."""
        super().__init__()
        self.reference = float(reference)
        self.rate = float(adjustment_rate)
        self.max_gain = float(max_gain)
        self.gain = 1.0
        self.locked = False
        if mode not in ("sample", "block"):
            raise ValueError(f"mode {mode!r}: want 'sample' or 'block'")
        self.mode = mode
        self.block = 64
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)

    @message_handler(name="gain_lock")
    async def gain_lock_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.locked = bool(p.to_bool() if p.kind.name == "BOOL" else p.to_int())
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    @message_handler(name="reference_power")
    async def reference_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.reference = p.to_float()
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if self.mode == "block" and n >= self.block:
            n -= n % self.block
        if n > 0:
            x = inp[:n]
            if self.locked:
                out[:n] = self.gain * x
            elif self.mode == "block" and n >= self.block:
                mags = np.abs(x).reshape(-1, self.block).mean(axis=1)
                gains = np.empty(len(mags), dtype=np.float64)
                g = self.gain
                r, rate, mg = self.reference, self.rate * self.block, self.max_gain
                for i, m in enumerate(mags):     # short loop: one step per block
                    gains[i] = g
                    g = min(max(g + rate * (r - m * g), 0.0), mg)
                self.gain = g
                out[:n] = (np.repeat(gains, self.block) * x).astype(out.dtype,
                                                                    copy=False)
            else:
                mag = np.abs(x)
                gains = np.empty(n, dtype=np.float64)
                g = self.gain
                r, rate, mg = self.reference, self.rate, self.max_gain
                for i in range(n):          # sequential feedback loop
                    gains[i] = g
                    err = r - mag[i] * g
                    g = min(max(g + rate * err, 0.0), mg)
                self.gain = g
                out[:n] = (gains * x).astype(out.dtype, copy=False)
            self.input.consume(n)
            self.output.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True

"""The PFB channelizer as a host block, and its default prototype.

A copy of ``futuresdr_tpu/blocks/pfb.py`` (``pfb_default_taps``,
``PfbChannelizer``, ``PfbSynthesizer``, ``PfbArbResampler``). The channelizer
is the critically sampled polyphase analysis bank: commutated branch filters
(``scipy.signal.lfilter``, batched over branches), then the IFFT across
branches; the synthesizer is its inverse, N channels into one stream. Channel ``c`` carries the band centred at
``c/N`` of the input rate, each output at ``fs/N``. The device form is
``ops/stages.channelizer_stage``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.signal import lfilter

from ..dsp import firdes
from ..dsp.windows import kaiser
from ..runtime.kernel import Kernel

__all__ = ["PfbChannelizer", "PfbSynthesizer", "PfbArbResampler", "pfb_default_taps"]


def pfb_default_taps(n_channels: int, taps_per_branch: int = 12,
                     atten_db: float = 70.0) -> np.ndarray:
    """Prototype lowpass for an N-channel bank (liquid's Kaiser default):
    ``N·taps_per_branch`` taps, cutoff ``0.5/N``, gain N."""
    n = n_channels * taps_per_branch
    _, beta = firdes.kaiser_order(atten_db, 0.1 / n_channels)
    return firdes.lowpass(0.5 / n_channels, n, kaiser(n, beta)) * n_channels


class PfbChannelizer(Kernel):
    """1 → N channel analysis bank, critically sampled: input ``in``, outputs
    ``out0`` … ``out{N-1}``."""

    def __init__(self, n_channels: int, taps=None):
        super().__init__()
        if n_channels < 2:
            raise ValueError(f"PfbChannelizer needs >= 2 channels, got {n_channels}")
        self.n = int(n_channels)
        taps = np.asarray(taps if taps is not None else pfb_default_taps(self.n),
                          dtype=np.float32)
        # branch p holds taps[p::N]; pad so all branches have equal length
        k = -(-len(taps) // self.n)
        padded = np.zeros(k * self.n, dtype=np.float64)
        padded[:len(taps)] = taps
        self.branch_taps = padded.reshape(k, self.n).T      # [N, K]
        self._zi = np.zeros((self.n, k - 1), dtype=np.complex128) if k > 1 else None
        self.input = self.add_stream_input("in", np.complex64, min_items=self.n)
        self.outputs = [self.add_stream_output(f"out{i}", np.complex64)
                        for i in range(self.n)]

    def _filter(self, blocks: np.ndarray) -> np.ndarray:
        """``[t, N]`` input blocks → ``[N, t]`` channel outputs."""
        u = blocks[:, ::-1].T                               # [N, t] commutator
        if self._zi is None:
            v = self.branch_taps[:, :1] * u
        else:
            v = np.empty(u.shape, dtype=np.complex128)
            for p in range(self.n):                         # batched short filters
                v[p], self._zi[p] = lfilter(self.branch_taps[p], 1.0, u[p],
                                            zi=self._zi[p])
        return np.fft.ifft(v, axis=0) * self.n

    async def work(self, io, mio, meta):
        # the ring's slices stop at its wrap: take whole blocks until the input
        # or an output runs out, so EOS never leaves items past the wrap behind
        while True:
            inp = self.input.slice()
            t = min([len(inp) // self.n] + [len(o.slice()) for o in self.outputs])
            if t == 0:
                break
            y = self._filter(inp[:t * self.n].reshape(t, self.n))
            for c, o in enumerate(self.outputs):
                o.slice()[:t] = y[c].astype(np.complex64)
                o.produce(t)
            self.input.consume(t * self.n)
        if self.input.finished() and self.input.available() < self.n:
            io.finished = True


class PfbSynthesizer(Kernel):
    """N → 1 synthesis bank (`pfb/synthesizer.rs`): FFT across channels + commutated
    branch filters, critically sampled."""

    def __init__(self, n_channels: int, taps=None):
        super().__init__()
        self.n = int(n_channels)
        taps = np.asarray(taps if taps is not None else pfb_default_taps(self.n),
                          dtype=np.float32)
        k = -(-len(taps) // self.n)
        padded = np.zeros(k * self.n, dtype=np.float64)
        padded[:len(taps)] = taps
        self.branch_taps = padded.reshape(k, self.n).T
        self._zi = np.zeros((self.n, k - 1), dtype=np.complex128) if k > 1 else None
        self.inputs = [self.add_stream_input(f"in{i}", np.complex64)
                       for i in range(self.n)]
        self.output = self.add_stream_output("out", np.complex64, min_items=self.n)

    async def work(self, io, mio, meta):
        # slice lengths, not available(): the ring's slices stop at its wrap
        t = min(min(len(p.slice()) for p in self.inputs),
                len(self.output.slice()) // self.n)
        if t > 0:
            x = np.stack([p.slice()[:t] for p in self.inputs])   # [N, t]
            v = np.fft.fft(x, axis=0)                            # [N, t]
            if self._zi is not None:
                w = np.empty((self.n, t), dtype=np.complex128)
                for p in range(self.n):
                    w[p], self._zi[p] = lfilter(self.branch_taps[p], 1.0, v[p],
                                                zi=self._zi[p])
            else:
                w = self.branch_taps[:, :1] * v
            out = self.output.slice()
            out[:t * self.n] = w.T.reshape(-1).astype(np.complex64)
            for p in self.inputs:
                p.consume(t)
            self.output.produce(t * self.n)
        if any(p.finished() and p.available() == 0 for p in self.inputs):
            io.finished = True
        elif t > 0 and all(p.available() for p in self.inputs):
            io.call_again = True


class PfbArbResampler(Kernel):
    """Arbitrary-rate polyphase resampler (`pfb/arb_resampler.rs`): an M-branch bank
    stepped fractionally, with linear interpolation between adjacent branches
    (the reference's ``PfbArbResampler``, its arithmetic unchanged)."""

    def __init__(self, rate: float, taps=None, n_filters: int = 32, dtype=np.complex64):
        super().__init__()
        if not rate > 0:
            raise ValueError(f"PfbArbResampler needs a rate > 0, got {rate}")
        self.rate = float(rate)
        self.M = int(n_filters)
        taps = np.asarray(taps if taps is not None else
                          firdes.lowpass(min(0.5, 0.5 * min(1.0, rate)) / self.M * 0.8,
                                         8 * self.M) * self.M,
                          dtype=np.float64)
        k = -(-len(taps) // self.M)
        padded = np.zeros(k * self.M, dtype=taps.dtype)
        padded[:len(taps)] = taps
        self.poly = padded.reshape(k, self.M).T       # [M, K]
        self.K = k
        self._hist: Optional[np.ndarray] = None
        self._m = 0                                    # absolute output index
        self._consumed = 0
        self.input = self.add_stream_input("in", dtype, min_items=self.K)
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        # bound inputs so outputs fit: n_out ≈ n_in * rate
        n_in = min(len(inp), max(0, int(len(out) / self.rate) - 2))
        if n_in > 0:
            y = self._process(inp[:n_in])
            assert len(y) <= len(out)
            out[:len(y)] = y
            self.input.consume(n_in)
            self.output.produce(len(y))
        if self.input.finished() and n_in == len(inp):
            io.finished = True
        elif n_in > 0 and n_in < len(inp):
            io.call_again = True

    def _process(self, x: np.ndarray) -> np.ndarray:
        if self._hist is None:
            self._hist = np.zeros(self.K - 1, dtype=x.dtype)
            self._consumed = -(self.K - 1)
        buf = np.concatenate([self._hist, x])
        total = self._consumed + len(buf)
        # outputs m with floor(m/rate) <= total - 2 (need n_m+ for interp)
        m_hi = int(np.floor((total - 1) * self.rate))
        ms = np.arange(self._m, max(self._m, m_hi))
        if len(ms):
            pos = ms / self.rate
            n_m = np.floor(pos).astype(np.int64)
            frac = (pos - n_m) * self.M
            p_m = np.floor(frac).astype(np.int64)
            alpha = (frac - p_m)[:, None]
            idx = (n_m - self._consumed)[:, None] - np.arange(self.K)[None, :]
            windows = np.where(idx >= 0, buf[np.clip(idx, 0, None)], 0)
            y0 = np.einsum("mk,mk->m", windows, self.poly[p_m])
            p1 = (p_m + 1) % self.M
            shift = (p_m + 1) // self.M                # branch wrap advances one sample
            idx1 = (n_m + shift - self._consumed)[:, None] - np.arange(self.K)[None, :]
            in_range = (idx1 >= 0) & (idx1 < len(buf))
            w1 = np.where(in_range, buf[np.clip(idx1, 0, len(buf) - 1)], 0)
            y1 = np.einsum("mk,mk->m", w1, self.poly[p1])
            y = ((1 - alpha[:, 0]) * y0 + alpha[:, 0] * y1).astype(x.dtype, copy=False)
            self._m = ms[-1] + 1
        else:
            y = np.zeros(0, dtype=x.dtype)
        keep = min(self.K - 1 + 1, len(buf))
        self._hist = buf[len(buf) - keep:]
        self._consumed = total - keep
        return y

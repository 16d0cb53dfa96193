"""The PFB channelizer as a host block, and its default prototype.

A copy of ``futuresdr_tpu/blocks/pfb.py`` (``pfb_default_taps``,
``PfbChannelizer``; the synthesizer and the arbitrary resampler are not
ported). The channelizer is the critically sampled polyphase analysis bank:
commutated branch filters (``scipy.signal.lfilter``, batched over branches),
then the IFFT across branches. Channel ``c`` carries the band centred at
``c/N`` of the input rate, each output at ``fs/N``. The device form is
``ops/stages.channelizer_stage``.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

from ..dsp import firdes
from ..dsp.windows import kaiser
from ..runtime.kernel import Kernel

__all__ = ["PfbChannelizer", "pfb_default_taps"]


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

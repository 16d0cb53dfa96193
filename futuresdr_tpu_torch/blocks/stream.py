"""Stream utility blocks: ``Head``, ``MovingAvg`` and ``StreamDeinterleaver``
(copies of ``futuresdr_tpu/blocks/stream.py``)."""

from __future__ import annotations

import numpy as np

from ..runtime.kernel import Kernel

__all__ = ["Head", "MovingAvg", "StreamDeinterleaver"]


class Head(Kernel):
    """Pass n items then finish."""

    def __init__(self, dtype, n: int):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self.remaining = int(n)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out), self.remaining)
        if n > 0:
            out[:n] = inp[:n]
            self.input.consume(n)
            self.output.produce(n)
            self.remaining -= n
        # available() re-reads the ring: its slices stop at the wrap
        if self.remaining == 0 or (self.input.finished() and self.input.available() == 0):
            io.finished = True
        elif n > 0:
            io.call_again = True


class StreamDeinterleaver(Kernel):
    """Round-robin deinterleave to N outputs: item ``i`` goes to output
    ``i mod N`` (``out0`` … ``out{N-1}``)."""

    def __init__(self, dtype, n_outputs: int = 2):
        super().__init__()
        self.n = int(n_outputs)
        # min_items = N: the ring's capacity is then a multiple of N, so its
        # wrap never splits a group of N
        self.input = self.add_stream_input("in", dtype, min_items=self.n)
        self.outputs = [self.add_stream_output(f"out{i}", dtype) for i in range(self.n)]

    async def work(self, io, mio, meta):
        # drain: the ring's slices stop at its wrap, so EOS is honoured only
        # once fewer than N items are left
        while True:
            inp = self.input.slice()
            k = min([len(inp) // self.n] + [len(o.slice()) for o in self.outputs])
            if k == 0:
                break
            frame = inp[:k * self.n].reshape(k, self.n)
            for i, o in enumerate(self.outputs):
                o.slice()[:k] = frame[:, i]
                o.produce(k)
            self.input.consume(k * self.n)
        if self.input.finished() and self.input.available() < self.n:
            io.finished = True


class MovingAvg(Kernel):
    """Width-N sliding sum/average over interleaved frames (`moving_avg.rs`).

    Averages ``width`` consecutive frames of length ``frame_len`` (e.g. FFT rows) with
    exponential decay, emitting one averaged frame every ``width`` inputs.
    """

    def __init__(self, frame_len: int, width: int = 3, decay: float = 0.1, dtype=np.float32):
        super().__init__()
        self.input = self.add_stream_input("in", dtype, min_items=frame_len)
        self.output = self.add_stream_output("out", dtype, min_items=frame_len)
        self.frame_len = frame_len
        self.width = width
        self.decay = decay
        self._acc = np.zeros(frame_len, dtype=np.float64)
        self._count = 0

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        progressed = True
        while progressed:
            progressed = False
            if len(inp) >= self.frame_len:
                frame = inp[:self.frame_len]
                self._acc = self._acc * (1.0 - self.decay) + frame * self.decay
                self._count += 1
                self.input.consume(self.frame_len)
                inp = self.input.slice()
                if self._count >= self.width and len(out) >= self.frame_len:
                    out[:self.frame_len] = self._acc
                    self.output.produce(self.frame_len)
                    out = self.output.slice()
                    self._count = 0
                progressed = True
        if self.input.finished() and len(inp) < self.frame_len:
            io.finished = True

"""Vector / null sources and sinks — the test and bench workhorses.

A copy of ``futuresdr_tpu/blocks/vector.py`` (``CopyRand`` left out).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..runtime.kernel import Kernel

__all__ = ["VectorSource", "VectorSink", "NullSource", "NullSink"]


class VectorSource(Kernel):
    """Emit a fixed vector (optionally repeated), then EOS."""

    def __init__(self, items, dtype=None, repeat: int = 1):
        super().__init__()
        self.items = np.asarray(items, dtype=dtype)
        self.repeat = repeat
        self._pos = 0
        self._round = 0
        self.output = self.add_stream_output("out", self.items.dtype)

    async def work(self, io, mio, meta):
        out = self.output.slice()
        n = len(out)
        produced = 0
        while produced < n:
            if self._round >= self.repeat:
                break
            take = min(n - produced, len(self.items) - self._pos)
            out[produced:produced + take] = self.items[self._pos:self._pos + take]
            produced += take
            self._pos += take
            if self._pos == len(self.items):
                self._pos = 0
                self._round += 1
        if produced:
            self.output.produce(produced)
        if self._round >= self.repeat:
            io.finished = True
        elif produced > 0:
            io.call_again = True  # progress made; more space may exist past the wrap


class VectorSink(Kernel):
    """Collect everything; final state readable after ``run``."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self._chunks: List[np.ndarray] = []

    async def work(self, io, mio, meta):
        # the ring's slices stop at its wrap: drain until nothing is left, so
        # EOS never leaves the items past the wrap behind
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            self._chunks.append(inp.copy())
            self.input.consume(len(inp))
        if finished:
            io.finished = True

    def items(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, dtype=self.input.dtype)
        return np.concatenate(self._chunks)


class NullSource(Kernel):
    """Zeros forever."""

    def __init__(self, dtype):
        super().__init__()
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        n = self.output.space()
        if n:
            # buffer is zero-initialized; producing without writing is the fast path
            self.output.produce(n)
            io.call_again = True
        # n == 0: park until a reader consumes (its consume() notifies this block)


class NullSink(Kernel):
    """Count-and-drop; with ``count`` it finishes after n items."""

    def __init__(self, dtype, count: Optional[int] = None):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.count = count
        self.n_received = 0

    async def work(self, io, mio, meta):
        # the ring's slices stop at its wrap: drain until nothing is left.
        # EOS and the last items can arrive in one wake; consuming one slice
        # then left the items past the wrap behind, and with the writer done
        # no wake came again (the streamed runtime's stall).
        finished = self.input.finished()
        while True:
            n = self.input.available()
            if not n:
                break
            self.input.consume(n)
            self.n_received += n
        if finished or (self.count is not None and self.n_received >= self.count):
            io.finished = True

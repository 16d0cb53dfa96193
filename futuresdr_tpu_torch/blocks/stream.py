"""Stream utility blocks: ``Head`` (a copy of ``futuresdr_tpu/blocks/stream.py:Head``)."""

from __future__ import annotations

from ..runtime.kernel import Kernel

__all__ = ["Head"]


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

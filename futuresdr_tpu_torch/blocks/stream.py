"""Stream utility blocks: ``Head`` and ``StreamDeinterleaver`` (copies of
``futuresdr_tpu/blocks/stream.py``)."""

from __future__ import annotations

from ..runtime.kernel import Kernel

__all__ = ["Head", "StreamDeinterleaver"]


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

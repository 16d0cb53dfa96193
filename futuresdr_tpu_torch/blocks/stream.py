"""Stream utility blocks: ``Copy``, ``Head``, ``Throttle``, ``MovingAvg``,
``TagDebug``, ``Delay``, ``StreamDuplicator``, ``StreamDeinterleaver`` and
``Selector`` (copies of ``futuresdr_tpu/blocks/stream.py``; reference:
``src/blocks/{copy,head,throttle,moving_avg,tag_debug,delay,stream_duplicator,
stream_deinterleaver,selector}.rs``).

The end-of-stream checks read ``available()`` after consuming, where the
reference compares with the slice it read: the pure-Python ring's slices stop
at its wrap, so a slice may hold less than the buffer does.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional

import numpy as np

from ..log import logger
from ..runtime.kernel import Kernel, message_handler
from ..runtime.tag import filter_tags
from ..types import Pmt

__all__ = ["Copy", "Head", "Throttle", "MovingAvg", "TagDebug", "Delay",
           "StreamDuplicator", "StreamDeinterleaver", "Selector"]

log = logger("blocks.stream")


class Copy(Kernel):
    """Pass-through (`copy.rs`)."""

    def __init__(self, dtype):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n > 0:
            out[:n] = inp[:n]
            for t in filter_tags(self.input.tags(), n):
                self.output.add_tag(t.index, t.tag)
            self.input.consume(n)
            self.output.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True


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


class Throttle(Kernel):
    """Rate-limit by wall clock (`throttle.rs:92-94`: re-arms with a timer
    through ``io.block_on``)."""

    def __init__(self, dtype, rate: float):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self.rate = float(rate)
        self._t0: Optional[float] = None
        self._sent = 0

    @message_handler
    async def rate_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.rate = p.to_float()
            self._t0 = None
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()

    async def work(self, io, mio, meta):
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
            self._sent = 0
        budget = int((now - self._t0) * self.rate) - self._sent
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out), max(budget, 0))
        if n > 0:
            out[:n] = inp[:n]
            self.input.consume(n)
            self.output.produce(n)
            self._sent += n
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
            return
        if rest > 0 and len(self.output.slice()) > 0:
            if n > 0 and n == len(inp):
                io.call_again = True      # the slice stopped at the ring's wrap
            else:
                # starved by the rate limit, not by data: park on a timer
                io.block_on(asyncio.sleep(0.1))


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


class TagDebug(Kernel):
    """Log tags passing by (`tag_debug.rs`)."""

    def __init__(self, dtype, name: str = "tag_debug"):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self.name = name
        self.seen: List = []

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n > 0:
            for t in filter_tags(self.input.tags(), n):
                log.info("[%s] tag @%d: %r", self.name, t.index, t.tag)
                self.seen.append(t)
                self.output.add_tag(t.index, t.tag)
            out[:n] = inp[:n]
            self.input.consume(n)
            self.output.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True


class Delay(Kernel):
    """Delay the stream by n items, zero-padding the front (`delay.rs` Pad/Copy state
    machine); negative n skips items. Runtime-adjustable via the ``new_value`` handler."""

    def __init__(self, dtype, n: int):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)
        self._pad = max(n, 0)
        self._skip = max(-n, 0)

    @message_handler(name="new_value")
    async def new_value(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            n = p.to_int()
        except Exception:
            return Pmt.invalid_value()
        if n >= 0:
            self._pad += n
        else:
            self._skip += -n
        return Pmt.ok()

    async def work(self, io, mio, meta):
        out = self.output.slice()
        if self._pad and len(out):
            k = min(self._pad, len(out))
            out[:k] = 0
            self.output.produce(k)
            self._pad -= k
            out = self.output.slice()
        inp = self.input.slice()
        if self._skip and len(inp):
            k = min(self._skip, len(inp))
            self.input.consume(k)
            self._skip -= k
            inp = self.input.slice()
        n = min(len(inp), len(out))
        if n > 0:
            out[:n] = inp[:n]
            self.input.consume(n)
            self.output.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0 and self._pad == 0:
            io.finished = True
        elif (n > 0 or self._skip) and rest > 0:
            io.call_again = True


class StreamDuplicator(Kernel):
    """1→N duplicate (`stream_duplicator.rs`)."""

    def __init__(self, dtype, n_outputs: int = 2):
        super().__init__()
        self.input = self.add_stream_input("in", dtype)
        self.outputs = [self.add_stream_output(f"out{i}", dtype) for i in range(n_outputs)]

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = min([len(inp)] + [len(o.slice()) for o in self.outputs])
        if n > 0:
            for o in self.outputs:
                o.slice()[:n] = inp[:n]
                o.produce(n)
            self.input.consume(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
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


class Selector(Kernel):
    """N×M switch (`selector.rs:10-107`): route input ``input_index`` → output
    ``output_index``; both switchable via message handlers; non-selected inputs follow the
    drop policy ("drop_all" | "same_rate" | "no_drop")."""

    def __init__(self, dtype, n_inputs: int, n_outputs: int, drop_policy: str = "drop_all"):
        super().__init__()
        if drop_policy not in ("drop_all", "same_rate", "no_drop"):
            raise ValueError(f"drop_policy {drop_policy!r}: want 'drop_all', "
                             f"'same_rate' or 'no_drop'")
        self.inputs = [self.add_stream_input(f"in{i}", dtype) for i in range(n_inputs)]
        self.outputs = [self.add_stream_output(f"out{i}", dtype) for i in range(n_outputs)]
        self.input_index = 0
        self.output_index = 0
        self.drop_policy = drop_policy

    @message_handler(name="input_index")
    async def input_index_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.input_index = p.to_int() % len(self.inputs)
        except Exception:
            return Pmt.invalid_value()
        return Pmt.usize(self.input_index)

    @message_handler(name="output_index")
    async def output_index_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        try:
            self.output_index = p.to_int() % len(self.outputs)
        except Exception:
            return Pmt.invalid_value()
        return Pmt.usize(self.output_index)

    async def work(self, io, mio, meta):
        sel_in = self.inputs[self.input_index]
        sel_out = self.outputs[self.output_index]
        inp = sel_in.slice()
        out = sel_out.slice()
        n = min(len(inp), len(out))
        if n > 0:
            out[:n] = inp[:n]
            sel_in.consume(n)
            sel_out.produce(n)
        if self.drop_policy == "drop_all":
            for i, p in enumerate(self.inputs):
                if i != self.input_index:
                    p.consume(p.available())
        elif self.drop_policy == "same_rate":
            for i, p in enumerate(self.inputs):
                if i != self.input_index:
                    p.consume(min(n, p.available()))
        rest = sel_in.available()
        if sel_in.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True

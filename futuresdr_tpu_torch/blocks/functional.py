"""Functional blocks: closures over sample streams.

A copy of ``futuresdr_tpu/blocks/functional.py`` (reference:
``src/blocks/{apply,combine,filter,split,source,sink,finite_source,apply_nm,
apply_into_iter}.rs``). The closures are vectorized: they take and return
numpy arrays over the whole work window, not one sample at a time. The
end-of-stream checks read ``available()``, since the pure-Python ring's slices
stop at its wrap.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..runtime.kernel import Kernel
from ..runtime.tag import filter_tags

__all__ = ["Apply", "Combine", "Filter", "Split", "Source", "FiniteSource", "Sink",
           "ApplyNM", "ApplyIntoIter"]


class Apply(Kernel):
    """1:1 map over a stream (`apply.rs:99-128`): ``out[i] = f(in[i])``, vectorized.

    ``f(x: ndarray) -> ndarray`` must return the same length.
    """

    def __init__(self, f: Callable[[np.ndarray], np.ndarray], in_dtype, out_dtype=None):
        super().__init__()
        self.f = f
        self.input = self.add_stream_input("in", in_dtype)
        self.output = self.add_stream_output("out", out_dtype if out_dtype is not None else in_dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))
        if n > 0:
            out[:n] = self.f(inp[:n])
            for t in filter_tags(self.input.tags(), n):
                self.output.add_tag(t.index, t.tag)
            self.input.consume(n)
            self.output.produce(n)
        # available() re-reads the buffer: the ring's slices stop at its wrap
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True


class Combine(Kernel):
    """2→1 zip (`combine.rs`): ``out[i] = f(a[i], b[i])``, vectorized."""

    def __init__(self, f: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 a_dtype, b_dtype=None, out_dtype=None):
        super().__init__()
        self.f = f
        self.in0 = self.add_stream_input("in0", a_dtype)
        self.in1 = self.add_stream_input("in1", b_dtype if b_dtype is not None else a_dtype)
        self.output = self.add_stream_output(
            "out", out_dtype if out_dtype is not None else a_dtype)

    async def work(self, io, mio, meta):
        a = self.in0.slice()
        b = self.in1.slice()
        out = self.output.slice()
        n = min(len(a), len(b), len(out))
        if n > 0:
            out[:n] = self.f(a[:n], b[:n])
            self.in0.consume(n)
            self.in1.consume(n)
            self.output.produce(n)
        if (self.in0.finished() and self.in0.available() == 0) or \
                (self.in1.finished() and self.in1.available() == 0):
            io.finished = True
        elif n > 0:
            io.call_again = True


class Filter(Kernel):
    """Keep items where the predicate holds (`filter.rs`): ``f(x) -> bool mask``."""

    def __init__(self, f: Callable[[np.ndarray], np.ndarray], dtype):
        super().__init__()
        self.f = f
        self.input = self.add_stream_input("in", dtype)
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        n = min(len(inp), len(out))  # worst case: everything passes
        if n > 0:
            kept = inp[:n][np.asarray(self.f(inp[:n]), dtype=bool)]
            out[:len(kept)] = kept
            self.input.consume(n)
            self.output.produce(len(kept))
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True


class Split(Kernel):
    """1→2 unzip (`split.rs`): ``f(x) -> (a, b)`` of equal length."""

    def __init__(self, f: Callable, in_dtype, out0_dtype=None, out1_dtype=None):
        super().__init__()
        self.f = f
        self.input = self.add_stream_input("in", in_dtype)
        self.out0 = self.add_stream_output(
            "out0", out0_dtype if out0_dtype is not None else in_dtype)
        self.out1 = self.add_stream_output(
            "out1", out1_dtype if out1_dtype is not None else in_dtype)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        o0 = self.out0.slice()
        o1 = self.out1.slice()
        n = min(len(inp), len(o0), len(o1))
        if n > 0:
            a, b = self.f(inp[:n])
            o0[:n] = a
            o1[:n] = b
            self.input.consume(n)
            self.out0.produce(n)
            self.out1.produce(n)
        rest = self.input.available()
        if self.input.finished() and rest == 0:
            io.finished = True
        elif n > 0 and rest > 0:
            io.call_again = True


class Source(Kernel):
    """Infinite source (`source.rs`): ``f(n) -> ndarray`` fills up to n items per call."""

    def __init__(self, f: Callable[[int], np.ndarray], dtype):
        super().__init__()
        self.f = f
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        out = self.output.slice()
        n = len(out)
        if n > 0:
            data = np.asarray(self.f(n))
            k = min(len(data), n)
            out[:k] = data[:k]
            self.output.produce(k)
            if k > 0:
                io.call_again = True


class FiniteSource(Kernel):
    """Source that ends (`finite_source.rs`): ``f(n) -> ndarray | None`` (None = EOS)."""

    def __init__(self, f: Callable[[int], Optional[np.ndarray]], dtype):
        super().__init__()
        self.f = f
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        out = self.output.slice()
        n = len(out)
        if n == 0:
            return
        data = self.f(n)
        if data is None:
            io.finished = True
            return
        data = np.asarray(data)
        k = min(len(data), n)
        out[:k] = data[:k]
        self.output.produce(k)
        if k > 0:
            io.call_again = True


class Sink(Kernel):
    """Terminal consumer (`sink.rs`): ``f(chunk)`` per work window."""

    def __init__(self, f: Callable[[np.ndarray], None], dtype):
        super().__init__()
        self.f = f
        self.input = self.add_stream_input("in", dtype)

    async def work(self, io, mio, meta):
        # drain: the ring's slices stop at its wrap, so EOS must not leave
        # the items past the wrap behind
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            self.f(inp)
            self.input.consume(len(inp))
        if finished:
            io.finished = True


class ApplyNM(Kernel):
    """Fixed N:M rate map (`apply_nm.rs`): ``f`` maps k·N input items to k·M output items.

    ``f(x: ndarray[k*N]) -> ndarray[k*M]`` — called with a whole number of N-blocks.
    """

    def __init__(self, f: Callable[[np.ndarray], np.ndarray], n: int, m: int,
                 in_dtype, out_dtype=None):
        super().__init__()
        self.f = f
        self.n = n
        self.m = m
        # min_items = N (and M): the ring's capacity is then a multiple of
        # them, so its wrap never splits a block
        self.input = self.add_stream_input("in", in_dtype, min_items=n)
        self.output = self.add_stream_output(
            "out", out_dtype if out_dtype is not None else in_dtype, min_items=m)

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        out = self.output.slice()
        k = min(len(inp) // self.n, len(out) // self.m)
        if k > 0:
            out[:k * self.m] = self.f(inp[:k * self.n])
            for t in filter_tags(self.input.tags(), k * self.n):
                self.output.add_tag(t.index * self.m // self.n, t.tag)
            self.input.consume(k * self.n)
            self.output.produce(k * self.m)
        if self.input.finished() and self.input.available() < self.n:
            io.finished = True
        elif k > 0:
            io.call_again = True


class ApplyIntoIter(Kernel):
    """1→many expansion (`apply_into_iter.rs`): ``f(x: ndarray) -> ndarray`` of any length.

    Consumes the whole window, buffering overflow output internally.
    """

    def __init__(self, f: Callable[[np.ndarray], np.ndarray], in_dtype, out_dtype=None):
        super().__init__()
        self.f = f
        self.input = self.add_stream_input("in", in_dtype)
        self.output = self.add_stream_output(
            "out", out_dtype if out_dtype is not None else in_dtype)
        self._carry: Optional[np.ndarray] = None

    async def work(self, io, mio, meta):
        progressed = 0
        out = self.output.slice()
        if self._carry is not None and len(out):
            k = min(len(self._carry), len(out))
            out[:k] = self._carry[:k]
            self.output.produce(k)
            self._carry = self._carry[k:] if k < len(self._carry) else None
            progressed += k
            out = self.output.slice()
        if self._carry is None:
            inp = self.input.slice()
            if len(inp):
                data = np.asarray(self.f(inp))
                self.input.consume(len(inp))
                progressed += len(inp)
                k = min(len(data), len(out))
                out[:k] = data[:k]
                self.output.produce(k)
                if k < len(data):
                    self._carry = data[k:].copy()
        if self._carry is not None:
            if progressed:
                io.call_again = True
            # else: park; downstream consume() notifies this block
        elif self.input.finished() and self.input.available() == 0:
            io.finished = True
        elif progressed and self.input.available():
            io.call_again = True          # the slice stopped at the ring's wrap

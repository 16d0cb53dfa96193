"""Functional blocks: ``Apply`` (a copy of ``futuresdr_tpu/blocks/functional.py``)."""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..runtime.kernel import Kernel
from ..runtime.tag import filter_tags

__all__ = ["Apply"]


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

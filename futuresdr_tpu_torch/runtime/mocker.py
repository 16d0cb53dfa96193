"""Mocker: run a single block without runtime or scheduler.

A copy of ``futuresdr_tpu/runtime/mocker.py``, a re-design of ``src/runtime/mocker.rs:33-393``: vec-backed mock reader/writer ports, direct
handler invocation, a ``run()`` that loops ``work()`` until ``!call_again``, and capture of
posted messages. This is the unit-test and micro-bench harness (``tests/mocker.rs``,
``benches/apply.rs``).
"""

from __future__ import annotations

import asyncio
from typing import List, Sequence, Tuple

import numpy as np

from ..types import Pmt
from .buffer import BufferReader, BufferWriter
from .inbox import BlockInbox, Call
from .kernel import Kernel
from .tag import ItemTag
from .work_io import WorkIo

__all__ = ["Mocker"]


class _MockReader(BufferReader):
    """Vec-backed reader (`mocker.rs:195-289`)."""

    def __init__(self, data: np.ndarray, tags: Sequence[ItemTag] = ()):
        self._data = data
        self._pos = 0
        self._tags: List[ItemTag] = list(tags)

    def slice(self) -> np.ndarray:
        return self._data[self._pos:]

    def tags(self) -> List[ItemTag]:
        return [ItemTag(t.index - self._pos, t.tag) for t in self._tags
                if t.index >= self._pos]

    def consume(self, n: int) -> None:
        self._pos += n

    def notify_finished(self) -> None:
        pass


class _MockWriter(BufferWriter):
    """Vec-backed writer capturing produced items + tags (`mocker.rs:291-393`)."""

    def __init__(self, dtype, capacity: int):
        self._data = np.zeros(capacity, dtype=dtype)
        self._pos = 0
        self.tags: List[ItemTag] = []

    def add_reader(self, reader_inbox, port_index):
        raise NotImplementedError("mock writer has no readers")

    def slice(self) -> np.ndarray:
        return self._data[self._pos:]

    def produce(self, n: int, tags: Sequence[ItemTag] = ()) -> None:
        self.tags.extend(ItemTag(self._pos + t.index, t.tag) for t in tags)
        self._pos += n

    def notify_finished(self) -> None:
        pass

    def produced(self) -> np.ndarray:
        return self._data[:self._pos]


class _CaptureInbox(BlockInbox):
    """Message sink capturing `mio.post` fan-out."""

    def __init__(self, record: List[Tuple[str, Pmt]], port: str):
        super().__init__(capacity=1 << 30)
        self._record = record
        self._port = port

    def send(self, msg) -> None:
        if isinstance(msg, Call):
            self._record.append((self._port, msg.data))


class Mocker:
    """Test harness for one block (`mocker.rs:33-191`).

    Usage::

        m = Mocker(block)
        m.input("in", np.arange(128, dtype=np.float32))
        m.init_output("out", 128)
        m.init(); m.run(); m.deinit()
        out = m.output("out")
    """

    def __init__(self, kernel: Kernel):
        self.kernel = kernel
        self.io = WorkIo()
        self.messages: List[Tuple[str, Pmt]] = []
        for name in kernel.mio.names:
            kernel.mio.connect(name, _CaptureInbox(self.messages, name), "capture")

    # -- port setup ------------------------------------------------------------
    def input(self, port, data: np.ndarray, tags: Sequence[ItemTag] = ()) -> None:
        p = self.kernel.stream_input(port)
        arr = np.ascontiguousarray(data, dtype=p.dtype)
        p.reader = _MockReader(arr, tags)

    def input_finished(self, port) -> None:
        self.kernel.stream_input(port).set_finished()

    def init_output(self, port, capacity_items: int) -> None:
        p = self.kernel.stream_output(port)
        p.writer = _MockWriter(p.dtype, capacity_items)

    def output(self, port) -> np.ndarray:
        return self.kernel.stream_output(port).writer.produced()

    def output_tags(self, port) -> List[ItemTag]:
        return list(self.kernel.stream_output(port).writer.tags)

    # -- lifecycle -------------------------------------------------------------
    def init(self) -> None:
        asyncio.run(self.kernel.init(self.kernel.mio, self.kernel.meta))

    def deinit(self) -> None:
        asyncio.run(self.kernel.deinit(self.kernel.mio, self.kernel.meta))

    def run(self, max_iters: int = 1_000_000) -> None:
        """Loop ``work()`` until it stops requesting ``call_again`` (`mocker.rs:117-160`)."""

        async def go():
            self.io.call_again = True
            iters = 0
            while self.io.call_again and not self.io.finished:
                self.io.reset()
                await self.kernel.work(self.io, self.kernel.mio, self.kernel.meta)
                iters += 1
                if iters >= max_iters:
                    raise RuntimeError("Mocker.run exceeded max_iters")

        asyncio.run(go())

    def post(self, handler, data: Pmt = None) -> Pmt:
        """Invoke a message handler directly (`mocker.rs:96-115`)."""
        data = Pmt.from_py(data) if not isinstance(data, Pmt) else data

        async def go():
            return await self.kernel.call_handler(self.io, self.kernel.meta, handler, data)

        return asyncio.run(go())

    @property
    def finished(self) -> bool:
        return self.io.finished

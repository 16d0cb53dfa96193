"""Portable CPU ring buffer: single writer, N broadcast readers, wrap-capped
slices. A copy of ``futuresdr_tpu/runtime/buffer/ring.py``.

Wake protocol: ``produce`` notifies every reader's block, ``consume``
notifies the writer's block; EOS travels through block inboxes as
StreamInputDone/StreamOutputDone.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np

from ..inbox import BlockInbox, StreamInputDone, StreamOutputDone
from ..tag import ItemTag
from . import BufferReader, BufferWriter

__all__ = ["RingWriter", "RingReader"]


class _ReaderState:
    __slots__ = ("pos", "tags", "inbox", "port_index", "detached")

    def __init__(self, pos: int, inbox: BlockInbox, port_index: int):
        self.pos = pos              # absolute read position (monotonic item counter)
        self.tags: List[ItemTag] = []   # absolute indices
        self.inbox = inbox
        self.port_index = port_index
        self.detached = False       # reader finished; ignore for space accounting


class RingWriter(BufferWriter):
    def __init__(self, dtype, capacity: int, writer_inbox: BlockInbox,
                 writer_port_index: int = 0):
        self.dtype = np.dtype(dtype)
        self.capacity = int(capacity)
        self._data = np.zeros(self.capacity, dtype=self.dtype)
        self._wpos = 0              # absolute write position
        self._readers: List[_ReaderState] = []
        self._lock = threading.Lock()
        self._inbox = writer_inbox
        self._port_index = writer_port_index
        self._finished = False

    # -- connect ---------------------------------------------------------------
    def add_reader(self, reader_inbox: BlockInbox, port_index: int) -> "RingReader":
        with self._lock:
            st = _ReaderState(self._wpos, reader_inbox, port_index)
            self._readers.append(st)
        return RingReader(self, st)

    # -- writer side -----------------------------------------------------------
    def _space(self) -> int:
        live = [r.pos for r in self._readers if not r.detached]
        if not live:
            return self.capacity
        return self.capacity - (self._wpos - min(live))

    def slice(self) -> np.ndarray:
        with self._lock:
            space = self._space()
            off = self._wpos % self.capacity
            n = min(space, self.capacity - off)
            return self._data[off:off + n]

    def produce(self, n: int, tags: Sequence[ItemTag] = ()) -> None:
        if n == 0:
            return
        with self._lock:
            base = self._wpos
            self._wpos += n
            for r in self._readers:
                if not r.detached and tags:
                    r.tags.extend(ItemTag(base + t.index, t.tag) for t in tags)
            readers = [r.inbox for r in self._readers if not r.detached]
        for ib in readers:
            ib.notify()

    def notify_finished(self) -> None:
        """EOS downstream: StreamInputDone into every reader block inbox."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            readers = [(r.inbox, r.port_index) for r in self._readers if not r.detached]
        for ib, pidx in readers:
            ib.send(StreamInputDone(pidx))

    # -- reader callbacks ------------------------------------------------------
    def _reader_slice(self, st: _ReaderState) -> np.ndarray:
        with self._lock:
            avail = self._wpos - st.pos
            off = st.pos % self.capacity
            n = min(avail, self.capacity - off)
            return self._data[off:off + n]

    def _reader_tags(self, st: _ReaderState) -> List[ItemTag]:
        with self._lock:
            return [ItemTag(t.index - st.pos, t.tag) for t in st.tags if t.index >= st.pos]

    def _reader_consume(self, st: _ReaderState, n: int) -> None:
        if n == 0:
            return
        with self._lock:
            if n > self._wpos - st.pos:
                raise ValueError("consumed more than available")
            st.pos += n
            st.tags = [t for t in st.tags if t.index >= st.pos]
        self._inbox.notify()  # space freed → wake writer block

    def _reader_finished(self, st: _ReaderState) -> None:
        """EOS upstream: detach reader, StreamOutputDone to writer."""
        with self._lock:
            if st.detached:
                return
            st.detached = True
            st.tags.clear()
        self._inbox.send(StreamOutputDone(self._port_index))


class RingReader(BufferReader):
    def __init__(self, writer: RingWriter, state: _ReaderState):
        self._writer = writer
        self._state = state
        self.port_index = state.port_index

    def slice(self) -> np.ndarray:
        return self._writer._reader_slice(self._state)

    def tags(self) -> List[ItemTag]:
        return self._writer._reader_tags(self._state)

    def consume(self, n: int) -> None:
        self._writer._reader_consume(self._state, n)

    def notify_finished(self) -> None:
        self._writer._reader_finished(self._state)

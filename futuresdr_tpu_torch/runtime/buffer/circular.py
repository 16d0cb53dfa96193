"""The default stream buffer: a double-mapped circular buffer with lock-free indices.

A copy of ``futuresdr_tpu/runtime/buffer/circular.py`` over the port's own
``csrc/host/ringbuf.cpp``: a memfd-backed region mapped twice back to back,
so every read and write window is contiguous wherever the wrap falls (work
windows never split, unlike the pure-Python :mod:`.ring`). The index
arithmetic (produce, consume, space, available) is C++ atomics.

The library builds with ``g++`` on first use (``ops/_build.py``
``load_host``) and is bound through :class:`ctypes.PyDLL`: its calls are a
few atomic loads and stores, so they keep the interpreter lock instead of
giving it up and waiting to take it back from the other blocks' threads.
Where the library cannot build, :func:`available` is False and the flowgraph
falls back to the pure-Python ring with a warning.
"""

from __future__ import annotations

import ctypes
import math
import mmap
import threading
from typing import List, Optional, Sequence

import numpy as np

from ...log import logger
from ..inbox import BlockInbox, StreamInputDone, StreamOutputDone
from ..tag import ItemTag
from . import BufferReader, BufferWriter

__all__ = ["CircularWriter", "CircularReader", "available", "load_native"]

log = logger("buffer.circular")

_lib = None
_failed: Optional[str] = None
_lock = threading.Lock()

_VP, _U64, _SZ, _INT = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t, ctypes.c_int
_SIGNATURES = {
    "fsdr_dbuf_create": (_VP, [_SZ]),
    "fsdr_dbuf_destroy": (None, [_VP]),
    "fsdr_dbuf_ptr": (_VP, [_VP]),
    "fsdr_dbuf_size": (_SZ, [_VP]),
    "fsdr_ring_create": (_VP, [_U64]),
    "fsdr_ring_destroy": (None, [_VP]),
    "fsdr_ring_add_reader": (_INT, [_VP]),
    "fsdr_ring_remove_reader": (None, [_VP, _INT]),
    "fsdr_ring_wpos": (_U64, [_VP]),
    "fsdr_ring_space": (_U64, [_VP]),
    "fsdr_ring_rpos": (_U64, [_VP, _INT]),
    "fsdr_ring_available": (_U64, [_VP, _INT]),
    "fsdr_ring_produce": (None, [_VP, _U64]),
    "fsdr_ring_consume": (None, [_VP, _INT, _U64]),
}


def load_native() -> Optional[ctypes.PyDLL]:
    """The ring library, built on first use; None (with one warning) where it
    cannot build or load."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        from ...ops import _build
        try:
            lib = _build.load_host("ringbuf")
        except (OSError, RuntimeError) as e:
            _failed = repr(e)
            log.warning("the circular buffer's library did not build (%s): "
                        "stream edges use the pure-Python ring", _failed)
            return None
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return _lib


def available() -> bool:
    return load_native() is not None


class _Mapping:
    """Owns one double-mapped region, unmapped once no view of it is left."""

    def __init__(self, lib, size_bytes: int):
        self._lib = lib
        self.handle = lib.fsdr_dbuf_create(size_bytes)
        if not self.handle:
            raise MemoryError(f"fsdr_dbuf_create({size_bytes}) failed")
        self.size = lib.fsdr_dbuf_size(self.handle)

    def array(self) -> np.ndarray:
        """Both mappings as one uint8 array; it and its views keep the
        region mapped."""
        raw = (ctypes.c_uint8 * (2 * self.size)).from_address(
            self._lib.fsdr_dbuf_ptr(self.handle))
        raw._mapping = self
        return np.frombuffer(raw, dtype=np.uint8)

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.fsdr_dbuf_destroy(self.handle)
            self.handle = None


class CircularWriter(BufferWriter):
    """1 writer → N broadcast readers over a double-mapped region. The
    capacity is the requested one rounded up so that the region is a whole
    number of pages and of items (the two mappings then alias item for
    item)."""

    def __init__(self, dtype, capacity: int, writer_inbox: BlockInbox,
                 writer_port_index: int = 0):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"the circular buffer's library is unavailable: {_failed}")
        self._lib = lib
        self.dtype = np.dtype(dtype)
        unit = math.lcm(mmap.PAGESIZE, self.dtype.itemsize)
        want = max(1, int(capacity)) * self.dtype.itemsize
        self._map = _Mapping(lib, -(-want // unit) * unit)
        if self._map.size % self.dtype.itemsize:
            raise RuntimeError(f"double-mapped region of {self._map.size} bytes is not "
                               f"a whole number of {self.dtype.itemsize}-byte items")
        self.capacity = self._map.size // self.dtype.itemsize
        # a view over both mappings: items [i] and [i + capacity] alias
        self._data = self._map.array().view(self.dtype)
        self._ring = lib.fsdr_ring_create(self.capacity)
        self._readers: List["_ReaderState"] = []
        self._inbox = writer_inbox
        self._port_index = writer_port_index
        self._finished = False
        # per-reader tag lists live in Python (control plane, low rate)
        self._tag_lock = threading.Lock()

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.fsdr_ring_destroy(self._ring)
            self._ring = None

    # -- connect ---------------------------------------------------------------
    def add_reader(self, reader_inbox: BlockInbox, port_index: int) -> "CircularReader":
        idx = self._lib.fsdr_ring_add_reader(self._ring)
        if idx < 0:
            raise RuntimeError("too many readers on one circular buffer (16, "
                               "FSDR_MAX_READERS in csrc/host/ringbuf.cpp)")
        st = _ReaderState(idx, reader_inbox, port_index)
        self._readers.append(st)
        return CircularReader(self, st)

    # -- writer side -----------------------------------------------------------
    def slice(self) -> np.ndarray:
        space = self._lib.fsdr_ring_space(self._ring)
        off = self._lib.fsdr_ring_wpos(self._ring) % self.capacity
        return self._data[off:off + space]   # contiguous thanks to the double mapping

    def space_available(self) -> int:
        return int(self._lib.fsdr_ring_space(self._ring))

    def produce(self, n: int, tags: Sequence[ItemTag] = ()) -> None:
        if n == 0:
            return
        if tags:
            base = self._lib.fsdr_ring_wpos(self._ring)
            with self._tag_lock:
                for st in self._readers:
                    if not st.detached:
                        st.tags.extend(ItemTag(base + t.index, t.tag) for t in tags)
        self._lib.fsdr_ring_produce(self._ring, n)
        for st in self._readers:
            if not st.detached:
                st.inbox.notify()

    def notify_finished(self) -> None:
        """EOS downstream: StreamInputDone into every reader block's inbox."""
        if self._finished:
            return
        self._finished = True
        for st in self._readers:
            if not st.detached:
                st.inbox.send(StreamInputDone(st.port_index))


class _ReaderState:
    """One reader's slot in the native ring and its tags (absolute indices);
    the writer keeps these, not the readers, so neither refers back to the
    other and both go with their last reference."""

    __slots__ = ("idx", "inbox", "port_index", "tags", "detached")

    def __init__(self, idx: int, inbox: BlockInbox, port_index: int):
        self.idx = idx
        self.inbox = inbox
        self.port_index = port_index
        self.tags: List[ItemTag] = []
        self.detached = False


class CircularReader(BufferReader):
    def __init__(self, writer: CircularWriter, state: _ReaderState):
        self._w = writer
        self._st = state
        self.port_index = state.port_index

    def slice(self) -> np.ndarray:
        w, idx = self._w, self._st.idx
        avail = w._lib.fsdr_ring_available(w._ring, idx)
        off = w._lib.fsdr_ring_rpos(w._ring, idx) % w.capacity
        return w._data[off:off + avail]

    def items_available(self) -> int:
        return int(self._w._lib.fsdr_ring_available(self._w._ring, self._st.idx))

    def capacity_items(self) -> int:
        return self._w.capacity

    def tags(self) -> List[ItemTag]:
        w, st = self._w, self._st
        pos = w._lib.fsdr_ring_rpos(w._ring, st.idx)
        with w._tag_lock:
            return [ItemTag(t.index - pos, t.tag) for t in st.tags if t.index >= pos]

    def consume(self, n: int) -> None:
        if n == 0:
            return
        w, st = self._w, self._st
        if n > w._lib.fsdr_ring_available(w._ring, st.idx):
            raise ValueError("consumed more than available")
        w._lib.fsdr_ring_consume(w._ring, st.idx, n)
        if st.tags:
            pos = w._lib.fsdr_ring_rpos(w._ring, st.idx)
            with w._tag_lock:
                st.tags = [t for t in st.tags if t.index >= pos]
        w._inbox.notify()   # space freed → wake the writer block

    def notify_finished(self) -> None:
        """EOS upstream: detach, and StreamOutputDone to the writer."""
        w, st = self._w, self._st
        if st.detached:
            return
        st.detached = True
        w._lib.fsdr_ring_remove_reader(w._ring, st.idx)
        w._inbox.send(StreamOutputDone(w._port_index))

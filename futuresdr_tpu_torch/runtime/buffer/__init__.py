"""Buffer layer — the stream data plane between blocks.

A reduced copy of ``futuresdr_tpu/runtime/buffer/__init__.py``: writers and
readers move items through a buffer with broadcast (1 writer → N readers),
capacity negotiated at connect time, tag transport with index rebasing, and
EOS propagated through block inboxes. Two backends: the double-mapped
circular buffer (:mod:`.circular`, the default, as in the reference), whose
windows never split at the wrap, and the pure-Python ring (:mod:`.ring`),
whose slices stop at the wrap.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import List, Optional, Sequence, Type

import numpy as np

from ...config import config
from ..tag import ItemTag, Tag

__all__ = ["BufferReader", "BufferWriter", "StreamInput", "StreamOutput",
           "negotiate_capacity"]


class BufferReader(ABC):
    """Reader endpoint of one connection."""

    #: index of the input port on the consuming block (for StreamInputDone routing)
    port_index: int = 0

    @abstractmethod
    def slice(self) -> np.ndarray:
        """Readable view of available items."""

    @abstractmethod
    def tags(self) -> List[ItemTag]:
        """Tags in the currently readable window, indices relative to the read position."""

    @abstractmethod
    def consume(self, n: int) -> None:
        """Advance the read position; wakes the upstream writer block."""

    @abstractmethod
    def notify_finished(self) -> None:
        """Reader's block finished: tell the upstream writer."""

    def items_available(self) -> int:
        return len(self.slice())

    def capacity_items(self) -> Optional[int]:
        """The buffer's capacity in items."""
        return None


class BufferWriter(ABC):
    """Writer endpoint owning the storage; broadcasts to N readers."""

    @abstractmethod
    def add_reader(self, reader_inbox, port_index: int) -> BufferReader:
        """Connect one more reader."""

    @abstractmethod
    def slice(self) -> np.ndarray:
        """Writable view of free space."""

    @abstractmethod
    def produce(self, n: int, tags: Sequence[ItemTag] = ()) -> None:
        """Commit n written items (+ tags indexed relative to the write window); wakes readers."""

    @abstractmethod
    def notify_finished(self) -> None:
        """Writer's block finished: send StreamInputDone to every reader."""

    def space_available(self) -> int:
        return len(self.slice())


def negotiate_capacity(itemsize: int, min_items_constraints: Sequence[int],
                       min_buffer_sizes: Sequence[int],
                       override_bytes: Optional[int] = None) -> int:
    """Capacity in items = max(the byte budget (``override_bytes`` where
    given, a port's preference, else config ``buffer_size``), explicit byte
    minimums, 2× the largest ``min_items`` so a full work window always
    fits), rounded up to a power of two and then to a multiple of the
    largest ``min_items``. The ring's slices stop at its wrap, so a reader
    that consumes whole windows of ``min_items`` always sees whole windows
    only when they tile the ring (the reference's default double-mapped
    buffer has no wrap to respect)."""
    if override_bytes is not None and override_bytes <= 0:
        raise ValueError(f"buffer size override must be positive, got {override_bytes}")
    budget = override_bytes if override_bytes is not None else config().buffer_size
    items = max(1, budget // itemsize)
    for b in min_buffer_sizes:
        if b:
            items = max(items, math.ceil(b / itemsize))
    window = max([m for m in min_items_constraints if m] or [1])
    items = max(items, 2 * window)
    cap = 1 << (items - 1).bit_length()
    return -(-cap // window) * window


class StreamOutput:
    """Output port facade declared by a block. ``buffer`` is the writer
    class this port wants (an edge's own ``buffer`` wins over it, and it over
    :func:`~..flowgraph.default_buffer`); ``preferred_buffer_size`` is the
    byte budget it would like, weighed with its readers' preferences."""

    def __init__(self, name: str, dtype, min_items: int = 1, min_buffer_size: int = 0,
                 buffer: Optional[Type] = None,
                 preferred_buffer_size: Optional[int] = None):
        self.name = name
        self.dtype = np.dtype(dtype) if dtype is not None else None
        self.min_items = min_items
        self.min_buffer_size = min_buffer_size
        self.buffer = buffer
        self.preferred_buffer_size = preferred_buffer_size
        self.writer: Optional[BufferWriter] = None
        self._pending_tags: List[ItemTag] = []
        self.items_produced = 0       # metrics: items out
        self.stalls = 0               # parks while this output's buffer was full

    def slice(self) -> np.ndarray:
        return self.writer.slice()

    def space(self) -> int:
        return self.writer.space_available()

    def add_tag(self, index: int, tag: Tag) -> None:
        """Attach ``tag`` to item ``index`` of the next ``produce`` window."""
        self._pending_tags.append(ItemTag(index, tag))

    def produce(self, n: int) -> None:
        tags, self._pending_tags = self._pending_tags, []
        self.items_produced += n
        self.writer.produce(n, tags)

    def notify_finished(self) -> None:
        if self.writer is not None:
            self.writer.notify_finished()

    @property
    def connected(self) -> bool:
        return self.writer is not None


class StreamInput:
    """Input port facade declared by a block."""

    def __init__(self, name: str, dtype, min_items: int = 1,
                 preferred_buffer_size: Optional[int] = None):
        self.name = name
        self.dtype = np.dtype(dtype) if dtype is not None else None
        self.min_items = min_items
        self.preferred_buffer_size = preferred_buffer_size
        self.reader: Optional[BufferReader] = None
        self._finished = False        # StreamInputDone received (upstream writer done)
        self.items_consumed = 0       # metrics: items in
        self.starved = 0              # parks while this input held < min_items

    def slice(self) -> np.ndarray:
        return self.reader.slice()

    def available(self) -> int:
        return self.reader.items_available()

    def tags(self, n: Optional[int] = None) -> List[ItemTag]:
        ts = self.reader.tags()
        return ts if n is None else [t for t in ts if t.index < n]

    def consume(self, n: int) -> None:
        self.items_consumed += n
        self.reader.consume(n)

    def fill(self) -> Optional[float]:
        """Buffer occupancy in [0, 1], or None without a known capacity."""
        if self.reader is None:
            return None
        cap = self.reader.capacity_items()
        if not cap:
            return None
        return min(1.0, self.reader.items_available() / cap)

    def finished(self) -> bool:
        """Upstream signalled EOS; buffered data may remain."""
        return self._finished

    def set_finished(self) -> None:
        self._finished = True

    def notify_finished(self) -> None:
        if self.reader is not None:
            self.reader.notify_finished()

    @property
    def connected(self) -> bool:
        return self.reader is not None

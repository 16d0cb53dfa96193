"""In-place (circuit) ports: queues of whole frames between blocks.

A copy of ``futuresdr_tpu/runtime/buffer/circuit.py`` (reference:
``src/runtime/buffer/circuit.rs``). An output pushes whole frames (with their
valid item count and frame-relative tags) into the queue of every connected
input, and the inbox wake-ups go both ways (a pushed frame wakes the
consumer, a taken frame wakes the producer, whose in-flight gate reads
:meth:`InplaceOutput.queue_depth`). Two kinds of frame travel this way:

* **Host frames**, numpy arrays out of a :class:`Circuit` pool: the source
  pops an empty frame, fills it and pushes it; the blocks after it mutate it
  in place and forward it; the last one returns it to the pool, which wakes
  the source (``Flowgraph.close_circuit``), so no item is copied end to end.
  A mutable frame has one reader: an output that would broadcast a writable
  host frame raises.
* **Device frames**, tensors of the device-frame plane (``tpu/frames.py``).
  Every frame-plane block is blocking and runs on a thread of its own, each
  thread issuing work on its current CUDA stream. :meth:`InplaceOutput.put_full`
  records a CUDA event on the producer's stream after the work that wrote the
  frame, and :meth:`InplaceInput.get_full` makes the reader's stream wait on
  it and records the frame on the reader's stream (``Tensor.record_stream``),
  so the caching allocator does not hand the frame's memory out again while
  the reader's work on it is still queued. CPU frames carry no event. No
  stage writes its input in place (``ops/stages.py``), so an output wired to
  several inputs broadcasts the same device frame to every queue.

Backpressure is the slowest consumer's.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inbox import BlockInbox, StreamInputDone

__all__ = ["Circuit", "InplaceOutput", "InplaceInput"]


class Circuit:
    """The pool of host frames of one circuit (``n_buffers`` frames of
    ``items_per_buffer`` items): a source takes an empty frame with
    :meth:`get_empty` and the last block returns it with :meth:`put_empty`,
    which wakes the source."""

    def __init__(self, n_buffers: int, items_per_buffer: int, dtype):
        self.dtype = np.dtype(dtype)
        self.items = items_per_buffer
        self._lock = threading.Lock()
        self._empty: Deque[np.ndarray] = deque(
            np.zeros(items_per_buffer, self.dtype) for _ in range(n_buffers))
        self._source_inbox: Optional[BlockInbox] = None

    def attach_source(self, inbox: BlockInbox) -> None:
        self._source_inbox = inbox

    def get_empty(self) -> Optional[np.ndarray]:
        with self._lock:
            return self._empty.popleft() if self._empty else None

    def put_empty(self, buf: np.ndarray) -> None:
        """Return a frame to the pool (the closing edge of the circuit)."""
        with self._lock:
            self._empty.append(buf)
        if self._source_inbox is not None:
            self._source_inbox.notify()


class InplaceOutput:
    """Output port pushing full frames to the connected input(s).
    Duck-types enough of :class:`StreamOutput` to live in a kernel's port
    list (its metrics counters, ``connected``, ``notify_finished``)."""

    def __init__(self, name: str, dtype=None):
        self.name = name
        self.dtype = np.dtype(dtype) if dtype is not None else None
        self.min_items = 1
        self.items_produced = 0
        self.stalls = 0
        self._peers: list = []
        self._finished = False

    @property
    def connected(self) -> bool:
        return bool(self._peers)

    def connect(self, peer: "InplaceInput") -> None:
        # idempotent: a re-run of the same flowgraph materializes its edges again
        if not any(p is peer for p in self._peers):
            self._peers.append(peer)

    def put_full(self, frame, n_items: int, tags: Sequence = ()) -> None:
        """Push ``frame`` (``n_items`` of it valid, ``tags`` indexed within
        it) to every connected input, with an event recorded after the
        producer's work on a device frame. A writable host frame has one
        reader: broadcasting it raises."""
        if isinstance(frame, np.ndarray):
            if len(self._peers) > 1 and frame.flags.writeable:
                raise RuntimeError(
                    f"inplace output {self.name!r} broadcasts to {len(self._peers)} "
                    f"consumers, but the frame is a writable host array: mutable "
                    f"circuit frames must stay single-reader")
            self.items_produced += int(n_items)
            for p in self._peers:
                p.push(frame, None, n_items, tags)
            return
        ready = None
        if frame.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(frame.device))
        self.items_produced += int(n_items)
        for p in self._peers:
            p.push(frame, ready, n_items, tags)

    def queue_depth(self) -> int:
        """Frames waiting at the slowest consumer (the backpressure signal)."""
        return max((len(p) for p in self._peers), default=0)

    def notify_finished(self) -> None:
        if self._peers and not self._finished:
            self._finished = True
            for p in self._peers:
                p.mark_finished()


class InplaceInput:
    """Input port receiving full frames. Duck-types
    :class:`StreamInput`'s event-loop surface (``reader``, ``finished``,
    ``set_finished``, ``notify_finished``)."""

    def __init__(self, name: str, dtype=None):
        self.name = name
        self.dtype = np.dtype(dtype) if dtype is not None else None
        self.min_items = 1
        self.items_consumed = 0
        self.starved = 0
        self._q: Deque[Tuple[torch.Tensor, Optional[object], int, tuple]] = deque()
        self._lock = threading.Lock()
        self._inbox: Optional[BlockInbox] = None
        self._producer_inbox: Optional[BlockInbox] = None
        self._port_index = 0
        self._finished = False

    @property
    def reader(self):
        return self._inbox          # bound once connected (validate_ports reads it)

    @property
    def connected(self) -> bool:
        return self._inbox is not None

    def set_finished(self) -> None:
        self._finished = True

    def finished(self) -> bool:
        return self._finished

    def notify_finished(self) -> None:
        pass                        # no upstream space accounting

    def bind(self, inbox: BlockInbox, port_index: int) -> None:
        self._inbox = inbox
        self._port_index = port_index

    def bind_producer(self, inbox: BlockInbox) -> None:
        """Wake the producing block when frames are taken."""
        self._producer_inbox = inbox

    def push(self, frame, ready, n_items: int, tags: Sequence = ()) -> None:
        with self._lock:
            self._q.append((frame, ready, int(n_items), tuple(tags)))
        if self._inbox is not None:
            self._inbox.notify()

    def get_full(self) -> Optional[Tuple[object, int, tuple]]:
        """The oldest frame as ``(frame, valid, tags)`` (a device frame
        ordered after its producer's work on the calling thread's current
        stream); None when the queue is empty."""
        with self._lock:
            item = self._q.popleft() if self._q else None
        if item is None:
            return None
        frame, ready, n, tags = item
        if ready is not None:
            cur = torch.cuda.current_stream(frame.device)
            cur.wait_event(ready)
            frame.record_stream(cur)
        self.items_consumed += n
        if self._producer_inbox is not None:
            self._producer_inbox.notify()
        return frame, n, tags

    def __len__(self):
        return len(self._q)

    def mark_finished(self) -> None:
        if self._inbox is not None:
            self._inbox.send(StreamInputDone(self._port_index))

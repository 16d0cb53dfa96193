"""In-place (circuit) ports: queues of device frames between frame-plane blocks.

A reduced copy of ``futuresdr_tpu/runtime/buffer/circuit.py``: what the
device-frame plane (``tpu/frames.py``) needs, an output that pushes whole
device frames (with their valid item count and frame-relative tags) into the
queue of every connected input, and the inbox wake-ups both ways (a pushed
frame wakes the consumer, a taken frame wakes the producer, whose in-flight
gate reads :meth:`InplaceOutput.queue_depth`). The reference's host-frame
``Circuit`` pool (mutating CPU blocks that return frames to their source) is
ROADMAP Queue 1 item 4b.

A device frame crosses threads here: every frame-plane block is blocking and
runs on a thread of its own, each thread issuing work on its current CUDA
stream. :meth:`InplaceOutput.put_full` records a CUDA event on the
producer's stream after the work that wrote the frame, and
:meth:`InplaceInput.get_full` makes the reader's stream wait on it and
records the frame on the reader's stream (``Tensor.record_stream``), so the
caching allocator does not hand the frame's memory out again while the
reader's work on it is still queued. CPU frames carry no event.

An output wired to several inputs broadcasts: every queue receives the same
frame object. No stage writes its input in place (``ops/stages.py``), so the
branches may share it. Backpressure is the slowest consumer's.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inbox import BlockInbox, StreamInputDone

__all__ = ["InplaceOutput", "InplaceInput"]


class InplaceOutput:
    """Output port pushing full device frames to the connected input(s).
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

    def put_full(self, frame: torch.Tensor, n_items: int, tags: Sequence = ()) -> None:
        """Push ``frame`` (``n_items`` of it valid, ``tags`` indexed within
        it) to every connected input, with an event recorded after the
        producer's work on it."""
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
    """Input port receiving full device frames. Duck-types
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

    def push(self, frame: torch.Tensor, ready, n_items: int, tags: Sequence = ()) -> None:
        with self._lock:
            self._q.append((frame, ready, int(n_items), tuple(tags)))
        if self._inbox is not None:
            self._inbox.notify()

    def get_full(self) -> Optional[Tuple[torch.Tensor, int, tuple]]:
        """The oldest frame as ``(frame, valid, tags)``, ordered after its
        producer's work on the calling thread's current stream; None when
        the queue is empty."""
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

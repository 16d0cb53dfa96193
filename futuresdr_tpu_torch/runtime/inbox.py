"""Block inboxes: bounded control and message queue + coalescing data notification.

A copy of ``futuresdr_tpu/runtime/inbox.py``: every block has an inbox for
control messages (Initialize / Call / Callback / StreamInputDone /
StreamOutputDone / Terminate) and a coalescing wake-only flag for the data
plane, so buffer produce/consume wakeups carry no payload and collapse into
one. Runtime control traffic goes through the unbounded ``send``; message-plane
producers use the bounded ``try_send`` (drops when full) or ``send_async``
(waits for room). Thread-safe and loop-agnostic: blocks may run on different
event loops, so waking crosses loops with ``call_soon_threadsafe``.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

from ..types import Pmt, PortId

__all__ = ["BlockMessage", "Initialize", "Call", "Callback", "StreamInputDone",
           "StreamOutputDone", "Terminate", "BlockInbox", "ReplySlot"]


class BlockMessage:
    __slots__ = ()


@dataclass(frozen=True)
class Initialize(BlockMessage):
    pass


@dataclass(frozen=True)
class Call(BlockMessage):
    port: PortId
    data: Pmt


@dataclass(frozen=True)
class Callback(BlockMessage):
    port: PortId
    data: Pmt
    reply: "ReplySlot"


@dataclass(frozen=True)
class StreamInputDone(BlockMessage):
    port_index: int


@dataclass(frozen=True)
class StreamOutputDone(BlockMessage):
    port_index: int


@dataclass(frozen=True)
class Terminate(BlockMessage):
    pass


def _wake(waiter) -> None:
    if waiter is None:
        return
    loop, ev = waiter
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if loop is running:
        ev.set()
    else:
        try:
            loop.call_soon_threadsafe(ev.set)
        except RuntimeError:
            pass  # target loop already closed (teardown race)


class ReplySlot:
    """A oneshot reply channel usable across event loops."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Any = None
        self._set = False
        self._waiter: Optional[tuple] = None  # (loop, asyncio.Event)

    def set(self, value: Any) -> None:
        with self._lock:
            if self._set:
                return
            self._value = value
            self._set = True
            waiter = self._waiter
        _wake(waiter)

    async def get(self) -> Any:
        with self._lock:
            if self._set:
                return self._value
            ev = asyncio.Event()
            self._waiter = (asyncio.get_running_loop(), ev)
        await ev.wait()
        return self._value


class BlockInbox:
    """Inbox + coalescing notifier for one block. ``capacity`` bounds
    ``try_send`` and ``send_async`` (default config ``queue_size``; 0 means
    unbounded)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            from ..config import config
            capacity = config().queue_size
        self.capacity = capacity
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._pending = False          # coalesced data notification
        self._waiter: Optional[tuple] = None  # (loop, asyncio.Event)
        self._space_waiters: list = []        # producers parked in send_async
        self.closed = False

    # -- producer side ---------------------------------------------------------
    def send(self, msg: BlockMessage) -> bool:
        """Enqueue a control message and wake the block. Unbounded: for
        runtime control traffic that must never be dropped. Returns False if
        the inbox is closed."""
        with self._lock:
            if self.closed:
                return False
            self._q.append(msg)
            waiter, self._waiter = self._waiter, None
        _wake(waiter)
        return True

    def try_send(self, msg: BlockMessage) -> bool:
        """Bounded enqueue: False (the message is dropped) when the inbox is
        full or closed."""
        with self._lock:
            if self.closed or (self.capacity > 0 and len(self._q) >= self.capacity):
                return False
            self._q.append(msg)
            waiter, self._waiter = self._waiter, None
        _wake(waiter)
        return True

    async def send_async(self, msg: BlockMessage) -> bool:
        """Bounded enqueue with backpressure: waits until there is room.
        False if the inbox closed."""
        while True:
            with self._lock:
                if self.closed:
                    return False
                if self.capacity <= 0 or len(self._q) < self.capacity:
                    self._q.append(msg)
                    waiter, self._waiter = self._waiter, None
                    break
                ev = asyncio.Event()
                self._space_waiters.append((asyncio.get_running_loop(), ev))
            await ev.wait()
        _wake(waiter)
        return True

    def notify(self) -> None:
        """Coalescing data-plane wake: no payload, collapses repeats."""
        with self._lock:
            if self.closed:
                return
            self._pending = True
            waiter, self._waiter = self._waiter, None
        _wake(waiter)

    # -- consumer side (the block's event loop) --------------------------------
    def take_pending(self) -> bool:
        with self._lock:
            p, self._pending = self._pending, False
            return p

    def try_recv(self) -> Optional[BlockMessage]:
        with self._lock:
            m = self._q.popleft() if self._q else None
            woken: list = []
            if m is not None and self._space_waiters and \
                    (self.capacity <= 0 or len(self._q) < self.capacity):
                woken, self._space_waiters = self._space_waiters, []
        for w in woken:
            _wake(w)
        return m

    def __len__(self) -> int:
        return len(self._q)

    async def wait(self) -> None:
        """Park until a message arrives or a notification is pending."""
        with self._lock:
            if self._pending or self._q:
                return
            ev = asyncio.Event()
            self._waiter = (asyncio.get_running_loop(), ev)
        await ev.wait()

    async def recv(self) -> BlockMessage:
        while True:
            m = self.try_recv()
            if m is not None:
                return m
            await self.wait()
            self.take_pending()

    def close(self) -> None:
        """Refuse new sends; queued messages stay drainable. Producers parked
        in ``send_async`` wake and see the inbox closed."""
        with self._lock:
            self.closed = True
            woken, self._space_waiters = self._space_waiters, []
        for w in woken:
            _wake(w)

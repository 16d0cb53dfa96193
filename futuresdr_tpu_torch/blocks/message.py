"""Message-plane blocks (a copy of ``futuresdr_tpu/blocks/message.py``).

Reference: ``src/blocks/{message_annotator,message_apply,message_burst,message_copy,
message_pipe,message_sink,message_source}.rs``.
"""

from __future__ import annotations

import asyncio
from typing import Callable, List, Optional

from ..runtime.kernel import Kernel, message_handler
from ..types import Pmt

__all__ = ["MessageAnnotator", "MessageApply", "MessageBurst", "MessageCopy",
           "MessagePipe", "MessageSink", "MessageSource"]


class MessageCopy(Kernel):
    """Forward messages unchanged (`message_copy.rs`)."""

    def __init__(self):
        super().__init__()
        self.add_message_output("out")

    @message_handler(name="in")
    def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        # sync handler: the hot message-plane path skips the per-message
        # coroutine allocation (call_handler supports both forms)
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        mio.post("out", p)
        return Pmt.ok()


class MessageAnnotator(Kernel):
    """Wrap each message in a map with extra fields (`message_annotator.rs`)."""

    def __init__(self, annotations: dict, key: str = "data"):
        super().__init__()
        self.annotations = annotations
        self.key = key
        self.add_message_output("out")

    @message_handler(name="in")
    def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        # sync handler: direct-dispatch eligible (no awaits in the body)
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        d = dict(self.annotations)
        d[self.key] = p
        mio.post("out", Pmt.map(d))
        return Pmt.ok()


class MessageApply(Kernel):
    """Map messages through a function; None drops (`message_apply.rs`)."""

    def __init__(self, f: Callable[[Pmt], Optional[Pmt]]):
        super().__init__()
        self.f = f
        self.add_message_output("out")

    @message_handler(name="in")
    async def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        r = self.f(p)
        if r is not None:
            mio.post("out", r if isinstance(r, Pmt) else Pmt.from_py(r))
        return Pmt.ok()


class MessageBurst(Kernel):
    """Emit a burst of n copies of a message, then finish (`message_burst.rs`)."""

    def __init__(self, message: Pmt, n: int):
        super().__init__()
        self.message = message if isinstance(message, Pmt) else Pmt.from_py(message)
        self.n = int(n)
        self.add_message_output("out")

    async def work(self, io, mio, meta):
        for i in range(self.n):
            # backpressured: a large burst parks here instead of growing the
            # consumer's inbox without bound
            await mio.post_async("out", self.message)
            if (i & 0xFFF) == 0xFFF:
                # the direct-dispatch path never suspends on its own; yield
                # periodically so ctrl-port/supervisor traffic stays live
                # during a long burst
                await asyncio.sleep(0)
        io.finished = True


class MessageSink(Kernel):
    """Collect received messages (`message_sink.rs`)."""

    def __init__(self):
        super().__init__()
        self.received: List[Pmt] = []

    @message_handler(name="in")
    def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        # sync handler: stays on the direct-dispatch fast path end to end
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        self.received.append(p)
        return Pmt.ok()


class MessagePipe(Kernel):
    """Forward messages into an asyncio queue for external consumption (`message_pipe.rs`)."""

    def __init__(self, queue: Optional[asyncio.Queue] = None):
        super().__init__()
        self.queue = queue or asyncio.Queue()

    @message_handler(name="in")
    async def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        await self.queue.put(p)
        return Pmt.ok()


class MessageSource(Kernel):
    """Emit a message periodically (`message_source.rs:120`): every ``interval`` seconds,
    optionally a limited count."""

    def __init__(self, message: Pmt, interval: float, count: Optional[int] = None):
        super().__init__()
        self.message = message if isinstance(message, Pmt) else Pmt.from_py(message)
        self.interval = float(interval)
        self.remaining = count
        self.add_message_output("out")

    async def work(self, io, mio, meta):
        if self.remaining is not None:
            if self.remaining <= 0:
                io.finished = True
                return
            self.remaining -= 1
        mio.post("out", self.message)
        io.block_on(asyncio.sleep(self.interval))

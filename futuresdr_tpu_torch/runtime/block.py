"""WrappedKernel: the per-block actor task containing the block event loop.

A reduced copy of ``futuresdr_tpu/runtime/block.py``: the init barrier, then
a loop that drains the inbox (Call / Callback / StreamInputDone /
StreamOutputDone / Terminate), runs orderly shutdown when finished, parks on
the coalescing notifier (or a ``WorkIo.block_on`` awaitable) when no work is
requested, and otherwise calls ``kernel.work``. A handler's error is logged
and answered ``Pmt.invalid_value()``; it does not end the block. Any other
error is reported to the supervisor, which terminates the flowgraph (the
reference's ``fail_fast``; its other failure policies are not ported).
Each block counts its work calls and time, its handled messages and, on its
ports, the items in and out and the parks (``metrics``).
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..log import logger
from ..types import BlockDescription, Pmt
from .inbox import (BlockInbox, Call, Callback, Initialize, StreamInputDone,
                    StreamOutputDone, Terminate)
from .kernel import Kernel
from .work_io import WorkIo

__all__ = ["WrappedKernel"]

log = logger("runtime.block")


class WrappedKernel:
    """Kernel + meta + inbox."""

    def __init__(self, kernel: Kernel, block_id: int):
        self.kernel = kernel
        self.inbox = BlockInbox()
        kernel.meta.id = block_id
        if not kernel.meta.instance_name:
            kernel.meta.instance_name = f"{kernel.meta.type_name}_{block_id}"
        self.work_calls = 0
        self.work_time_s = 0.0
        self.messages_handled = 0
        # direct message dispatch (message_output.py): the event loop
        # publishes its WorkIo, its loop and its liveness, so a sender on the
        # same loop can call a sync handler in its own frame
        self.io = WorkIo()
        self.loop = None
        self.live = False
        self._in_direct = False

    @property
    def id(self) -> int:
        return self.kernel.meta.id

    @property
    def instance_name(self) -> str:
        return self.kernel.meta.instance_name

    @property
    def is_blocking(self) -> bool:
        return self.kernel.meta.blocking

    def metrics(self) -> dict:
        """The block's counters, in the reference's keys (``restarts`` is
        always 0: the port has only the fail-fast policy)."""
        k = self.kernel
        return {
            "work_calls": self.work_calls,
            "work_time_s": round(self.work_time_s, 6),
            "messages_handled": self.messages_handled,
            "restarts": 0,
            "items_in": {p.name: p.items_consumed for p in k.stream_inputs},
            "items_out": {p.name: p.items_produced for p in k.stream_outputs},
            "buffer_fill": {p.name: round(f, 4) for p in k.stream_inputs
                            if (f := p.fill()) is not None},
            "stalls": {p.name: p.stalls for p in k.stream_outputs},
            "starved": {p.name: p.starved for p in k.stream_inputs},
        }

    def description(self) -> BlockDescription:
        k = self.kernel
        return BlockDescription(
            id=self.id,
            type_name=k.meta.type_name,
            instance_name=k.meta.instance_name,
            stream_inputs=[p.name for p in k.stream_inputs],
            stream_outputs=[p.name for p in k.stream_outputs],
            message_inputs=k.message_input_names(),
            message_outputs=k.mio.names,
            blocking=k.meta.blocking)

    def _note_park(self) -> None:
        """Count a park against the ports that cause it: a full output
        (backpressure) or an input below ``min_items`` (starvation)."""
        k = self.kernel
        for p in k.stream_outputs:
            if p.connected and p.space() < p.min_items:
                p.stalls += 1
        for p in k.stream_inputs:
            if p.connected and not p.finished() and p.available() < p.min_items:
                p.starved += 1

    def _notify_ports_finished(self) -> None:
        for p in self.kernel.stream_outputs:
            p.notify_finished()
        for p in self.kernel.stream_inputs:
            p.notify_finished()
        self.kernel.mio.notify_finished()

    async def _handle(self, msg) -> Pmt:
        """Run a Call's or Callback's handler; a handler error is logged and
        answered ``Pmt.invalid_value()``."""
        try:
            result = await self.kernel.call_handler(self.io, self.kernel.meta,
                                                    msg.port, msg.data)
        except Exception as e:
            log.error("block %s handler error: %r", self.instance_name, e)
            result = Pmt.invalid_value()
        self.messages_handled += 1
        return result

    async def run(self, fg_inbox: BlockInbox) -> None:
        """The block task body. ``fg_inbox`` is the supervisor's queue
        receiving Initialized/BlockDone/BlockError (see runtime.py)."""
        from .runtime import BlockDoneMsg, BlockErrorMsg, InitializedMsg

        kernel = self.kernel
        meta = kernel.meta
        io = self.io
        block_on_task: Optional[asyncio.Future] = None

        # ---- init barrier -----------------------------------------------------
        try:
            kernel.validate_ports()
            while True:
                msg = self.inbox.try_recv()
                if isinstance(msg, Initialize):
                    break
                if isinstance(msg, Terminate):
                    fg_inbox.send(BlockDoneMsg(self.id, self))
                    return
                if isinstance(msg, Callback):
                    # no handler runs before init; never leave a caller hanging
                    msg.reply.set(Pmt.invalid_value())
                if msg is None:
                    await self.inbox.wait()
                    self.inbox.take_pending()
            await kernel.init(kernel.mio, meta)
            fg_inbox.send(InitializedMsg(self.id))
        except Exception as e:
            log.error("block %s failed in init: %r", self.instance_name, e)
            self._notify_ports_finished()
            fg_inbox.send(BlockErrorMsg(self.id, e))
            return

        # ---- event loop -------------------------------------------------------
        error = None
        self.loop = asyncio.get_running_loop()
        self.live = True                    # direct dispatch may target us now
        try:
            while True:
                io.call_again |= self.inbox.take_pending()
                while True:
                    msg = self.inbox.try_recv()
                    if msg is None:
                        break
                    if isinstance(msg, Call):
                        await self._handle(msg)
                        io.call_again = True
                    elif isinstance(msg, Callback):
                        msg.reply.set(await self._handle(msg))
                        io.call_again = True
                    elif isinstance(msg, StreamInputDone):
                        kernel.stream_inputs[msg.port_index].set_finished()
                        io.call_again = True
                    elif isinstance(msg, (StreamOutputDone, Terminate)):
                        # downstream reader detached, or the flowgraph ends
                        io.finished = True
                if io.finished:
                    break
                if not io.call_again:
                    if block_on_task is None:
                        aw = io.take_block_on()
                        if aw is not None:
                            block_on_task = asyncio.ensure_future(aw)
                    if block_on_task is not None:
                        # wait for the parked awaitable or the inbox
                        inbox_t = asyncio.ensure_future(self.inbox.wait())
                        done, _ = await asyncio.wait(
                            {block_on_task, inbox_t}, return_when=asyncio.FIRST_COMPLETED)
                        if block_on_task in done:
                            block_on_task.result()
                            block_on_task = None
                            io.call_again = True
                        if inbox_t not in done:
                            inbox_t.cancel()
                    else:
                        self._note_park()
                        await self.inbox.wait()
                    continue
                io.reset()
                t0 = time.perf_counter()
                await kernel.work(io, kernel.mio, meta)
                self.work_time_s += time.perf_counter() - t0
                self.work_calls += 1
        except Exception as e:
            log.error("block %s failed: %r", self.instance_name, e)
            error = e
        finally:
            self.live = False               # direct dispatch falls back to the inbox
            if block_on_task is not None:
                block_on_task.cancel()
            leftover = io.take_block_on()
            if leftover is not None and hasattr(leftover, "close"):
                leftover.close()            # never started: close, no warning

        # ---- orderly shutdown -------------------------------------------------
        try:
            self._notify_ports_finished()
            await kernel.deinit(kernel.mio, meta)
        except Exception as e:
            log.error("block %s failed in deinit: %r", self.instance_name, e)
            error = error or e
        if error is not None:
            fg_inbox.send(BlockErrorMsg(self.id, error))
        else:
            fg_inbox.send(BlockDoneMsg(self.id, self))

"""WrappedKernel: the per-block actor task containing the block event loop.

A reduced copy of ``futuresdr_tpu/runtime/block.py``: the init barrier, then
a loop that drains the inbox (StreamInputDone / StreamOutputDone /
Terminate), runs orderly shutdown when finished, parks on the coalescing
notifier when no work is requested, and otherwise calls ``kernel.work``. Any
error is reported to the supervisor, which terminates the flowgraph (the
reference's ``fail_fast``; the other failure policies are a later slice).
"""

from __future__ import annotations

from ..log import logger
from .inbox import BlockInbox, Initialize, StreamInputDone, StreamOutputDone, Terminate
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

    @property
    def id(self) -> int:
        return self.kernel.meta.id

    @property
    def instance_name(self) -> str:
        return self.kernel.meta.instance_name

    @property
    def is_blocking(self) -> bool:
        return self.kernel.meta.blocking

    def _notify_ports_finished(self) -> None:
        for p in self.kernel.stream_outputs:
            p.notify_finished()
        for p in self.kernel.stream_inputs:
            p.notify_finished()

    async def run(self, fg_inbox: BlockInbox) -> None:
        """The block task body. ``fg_inbox`` is the supervisor's queue
        receiving Initialized/BlockDone/BlockError (see runtime.py)."""
        from .runtime import BlockDoneMsg, BlockErrorMsg, InitializedMsg

        kernel = self.kernel
        meta = kernel.meta
        io = WorkIo()

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
                if msg is None:
                    await self.inbox.wait()
                    self.inbox.take_pending()
            await kernel.init(None, meta)
            fg_inbox.send(InitializedMsg(self.id))
        except Exception as e:
            log.error("block %s failed in init: %r", self.instance_name, e)
            self._notify_ports_finished()
            fg_inbox.send(BlockErrorMsg(self.id, e))
            return

        # ---- event loop -------------------------------------------------------
        error = None
        try:
            while True:
                io.call_again |= self.inbox.take_pending()
                while True:
                    msg = self.inbox.try_recv()
                    if msg is None:
                        break
                    if isinstance(msg, StreamInputDone):
                        kernel.stream_inputs[msg.port_index].set_finished()
                        io.call_again = True
                    elif isinstance(msg, (StreamOutputDone, Terminate)):
                        # downstream reader detached, or the flowgraph ends
                        io.finished = True
                if io.finished:
                    break
                if not io.call_again:
                    await self.inbox.wait()
                    continue
                io.reset()
                await kernel.work(io, None, meta)
        except Exception as e:
            log.error("block %s failed: %r", self.instance_name, e)
            error = e

        # ---- orderly shutdown -------------------------------------------------
        try:
            self._notify_ports_finished()
            await kernel.deinit(None, meta)
        except Exception as e:
            log.error("block %s failed in deinit: %r", self.instance_name, e)
            error = error or e
        if error is not None:
            fg_inbox.send(BlockErrorMsg(self.id, error))
        else:
            fg_inbox.send(BlockDoneMsg(self.id, self))

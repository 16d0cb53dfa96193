"""Runtime: launches flowgraphs and runs the per-flowgraph supervisor.

A reduced copy of ``futuresdr_tpu/runtime/runtime.py``: the supervisor
coroutine holds the init barrier, turns a block error into a terminate
cascade and a :class:`FlowgraphError`, joins the block tasks and restores
the blocks into the flowgraph so their final state stays readable.
``Runtime().run(fg)`` runs to completion; ``Runtime().start(fg)`` returns a
:class:`RunningFlowgraph` once every block has passed ``init``. (The REST
control port, telemetry, failure policies and run deadlines are later
slices.)
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import List, Optional

from ..log import logger
from .block import WrappedKernel
from .flowgraph import Flowgraph
from .inbox import BlockInbox, Initialize, ReplySlot, Terminate
from .scheduler import AsyncScheduler

__all__ = ["Runtime", "RunningFlowgraph", "FlowgraphError"]

log = logger("runtime")


@dataclass(frozen=True)
class InitializedMsg:
    block_id: int


@dataclass(frozen=True)
class BlockDoneMsg:
    block_id: int
    block: WrappedKernel


@dataclass(frozen=True)
class BlockErrorMsg:
    block_id: int
    error: Exception


class FlowgraphError(RuntimeError):
    """A block errored and the flowgraph ended; ``errors`` holds every
    collected exception."""

    def __init__(self, message: str, errors=()):
        super().__init__(message)
        self.errors: List[Exception] = list(errors)


def _make_error(errors: List[Exception]) -> FlowgraphError:
    msg = str(errors[0]) if len(errors) == 1 else \
        f"{len(errors)} blocks failed: " + "; ".join(repr(e) for e in errors)
    return FlowgraphError(msg, errors)


async def run_flowgraph_supervisor(fg: Flowgraph, scheduler: AsyncScheduler,
                                   fg_inbox: BlockInbox,
                                   initialized: ReplySlot) -> Flowgraph:
    """The per-flowgraph supervisor."""
    blocks = fg.take_blocks()
    by_id = {b.id: b for b in blocks}
    handles = scheduler.run_flowgraph_blocks(blocks, fg_inbox)
    errors: List[Exception] = []
    ended: List[WrappedKernel] = []     # finished or failed, restored at the end
    active = len(blocks)
    terminated = False

    def record(msg) -> None:
        """Book a BlockDone/BlockError; the first error terminates every block."""
        nonlocal active, terminated
        active -= 1
        if isinstance(msg, BlockDoneMsg):
            ended.append(msg.block)
            return
        errors.append(msg.error)
        if msg.block_id in by_id:
            ended.append(by_id[msg.block_id])
        if not terminated:
            log.error("block %d errored (%r): terminating flowgraph",
                      msg.block_id, msg.error)
            for b in blocks:
                b.inbox.send(Terminate())
            terminated = True

    # ---- init barrier: every block reports Initialized, Done or Error --------
    for b in blocks:
        b.inbox.send(Initialize())
    for _ in blocks:
        msg = await fg_inbox.recv()
        if not isinstance(msg, InitializedMsg):
            record(msg)
    for b in blocks:                    # start signal
        b.inbox.notify()
    initialized.set(errors[0] if errors else None)

    # ---- main loop, then join + restore ---------------------------------------
    while active > 0:
        msg = await fg_inbox.recv()
        # after an init error the barrier may have counted a block's Done
        # before another block's Initialized, which then arrives here
        if not isinstance(msg, InitializedMsg):
            record(msg)
    for h in handles:
        try:
            await h
        except Exception as e:
            log.error("block task raised: %r", e)
    fg_inbox.close()
    fg.restore_blocks(ended)
    if errors:
        raise _make_error(errors) from errors[0]
    return fg


class RunningFlowgraph:
    """A launched flowgraph, to wait for."""

    def __init__(self, task, scheduler: AsyncScheduler):
        self._task = task
        self._scheduler = scheduler

    async def wait(self) -> Flowgraph:
        """Await completion; returns the flowgraph with final block state."""
        if asyncio.get_running_loop() is not self._scheduler.loop:
            fut = asyncio.run_coroutine_threadsafe(self._wait(), self._scheduler.loop)
            return await asyncio.wrap_future(fut)
        return await self._task

    async def _wait(self) -> Flowgraph:
        return await self._task

    def wait_sync(self) -> Flowgraph:
        return self._scheduler.run_coro_sync(self._wait())


class Runtime:
    """Owns the scheduler and runs flowgraphs on it."""

    def __init__(self, scheduler: Optional[AsyncScheduler] = None):
        self.scheduler = scheduler or AsyncScheduler()

    async def _start_on_scheduler(self, fg: Flowgraph) -> RunningFlowgraph:
        fg_inbox = BlockInbox()
        initialized = ReplySlot()
        task = asyncio.get_running_loop().create_task(
            run_flowgraph_supervisor(fg, self.scheduler, fg_inbox, initialized))
        err = await initialized.get()
        running = RunningFlowgraph(task, self.scheduler)
        if err is not None:
            # propagate the init failure after the blocks drained
            await running.wait()
        return running

    async def start_async(self, fg: Flowgraph) -> RunningFlowgraph:
        """Launch; resolves once every block passed the init barrier."""
        self.scheduler.start()
        if asyncio.get_running_loop() is not self.scheduler.loop:
            fut = asyncio.run_coroutine_threadsafe(
                self._start_on_scheduler(fg), self.scheduler.loop)
            return await asyncio.wrap_future(fut)
        return await self._start_on_scheduler(fg)

    async def run_async(self, fg: Flowgraph) -> Flowgraph:
        running = await self.start_async(fg)
        return await running.wait()

    def run(self, fg: Flowgraph) -> Flowgraph:
        """Run to completion; raises :class:`FlowgraphError` if a block failed."""
        return self.scheduler.run_coro_sync(self.run_async(fg))

    def start(self, fg: Flowgraph) -> RunningFlowgraph:
        return self.scheduler.run_coro_sync(self._start_on_scheduler(fg))

    def shutdown(self) -> None:
        self.scheduler.shutdown()

"""Runtime: launches flowgraphs and runs the per-flowgraph supervisor.

A reduced copy of ``futuresdr_tpu/runtime/runtime.py``: the supervisor
coroutine holds the init barrier, routes the control messages of a
:class:`FlowgraphHandle` (post, call, describe, metrics, terminate, cancel)
to the blocks, turns a block error into a terminate cascade and a
:class:`FlowgraphError`, joins the block tasks and restores the blocks into
the flowgraph so their final state stays readable. ``Runtime().run(fg)``
runs to completion; ``Runtime().start(fg)`` returns a
:class:`RunningFlowgraph` (with its ``handle``) once every block has passed
``init``. With config ``ctrlport_enable`` the runtime serves its flowgraphs
over the REST control port (``ctrl_port.py``). Telemetry, failure policies
other than fail-fast and the doctor's flight records are not ported.
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

from ..config import config
from ..log import logger
from ..types import FlowgraphDescription, Pmt
from .block import WrappedKernel
from .flowgraph import Flowgraph
from .inbox import BlockInbox, Call, Callback, Initialize, ReplySlot, Terminate
from .kernel import Kernel
from .scheduler import AsyncScheduler

__all__ = ["Runtime", "RuntimeHandle", "FlowgraphHandle", "RunningFlowgraph",
           "FlowgraphError", "FlowgraphCancelled", "InitializedMsg", "BlockDoneMsg",
           "BlockErrorMsg", "BlockCallMsg", "BlockCallbackMsg", "DescribeMsg",
           "MetricsMsg", "TerminateMsg", "CancelMsg"]

log = logger("runtime")


# ---- messages to the supervisor ------------------------------------------------
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


@dataclass(frozen=True)
class BlockCallMsg:
    block_id: int
    port: Any
    data: Pmt


@dataclass(frozen=True)
class BlockCallbackMsg:
    block_id: int
    port: Any
    data: Pmt
    reply: ReplySlot


@dataclass(frozen=True)
class DescribeMsg:
    reply: ReplySlot


@dataclass(frozen=True)
class MetricsMsg:
    reply: ReplySlot


@dataclass(frozen=True)
class TerminateMsg:
    """Stop the flowgraph: a terminate cascade, and a clean end."""


@dataclass(frozen=True)
class CancelMsg:
    """Stop the flowgraph with an error: a terminate cascade, and the run
    raises a :class:`FlowgraphError` carrying a :class:`FlowgraphCancelled`."""
    reason: str


class FlowgraphError(RuntimeError):
    """A block errored (or the run was cancelled) and the flowgraph ended;
    ``errors`` holds every collected exception."""

    def __init__(self, message: str, errors=()):
        super().__init__(message)
        self.errors: List[Exception] = list(errors)


class FlowgraphCancelled(RuntimeError):
    """The error recorded when a run is cancelled."""


def _make_error(errors: List[Exception]) -> FlowgraphError:
    msg = str(errors[0]) if len(errors) == 1 else \
        f"{len(errors)} blocks failed: " + "; ".join(repr(e) for e in errors)
    return FlowgraphError(msg, errors)


def _describe(fg: Flowgraph, blocks: List[WrappedKernel]) -> FlowgraphDescription:
    desc = fg.describe()
    desc.blocks = [b.description() for b in sorted(blocks, key=lambda b: b.id)]
    return desc


async def run_flowgraph_supervisor(fg: Flowgraph, scheduler: AsyncScheduler,
                                   fg_inbox: BlockInbox,
                                   initialized: ReplySlot) -> Flowgraph:
    """The per-flowgraph supervisor."""
    blocks = fg.take_blocks()
    by_id = {b.id: b for b in blocks}
    handles = scheduler.run_flowgraph_blocks(blocks, fg_inbox)
    errors: List[Exception] = []
    ended: List[WrappedKernel] = []     # finished or failed, restored at the end
    queued: list = []                   # handle traffic during the barrier
    active = len(blocks)
    terminated = False

    def terminate_all() -> None:
        nonlocal terminated
        if not terminated:
            for b in blocks:
                b.inbox.send(Terminate())
            terminated = True

    def record(msg) -> None:
        """Book a BlockDone/BlockError; the first error terminates every block."""
        nonlocal active
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
        terminate_all()

    def handle(msg) -> None:
        if isinstance(msg, BlockCallMsg):
            blk = by_id.get(msg.block_id)
            if blk is not None:
                blk.inbox.send(Call(msg.port, msg.data))
        elif isinstance(msg, BlockCallbackMsg):
            blk = by_id.get(msg.block_id)
            if blk is None or not blk.inbox.send(Callback(msg.port, msg.data, msg.reply)):
                msg.reply.set(Pmt.invalid_value())
        elif isinstance(msg, DescribeMsg):
            msg.reply.set(_describe(fg, blocks))
        elif isinstance(msg, MetricsMsg):
            msg.reply.set({b.instance_name: b.metrics() for b in blocks})
        elif isinstance(msg, TerminateMsg):
            terminate_all()
        elif isinstance(msg, CancelMsg):
            errors.append(FlowgraphCancelled(msg.reason))
            if not terminated:
                log.error("flowgraph cancelled: %s", msg.reason)
            terminate_all()
        elif isinstance(msg, (BlockDoneMsg, BlockErrorMsg)):
            record(msg)

    # ---- init barrier: every block reports Initialized, Done or Error --------
    for b in blocks:
        b.inbox.send(Initialize())
    waiting = len(blocks)
    while waiting > 0:
        msg = await fg_inbox.recv()
        if isinstance(msg, InitializedMsg):
            waiting -= 1
        elif isinstance(msg, (BlockDoneMsg, BlockErrorMsg)):
            waiting -= 1
            record(msg)
        else:
            queued.append(msg)          # replayed after the barrier
    for b in blocks:                    # start signal
        b.inbox.notify()
    initialized.set(errors[0] if errors else None)

    # ---- main loop, then join + restore ---------------------------------------
    for msg in queued:
        handle(msg)
    while active > 0:
        msg = await fg_inbox.recv()
        # after an init error the barrier may have counted a block's Done
        # before another block's Initialized, which then arrives here
        if not isinstance(msg, InitializedMsg):
            handle(msg)
    for h in handles:
        try:
            await h
        except Exception as e:
            log.error("block task raised: %r", e)
    # refuse new sends, then answer what is still queued: a call into a
    # finished flowgraph gets InvalidValue instead of hanging its caller
    fg_inbox.close()
    while (msg := fg_inbox.try_recv()) is not None:
        if isinstance(msg, BlockCallbackMsg):
            msg.reply.set(Pmt.invalid_value())
        elif isinstance(msg, DescribeMsg):
            msg.reply.set(_describe(fg, blocks))
        elif isinstance(msg, MetricsMsg):
            msg.reply.set({b.instance_name: b.metrics() for b in blocks})
    fg.restore_blocks(ended)
    if errors:
        raise _make_error(errors) from errors[0]
    return fg


class FlowgraphHandle:
    """Control handle of a running flowgraph. The async methods run on any
    event loop; the ``*_sync`` variants bridge from plain threads."""

    def __init__(self, fg: Flowgraph, fg_inbox: BlockInbox, scheduler: AsyncScheduler):
        self._fg = fg
        self._inbox = fg_inbox
        self._scheduler = scheduler

    def _bid(self, block: Union[Kernel, int]) -> int:
        return block if isinstance(block, int) else self._fg.block_id(block)

    @staticmethod
    def _pmt(data) -> Pmt:
        return data if isinstance(data, Pmt) else Pmt.from_py(data)

    # -- async API -------------------------------------------------------------
    async def post(self, block: Union[Kernel, int], port, data=None) -> None:
        """Fire-and-forget handler invocation."""
        self._inbox.send(BlockCallMsg(self._bid(block), port, self._pmt(data)))

    async def call(self, block: Union[Kernel, int], port, data=None) -> Pmt:
        """Invoke a handler and await its result (``Pmt.invalid_value()``
        once the flowgraph has ended)."""
        reply = ReplySlot()
        if not self._inbox.send(BlockCallbackMsg(self._bid(block), port,
                                                 self._pmt(data), reply)):
            return Pmt.invalid_value()
        return await reply.get()

    async def describe(self) -> FlowgraphDescription:
        reply = ReplySlot()
        if not self._inbox.send(DescribeMsg(reply)):
            return self._fg.describe()   # ended: describe the restored blocks
        return await reply.get()

    async def metrics(self) -> dict:
        """Per-block metrics (work calls and time, items in and out,
        messages handled, parks)."""
        reply = ReplySlot()
        if not self._inbox.send(MetricsMsg(reply)):
            return {}
        return await reply.get()

    async def terminate(self) -> None:
        self._inbox.send(TerminateMsg())

    async def cancel(self, reason: str = "requested") -> None:
        """Terminate with an error: the run raises a FlowgraphError."""
        self._inbox.send(CancelMsg(reason))

    # -- sync bridges ----------------------------------------------------------
    def post_sync(self, block, port, data=None) -> None:
        self._inbox.send(BlockCallMsg(self._bid(block), port, self._pmt(data)))

    def call_sync(self, block, port, data=None) -> Pmt:
        return self._scheduler.run_coro_sync(self.call(block, port, data))

    def describe_sync(self) -> FlowgraphDescription:
        return self._scheduler.run_coro_sync(self.describe())

    def metrics_sync(self) -> dict:
        return self._scheduler.run_coro_sync(self.metrics())

    def terminate_sync(self) -> None:
        self._inbox.send(TerminateMsg())

    def cancel_sync(self, reason: str = "requested") -> None:
        self._inbox.send(CancelMsg(reason))


class RunningFlowgraph:
    """A launched flowgraph: its ``handle`` and its completion."""

    #: seconds a run cancelled by ``wait(timeout)`` has to wind down
    CANCEL_GRACE_S = 5.0

    def __init__(self, handle: FlowgraphHandle, task, scheduler: AsyncScheduler):
        self.handle = handle
        self._task = task
        self._scheduler = scheduler

    async def wait(self, timeout: Optional[float] = None) -> Flowgraph:
        """Await completion; returns the flowgraph with final block state.
        Past ``timeout`` seconds the run is cancelled and raises a
        :class:`FlowgraphError` (also when it does not wind down within
        ``CANCEL_GRACE_S``)."""
        if asyncio.get_running_loop() is not self._scheduler.loop:
            fut = asyncio.run_coroutine_threadsafe(self._wait(timeout),
                                                   self._scheduler.loop)
            return await asyncio.wrap_future(fut)
        return await self._wait(timeout)

    def wait_sync(self, timeout: Optional[float] = None) -> Flowgraph:
        return self._scheduler.run_coro_sync(self._wait(timeout))

    async def _wait(self, timeout: Optional[float]) -> Flowgraph:
        if timeout is None:
            return await self._task
        try:
            return await asyncio.wait_for(asyncio.shield(self._task), timeout)
        except asyncio.TimeoutError:
            pass
        log.error("flowgraph exceeded its %.3f s deadline: cancelling", timeout)
        await self.handle.cancel(f"run deadline exceeded ({timeout} s)")
        try:
            return await asyncio.wait_for(asyncio.shield(self._task),
                                          self.CANCEL_GRACE_S)
        except asyncio.TimeoutError:
            raise FlowgraphError(
                f"flowgraph did not end within {self.CANCEL_GRACE_S} s of its "
                f"cancel (deadline {timeout} s): a block is stuck inside work()",
                [FlowgraphCancelled("run deadline exceeded")]) from None

    async def stop(self) -> Flowgraph:
        await self.handle.terminate()
        return await self.wait()

    def stop_sync(self) -> Flowgraph:
        self.handle.terminate_sync()
        return self.wait_sync()


class RuntimeHandle:
    """The registry of running flowgraphs that the control port serves."""

    def __init__(self, scheduler: AsyncScheduler):
        self.scheduler = scheduler
        self._flowgraphs: Dict[int, FlowgraphHandle] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    def register(self, handle: FlowgraphHandle) -> int:
        with self._lock:
            fg_id = self._next_id
            self._next_id += 1
            self._flowgraphs[fg_id] = handle
            return fg_id

    def unregister(self, fg_id: int) -> None:
        with self._lock:
            self._flowgraphs.pop(fg_id, None)

    def get_flowgraph(self, fg_id: int) -> Optional[FlowgraphHandle]:
        with self._lock:
            return self._flowgraphs.get(fg_id)

    def flowgraph_ids(self) -> List[int]:
        with self._lock:
            return list(self._flowgraphs)


async def _unregister_on_done(task, rt_handle: RuntimeHandle, fg_id: int):
    try:
        return await task
    finally:
        rt_handle.unregister(fg_id)


class Runtime:
    """Owns the scheduler, the registry of running flowgraphs and, with
    config ``ctrlport_enable``, the REST control port (``ctrl_port``)."""

    def __init__(self, scheduler: Optional[AsyncScheduler] = None):
        self.scheduler = scheduler or AsyncScheduler()
        self.handle = RuntimeHandle(self.scheduler)
        self.ctrl_port = None
        if config().ctrlport_enable:
            from .ctrl_port import ControlPort
            self.ctrl_port = ControlPort(self.handle)
            self.ctrl_port.start()

    async def _start_on_scheduler(self, fg: Flowgraph) -> RunningFlowgraph:
        fg_inbox = BlockInbox()
        initialized = ReplySlot()
        loop = asyncio.get_running_loop()
        task = loop.create_task(
            run_flowgraph_supervisor(fg, self.scheduler, fg_inbox, initialized))
        handle = FlowgraphHandle(fg, fg_inbox, self.scheduler)
        fg_id = self.handle.register(handle)
        join = loop.create_task(_unregister_on_done(task, self.handle, fg_id))
        running = RunningFlowgraph(handle, join, self.scheduler)
        err = await initialized.get()
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
        if self.ctrl_port is not None:
            self.ctrl_port.stop()
        self.scheduler.shutdown()

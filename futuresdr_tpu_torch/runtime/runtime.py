"""Runtime: launches flowgraphs and runs the per-flowgraph supervisor.

A reduced copy of ``futuresdr_tpu/runtime/runtime.py``: the supervisor
coroutine holds the init barrier, routes the control messages of a
:class:`FlowgraphHandle` (post, call, describe, metrics, terminate, cancel)
to the blocks, turns a block error into a terminate cascade and a
:class:`FlowgraphError`, joins the block tasks and restores the blocks into
the flowgraph so their final state stays readable. ``Runtime().run(fg)``
runs to completion; ``Runtime().start(fg)`` returns a
:class:`RunningFlowgraph` (with its ``handle``) once every block has passed
``init``. Every launch runs the device-graph fusion pass
(``devchain.py``). With config ``ctrlport_enable`` the runtime serves its
flowgraphs over the REST control port (``ctrl_port.py``).

The supervisor applies each block's failure policy (``block.py``
:class:`~.block.BlockPolicy`): a ``fail_fast`` error (or a ``restart`` whose
budget ran out) terminates every block; an ``isolate`` error retires that
block alone, and an ``isolate_group`` error every block of its group, their
ports ended in topological order, while the other branches finish. Each
decision (restart attempts, isolations, the fail-fast verdict, a cancel) is
recorded, carried by the final :class:`FlowgraphError` and served by
``describe()``. ``Runtime.run(fg, timeout=…)`` (or config ``run_timeout``)
is a deadline over the launch and the run: past it the run is cancelled and
raises a :class:`FlowgraphError`, after ``run_timeout_grace`` seconds even if
a block never winds down.

Telemetry (``telemetry/``): the supervisor records its ``flowgraph`` and
``init_barrier`` spans and the ``terminate_cascade``, ``block_isolated`` and
``group_isolated`` instants, attaches the launched blocks and their stream
edges to the doctor's watchdog for the run (config ``doctor`` starts it
with the first :class:`Runtime`; ``doctor_action="cancel"`` lets a trip
cancel the run), and flight-records a run that ends in an error or
overruns its deadline: the dump's path rides the
:class:`FlowgraphError` (``flight_record``) where ``doctor_dir`` is set.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

from ..config import config
from ..log import logger
from ..telemetry.spans import recorder as _trace_recorder
from ..types import FlowgraphDescription, Pmt
from .block import WrappedKernel
from .flowgraph import Flowgraph
from .inbox import BlockInbox, Call, Callback, Initialize, ReplySlot, Terminate
from .kernel import Kernel
from .scheduler import AsyncScheduler, Scheduler

__all__ = ["Runtime", "RuntimeHandle", "FlowgraphHandle", "RunningFlowgraph",
           "FlowgraphError", "FlowgraphCancelled", "FlowgraphMessage", "InitializedMsg",
           "BlockDoneMsg", "BlockErrorMsg", "BlockRestartMsg", "BlockCallMsg",
           "BlockCallbackMsg", "DescribeMsg", "MetricsMsg", "TerminateMsg", "CancelMsg"]

log = logger("runtime")
_trace = _trace_recorder()


# ---- messages to the supervisor ------------------------------------------------
class FlowgraphMessage:
    """The base of every message a block or a handle sends the supervisor."""

    __slots__ = ()


@dataclass(frozen=True)
class InitializedMsg(FlowgraphMessage):
    block_id: int
    ok: bool


@dataclass(frozen=True)
class BlockDoneMsg(FlowgraphMessage):
    block_id: int
    block: WrappedKernel


@dataclass(frozen=True)
class BlockErrorMsg(FlowgraphMessage):
    block_id: int
    error: Exception


@dataclass(frozen=True)
class BlockRestartMsg(FlowgraphMessage):
    """A block restarted itself under its ``restart`` policy (the supervisor
    records the decision; the block does the re-init)."""
    block_id: int
    attempt: int
    error: Exception
    phase: str                       # "init" | "work"


@dataclass(frozen=True)
class BlockCallMsg(FlowgraphMessage):
    block_id: int
    port: Any
    data: Pmt


@dataclass(frozen=True)
class BlockCallbackMsg(FlowgraphMessage):
    block_id: int
    port: Any
    data: Pmt
    reply: ReplySlot


@dataclass(frozen=True)
class DescribeMsg(FlowgraphMessage):
    reply: ReplySlot


@dataclass(frozen=True)
class MetricsMsg(FlowgraphMessage):
    reply: ReplySlot


@dataclass(frozen=True)
class TerminateMsg(FlowgraphMessage):
    """Stop the flowgraph: a terminate cascade, and a clean end."""


@dataclass(frozen=True)
class CancelMsg(FlowgraphMessage):
    """Stop the flowgraph with an error: a terminate cascade, and the run
    raises a :class:`FlowgraphError` carrying a :class:`FlowgraphCancelled`.
    ``flight_record`` is the doctor's dump path when one was written (the
    run deadline, the watchdog's ``cancel`` escalation)."""
    reason: str
    flight_record: Optional[str] = None


class FlowgraphError(RuntimeError):
    """A block errored (or the run was cancelled) and the flowgraph ended:
    ``errors`` holds every collected exception, ``blocks`` the failed
    block's instance name for each (None for a cancel), and
    ``policy_decisions`` the supervisor's policy actions (restart attempts,
    isolations, the fail-fast verdict, cancels). ``flight_record`` is the
    path of the doctor's flight record of the failure, where one was
    written (``doctor_dir``)."""

    def __init__(self, message: str, errors=(), blocks=(), policy_decisions=(),
                 flight_record: Optional[str] = None):
        super().__init__(message)
        self.errors: List[Exception] = list(errors)
        self.blocks: List[Optional[str]] = list(blocks)
        self.policy_decisions: List[dict] = list(policy_decisions)
        self.flight_record = flight_record


class FlowgraphCancelled(RuntimeError):
    """The error recorded when a run is cancelled."""


def _make_error(errors: List[Exception], blocks=(), decisions=(),
                flight_record: Optional[str] = None) -> FlowgraphError:
    """One error for all: a single error keeps its own message, several
    give the count and each block."""
    if len(errors) == 1:
        msg = str(errors[0])
    else:
        msg = f"{len(errors)} blocks failed: " + "; ".join(
            f"{b or '<runtime>'}: {e!r}" for b, e in zip(blocks, errors))
    return FlowgraphError(msg, errors, blocks, decisions, flight_record)


def _describe(fg: Flowgraph, blocks: List[WrappedKernel], decisions=()) -> FlowgraphDescription:
    desc = fg.describe()
    desc.blocks = [b.description() for b in sorted(blocks, key=lambda b: b.id)]
    desc.policy_decisions = list(decisions)
    return desc


def _topo_ranks(fg: Flowgraph, wk: Dict[int, WrappedKernel]) -> Dict[int, int]:
    """Each WrappedKernel's topological rank over the stream and in-place
    edges, sources first (ties in block order, a cycle's blocks last): an
    isolate group's members end their ports in this order, so no member
    waits on one downstream of it."""
    edges = []
    for e in list(fg.stream_edges) + list(getattr(fg, "inplace_edges", [])):
        if id(e.src) in wk and id(e.dst) in wk:
            edges.append((id(wk[id(e.src)]), id(wk[id(e.dst)])))
    indeg: Dict[int, int] = {id(b): 0 for b in wk.values()}
    out: Dict[int, list] = {}
    for src, dst in edges:
        indeg[dst] += 1
        out.setdefault(src, []).append(dst)
    order = [k for k, v in indeg.items() if v == 0]
    i = 0
    while i < len(order):
        for d in out.get(order[i], ()):
            indeg[d] -= 1
            if indeg[d] == 0:
                order.append(d)
        i += 1
    ranks = {k: r for r, k in enumerate(order)}
    for k in indeg:
        ranks.setdefault(k, len(ranks))
    return ranks


async def run_flowgraph_supervisor(fg: Flowgraph, scheduler: Scheduler,
                                   fg_inbox: BlockInbox,
                                   initialized: ReplySlot) -> Flowgraph:
    """The per-flowgraph supervisor. Two fusion passes run first, on every
    launch, as in the reference: the native fast chain (``fastchain.py``),
    whose C++ loop runs each fusable tree of host stream blocks, then
    device-graph fusion (``devchain.py``), one fused block a device region.
    Each fused task answers the protocol for every member; the other blocks
    run as actors."""
    from ..telemetry.doctor import doctor as _doctor
    from .devchain import find_device_chains, run_devchain_task, shed_devchain_bridge
    from .fastchain import find_native_chains, run_chain_task, shed_metrics_bridge
    t_sup = _trace.now()
    try:
        native_chains = find_native_chains(fg)
        dev_chains = find_device_chains(fg)
        blocks = fg.take_blocks()
    except Exception as e:
        # a fast chain whose library does not build, or a flowgraph already
        # running: the launch fails with it instead of waiting on a barrier
        # no block will reach
        initialized.set(e)
        raise
    by_id = {b.id: b for b in blocks}
    wk = {id(b.kernel): b for b in blocks}
    fused: set = set()
    chain_tasks = []
    for ch in native_chains:
        members = [wk[id(k)] for k in ch]
        fused.update(id(b) for b in members)
        chain_tasks.append((members, ch.in_ring))
    dev_tasks = []
    for ch in dev_chains:
        members = [wk[id(k)] for k in ch]
        fused.update(id(b) for b in members)
        dev_tasks.append((members, ch))
    actor_blocks = [b for b in blocks if id(b) not in fused]
    for b in actor_blocks:
        # a kernel fused in an earlier run reports its own metrics again
        shed_metrics_bridge(b.kernel)
        shed_devchain_bridge(b.kernel)
    handles = scheduler.run_flowgraph_blocks(actor_blocks, fg_inbox)
    for members, inr in chain_tasks:
        handles.append(scheduler.spawn(run_chain_task(members, fg_inbox, scheduler,
                                                      in_ring=inr)))
    for members, ch in dev_tasks:
        handles.append(scheduler.spawn(run_devchain_task(members, ch, fg_inbox,
                                                         scheduler)))
    # the doctor's watchdog samples these blocks' progress and classifies a
    # wedge over the stream edges; detached in the finally below
    doc = _doctor()

    def doctor_cancel(diag: dict, path: Optional[str]) -> None:
        # the doctor_action=cancel escalation, from the watchdog thread
        # after the flight record landed (the send is thread-safe)
        fg_inbox.send(CancelMsg(f"doctor watchdog: {diag.get('state')} — "
                                f"{diag.get('detail')}", path))

    doc_token = doc.attach(blocks, [
        (wk[id(e.src)], e.src_port, wk[id(e.dst)], e.dst_port)
        for e in fg.stream_edges if id(e.src) in wk and id(e.dst) in wk],
        cancel=doctor_cancel)
    errors: List[Exception] = []
    err_blocks: List[Optional[str]] = []    # the failed block's name per error
    decisions: List[dict] = []              # the policy actions taken
    flight_paths: List[str] = []            # dumps a CancelMsg carried
    try:
        ended: List[WrappedKernel] = []     # finished or failed, restored at the end
        queued: list = []                   # handle traffic during the barrier
        active = len(blocks)
        terminated = False
        fatal_init = None
        # isolate groups, each in topological order
        groups: Dict[str, List[WrappedKernel]] = {}
        for b in blocks:
            if b.policy.isolate_group:
                groups.setdefault(b.policy.isolate_group, []).append(b)
        if groups:
            ranks = _topo_ranks(fg, wk)
            for members in groups.values():
                members.sort(key=lambda b: ranks.get(id(b), 0))
        retired_groups: set = set()

        def terminate_all(reason: str, **args) -> None:
            nonlocal terminated
            if not terminated:
                _trace.instant("runtime", "terminate_cascade", args={"reason": reason, **args})
                for b in blocks:
                    b.inbox.send(Terminate())
                terminated = True

        def retire_group(group: str, origin: str, err) -> None:
            """Retire every member of ``group`` after ``origin`` failed: one
            decision naming them all, then each survivor's ports ended at once
            in topological order and the member terminated."""
            if group in retired_groups:
                return
            retired_groups.add(group)
            members = groups.get(group, [])
            decisions.append({"block": origin, "action": "isolate_group", "group": group,
                              "members": [m.instance_name for m in members],
                              "error": repr(err)})
            log.error("block %s failed (%r): isolate group %r retires %s; the flowgraph "
                      "continues", origin, err, group, [m.instance_name for m in members])
            _trace.instant("runtime", "group_isolated",
                           args={"group": group, "origin": origin,
                                 "members": [m.instance_name for m in members]})
            for m in members:
                if m.instance_name == origin:
                    continue                 # its own error path ended its ports
                m.inbox.send(Terminate())
                try:
                    m._notify_ports_finished()   # idempotent: its shutdown repeats it
                except Exception as e2:          # noqa: BLE001
                    log.debug("group EOS of %s raised: %r", m.instance_name, e2)

        def record(msg, in_init: bool = False) -> None:
            """Book a BlockDone/BlockError and apply the failed block's policy."""
            nonlocal active, fatal_init
            active -= 1
            if isinstance(msg, BlockDoneMsg):
                ended.append(msg.block)
                return
            blk = by_id.get(msg.block_id)
            name = blk.instance_name if blk is not None else str(msg.block_id)
            errors.append(msg.error)
            err_blocks.append(name)
            if blk is not None:
                ended.append(blk)
            action = blk.policy.on_error if blk is not None else "fail_fast"
            if terminated:
                return
            if action == "isolate":
                # the block ended its ports before reporting: downstream drains,
                # upstream detaches, the other branches run on
                if blk.policy.isolate_group:
                    retire_group(blk.policy.isolate_group, name, msg.error)
                else:
                    d = {"block": name, "action": "isolate", "error": repr(msg.error)}
                    if in_init:
                        d["phase"] = "init"
                    decisions.append(d)
                    log.error("block %s errored (%r): isolated by policy, the flowgraph "
                              "continues", name, msg.error)
                    _trace.instant("runtime", "block_isolated", args={"block": msg.block_id})
                return
            if in_init:
                # an init failure ends the launch itself (no policy decision, as
                # in the reference)
                fatal_init = fatal_init or msg.error
            else:
                decisions.append({"block": name,
                                  "action": "restarts_exhausted" if action == "restart"
                                  else "fail_fast",
                                  "error": repr(msg.error)})
            log.error("block %s errored (%r): terminating flowgraph", name, msg.error)
            terminate_all("block_error", block=msg.block_id)

        def cancel(msg: CancelMsg) -> None:
            nonlocal fatal_init
            errors.append(FlowgraphCancelled(msg.reason))
            err_blocks.append(None)
            decisions.append({"block": None, "action": "cancel", "reason": msg.reason})
            if msg.flight_record:
                flight_paths.append(msg.flight_record)
            if not terminated:
                log.error("flowgraph cancelled: %s", msg.reason)
            fatal_init = fatal_init or errors[-1]
            terminate_all("cancel")

        def record_restart(msg: BlockRestartMsg) -> None:
            blk = by_id.get(msg.block_id)
            decisions.append({"block": blk.instance_name if blk else str(msg.block_id),
                              "action": "restart", "attempt": msg.attempt,
                              "phase": msg.phase, "error": repr(msg.error)})

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
                msg.reply.set(_describe(fg, blocks, decisions))
            elif isinstance(msg, MetricsMsg):
                msg.reply.set({b.instance_name: b.metrics() for b in blocks})
            elif isinstance(msg, TerminateMsg):
                terminate_all("requested")
            elif isinstance(msg, CancelMsg):
                cancel(msg)
            elif isinstance(msg, BlockRestartMsg):
                record_restart(msg)
            elif isinstance(msg, (BlockDoneMsg, BlockErrorMsg)):
                record(msg)

        # ---- init barrier: every block reports Initialized, Done or Error --------
        t_barrier = _trace.now()
        for b in blocks:
            b.inbox.send(Initialize())
        waiting = len(blocks)
        abandoned = False      # cancelled while a block sits inside init()
        while waiting > 0:
            msg = await fg_inbox.recv()
            if isinstance(msg, InitializedMsg):
                waiting -= 1
            elif isinstance(msg, (BlockDoneMsg, BlockErrorMsg)):
                waiting -= 1
                record(msg, in_init=True)
            elif isinstance(msg, BlockRestartMsg):
                record_restart(msg)
            elif isinstance(msg, CancelMsg):
                # a block wedged in init never reports: give up the barrier
                cancel(msg)
                abandoned = True
                break
            else:
                queued.append(msg)          # replayed after the barrier
        _trace.complete("runtime", "init_barrier", t_barrier,
                        args={"blocks": len(blocks), "errors": len(errors)})
        for b in blocks:                    # start signal
            b.inbox.notify()
        initialized.set(fatal_init)

        # ---- main loop, then join + restore ---------------------------------------
        for msg in queued:
            handle(msg)
        while active > 0 and not abandoned:
            msg = await fg_inbox.recv()
            # after an init error the barrier may have counted a block's Done
            # before another block's Initialized, which then arrives here
            if not isinstance(msg, InitializedMsg):
                handle(msg)
        if not abandoned:
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
                msg.reply.set(_describe(fg, blocks, decisions))
            elif isinstance(msg, MetricsMsg):
                msg.reply.set({b.instance_name: b.metrics() for b in blocks})
        # the decisions stay readable after the run (describe), recovered or not
        fg._policy_decisions = list(decisions)
        fg.restore_blocks(ended)
        _trace.complete("runtime", "flowgraph", t_sup,
                        args={"blocks": len(blocks), "errors": len(errors)})
        if errors:
            raise _make_error(errors, err_blocks, decisions,
                              flight_paths[0] if flight_paths else None) from errors[0]
        return fg
    except BaseException as e:
        # flight-record the terminal state before detaching (a no-op unless
        # the watchdog runs); the record's supervisor section carries every
        # error and decision
        paths = doc.on_supervisor_error(
            e, extra={"block_errors": len(errors), "blocks": [b for b in err_blocks if b],
                      "policy_decisions": list(decisions)})
        if isinstance(e, FlowgraphError) and e.flight_record is None and paths:
            e.flight_record = paths[0]
        raise
    finally:
        doc.detach(doc_token)


class FlowgraphHandle:
    """Control handle of a running flowgraph. The async methods run on any
    event loop; the ``*_sync`` variants bridge from plain threads."""

    def __init__(self, fg: Flowgraph, fg_inbox: BlockInbox, scheduler: Scheduler):
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

    async def cancel(self, reason: str = "requested",
                     flight_record: Optional[str] = None) -> None:
        """Terminate with an error: the run raises a FlowgraphError (carrying
        ``flight_record``, a dump's path, where given)."""
        self._inbox.send(CancelMsg(reason, flight_record))

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

    def cancel_sync(self, reason: str = "requested",
                    flight_record: Optional[str] = None) -> None:
        self._inbox.send(CancelMsg(reason, flight_record))


class RunningFlowgraph:
    """A launched flowgraph: its ``handle`` and its completion."""

    def __init__(self, handle: FlowgraphHandle, task, scheduler: Scheduler):
        self.handle = handle
        self._task = task
        self._scheduler = scheduler

    @staticmethod
    def _resolve_timeout(timeout: Optional[float]) -> Optional[float]:
        """An explicit ``timeout`` wins, else config ``run_timeout``; 0 is
        no deadline."""
        if timeout is not None:
            return float(timeout) or None
        return float(config().run_timeout) or None

    async def wait(self, timeout: Optional[float] = None) -> Flowgraph:
        """Await completion; returns the flowgraph with final block state.
        Past ``timeout`` seconds (or config ``run_timeout``) the run is
        cancelled and raises a :class:`FlowgraphError`, also when it does not
        wind down within config ``run_timeout_grace`` seconds."""
        timeout = self._resolve_timeout(timeout)
        if asyncio.get_running_loop() is not self._scheduler.loop:
            fut = asyncio.run_coroutine_threadsafe(self._wait(timeout),
                                                   self._scheduler.loop)
            return await asyncio.wrap_future(fut)
        return await self._wait(timeout)

    def wait_sync(self, timeout: Optional[float] = None) -> Flowgraph:
        return self._scheduler.run_coro_sync(self._wait(self._resolve_timeout(timeout)))

    async def _wait(self, timeout: Optional[float]) -> Flowgraph:
        if timeout is None:
            return await self._task
        try:
            return await asyncio.wait_for(asyncio.shield(self._task), timeout)
        except asyncio.TimeoutError:
            pass
        # the black box first (the live state), then the cancel, which
        # carries the record's path into the run's FlowgraphError
        from ..telemetry.doctor import doctor as _doctor
        d = _doctor()
        paths = d.dump(d.flight_record(f"run_timeout:{timeout}s"))
        path = paths[0] if paths else None
        log.error("flowgraph exceeded its %.3f s run deadline: cancelling (flight record: "
                  "%s)", timeout, path or "in memory")
        await self.handle.cancel(f"run deadline exceeded ({timeout} s)", path)
        grace = max(0.0, float(config().run_timeout_grace))
        try:
            if grace > 0:
                return await asyncio.wait_for(asyncio.shield(self._task), grace)
            raise asyncio.TimeoutError
        except asyncio.TimeoutError:
            # a block stuck inside work() cannot see Terminate: the caller
            # gets its thread back, the block is abandoned
            raise FlowgraphError(
                f"flowgraph did not end within {grace} s of its cancel (run deadline "
                f"{timeout} s): a block is stuck inside work()",
                [FlowgraphCancelled("run deadline exceeded")], [None],
                [{"block": None, "action": "cancel",
                  "reason": "run deadline exceeded"}], path) from None

    async def stop(self) -> Flowgraph:
        await self.handle.terminate()
        return await self.wait()

    def stop_sync(self) -> Flowgraph:
        self.handle.terminate_sync()
        return self.wait_sync()


class RuntimeHandle:
    """The registry of running flowgraphs that the control port serves."""

    def __init__(self, scheduler: Scheduler):
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

    def __init__(self, scheduler: Optional[Scheduler] = None, extra_routes=None):
        """``scheduler``: any :class:`~.scheduler.Scheduler` (default: config
        ``default_scheduler``, ``"async"`` or ``"threaded"``).
        ``extra_routes``: ``[(method, path, async handler), …]`` mounted on the
        control port beside its own routes (``ctrl_port.py``), the reference's
        ``Runtime::with_custom_routes``; ignored when the control port is off."""
        if scheduler is None:
            if config().default_scheduler == "threaded":
                from .scheduler import ThreadedScheduler
                scheduler = ThreadedScheduler()
            else:
                scheduler = AsyncScheduler()
        self.scheduler = scheduler
        self.handle = RuntimeHandle(self.scheduler)
        if config().doctor:
            # FUTURESDR_TPU_DOCTOR=1: the stall watchdog runs for the life of
            # the process (enable() is idempotent)
            from ..telemetry.doctor import enable as _doctor_enable
            _doctor_enable()
        self.ctrl_port = None
        if config().ctrlport_enable:
            from .ctrl_port import ControlPort
            self.ctrl_port = ControlPort(self.handle, extra_routes=extra_routes)
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
        try:
            err = await initialized.get()
        except asyncio.CancelledError:
            # the launch was abandoned (a run deadline inside init): the
            # barrier gives up at this cancel, and the supervisor's expected
            # FlowgraphError is collected here
            fg_inbox.send(CancelMsg("launch abandoned: run deadline exceeded in init"))
            join.add_done_callback(lambda t: t.cancelled() or t.exception())
            raise
        if err is not None:
            # propagate the init failure after the blocks drained
            await running.wait(timeout=0)
        return running

    async def start_async(self, fg: Flowgraph) -> RunningFlowgraph:
        """Launch; resolves once every block passed the init barrier."""
        self.scheduler.start()
        if asyncio.get_running_loop() is not self.scheduler.loop:
            fut = asyncio.run_coroutine_threadsafe(
                self._start_on_scheduler(fg), self.scheduler.loop)
            return await asyncio.wrap_future(fut)
        return await self._start_on_scheduler(fg)

    async def run_async(self, fg: Flowgraph,
                        timeout: Optional[float] = None) -> Flowgraph:
        """Run to completion. ``timeout`` (or config ``run_timeout``) bounds
        the launch and the run together: a block wedged in ``init`` raises a
        :class:`FlowgraphError` at the deadline as one wedged in ``work``
        does."""
        timeout = RunningFlowgraph._resolve_timeout(timeout)
        if timeout is None:
            running = await self.start_async(fg)
            return await running.wait(timeout=0)
        t0 = time.monotonic()
        try:
            running = await asyncio.wait_for(self.start_async(fg), timeout)
        except asyncio.TimeoutError:
            from ..telemetry.doctor import doctor as _doctor
            d = _doctor()
            paths = d.dump(d.flight_record(f"run_timeout:init:{timeout}s"))
            path = paths[0] if paths else None
            log.error("flowgraph launch exceeded the %.3f s run deadline inside the "
                      "init barrier (flight record: %s)", timeout, path or "in memory")
            raise FlowgraphError(
                f"flowgraph did not pass the init barrier within the {timeout} s run "
                f"deadline: a block is stuck inside init()",
                [FlowgraphCancelled("run deadline exceeded in init")], [None],
                [{"block": None, "action": "cancel",
                  "reason": "run deadline exceeded in init"}], path) from None
        return await running.wait(timeout=max(0.05, timeout - (time.monotonic() - t0)))

    def run(self, fg: Flowgraph, timeout: Optional[float] = None) -> Flowgraph:
        """Run to completion; raises :class:`FlowgraphError` if a block failed,
        or past ``timeout`` seconds (or config ``run_timeout``) instead of
        hanging."""
        return self.scheduler.run_coro_sync(self.run_async(fg, timeout=timeout))

    def start(self, fg: Flowgraph) -> RunningFlowgraph:
        return self.scheduler.run_coro_sync(self._start_on_scheduler(fg))

    def shutdown(self) -> None:
        if self.ctrl_port is not None:
            self.ctrl_port.stop()
        self.scheduler.shutdown()

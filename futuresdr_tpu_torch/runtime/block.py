"""WrappedKernel: the per-block actor task containing the block event loop.

A reduced copy of ``futuresdr_tpu/runtime/block.py``: the init barrier, then
a loop that drains the inbox (Call / Callback / StreamInputDone /
StreamOutputDone / Terminate), runs orderly shutdown when finished, parks on
the coalescing notifier (or a ``WorkIo.block_on`` awaitable) when no work is
requested, and otherwise calls ``kernel.work``. A handler's error is logged
and answered ``Pmt.invalid_value()``; it does not end the block.

Any other error meets the block's :class:`BlockPolicy`: its kernel's own
``policy`` attribute, else the config default (``block_policy``,
``block_max_restarts``, ``block_backoff``, ``block_isolate_groups``).
``fail_fast`` reports it to the supervisor, which ends the flowgraph.
``restart`` re-initializes the block in place, out of a budget shared by
init and work failures, with a capped exponential backoff: a kernel with a
``recover()`` coroutine (the device kernels' carry checkpoint and replay,
``tpu/kernel_block.py``) is offered that first, else it is deinit'ed and
init'ed again; each attempt is reported to the supervisor
(``BlockRestartMsg``). ``isolate`` is the supervisor's decision
(``runtime.py``): the error path has already ended the block's ports, so the
block retires while independent branches finish.
Each block counts its work calls and time, its handled messages, its
restarts and, on its ports, the items in and out and the parks
(``metrics``). Telemetry: each work call is observed (1 in 8) by the
``fsdr_block_work_duration_seconds{block}`` histogram, and, with tracing on
(``FUTURESDR_TPU_TRACE``), recorded as a ``block`` span, each park as a
``park`` span naming the stalled and starved ports, each restart as a
``block_restart`` instant and a tick of ``fsdr_block_restarts_total``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Optional

from ..config import config
from ..log import logger
from ..telemetry import prom as _prom
from ..telemetry.doctor import WORK_DURATION as _WORK_DURATION
from ..telemetry.spans import recorder as _trace_recorder
from ..types import BlockDescription, Pmt
from . import faults as _faults
from .inbox import (BlockInbox, Call, Callback, Initialize, StreamInputDone,
                    StreamOutputDone, Terminate)
from .kernel import Kernel
from .work_io import WorkIo

__all__ = ["WrappedKernel", "BlockPolicy", "policy_allows_fusion", "fusion_degraded",
           "isolate_groups_from_config"]

log = logger("runtime.block")
_trace = _trace_recorder()

_RESTARTS = _prom.counter(
    "fsdr_block_restarts_total",
    "block restarts under the restart failure policy", ("block",))

_POLICIES = ("fail_fast", "restart", "isolate")


@dataclass(frozen=True)
class BlockPolicy:
    """A block's failure policy (``kernel.policy = BlockPolicy(...)``).

    * ``fail_fast``: any error ends the whole flowgraph (the default).
    * ``restart``: re-initialize the block in place, up to ``max_restarts``
      times, init and work failures alike, after ``backoff * 2**(attempt-1)``
      seconds (at most ``backoff_cap``); past the budget it fails as
      ``fail_fast``. A kernel's ``recover()`` (bit-exact checkpoint replay)
      is tried before the deinit and init that forfeit its in-flight state.
    * ``isolate``: retire the failed block (its ports end, downstream drains,
      upstream detaches) while independent branches finish; the run still
      raises a :class:`~.runtime.FlowgraphError` at its end.
      ``isolate_group="name"`` retires every block of the named group
      together (the config form: ``block_isolate_groups``).

    ``isolate`` members refuse device-graph fusion (one member of a fused
    program cannot retire alone); ``restart`` members fuse, and the fused
    kernel restarts from its composed carry's checkpoint
    (:func:`policy_allows_fusion`)."""

    on_error: str = "fail_fast"
    max_restarts: int = 3
    backoff: float = 0.05
    backoff_cap: float = 2.0
    isolate_group: Optional[str] = None

    def __post_init__(self):
        if self.on_error not in _POLICIES:
            raise ValueError(f"on_error must be one of {_POLICIES}, got {self.on_error!r}")
        if self.isolate_group is not None:
            if self.on_error == "fail_fast":
                # naming only the group is the short form of an isolate policy
                object.__setattr__(self, "on_error", "isolate")
            elif self.on_error != "isolate":
                raise ValueError(f"isolate_group requires on_error='isolate' "
                                 f"(got {self.on_error!r})")

    @staticmethod
    def from_config() -> "BlockPolicy":
        """The process default (``block_policy``, ``block_max_restarts``,
        ``block_backoff``). An unknown ``block_policy`` falls back to
        ``fail_fast`` with an error logged: this never raises, since it runs
        inside the block's error paths."""
        c = config()
        on_error = str(c.block_policy)
        if on_error not in _POLICIES:
            log.error("invalid block_policy config %r (want one of %s): using fail_fast",
                      on_error, _POLICIES)
            on_error = "fail_fast"
        return BlockPolicy(on_error=on_error, max_restarts=int(c.block_max_restarts),
                           backoff=float(c.block_backoff))


def isolate_groups_from_config() -> dict:
    """``{instance_name: group}`` from the ``block_isolate_groups`` spec
    (``"block_name=group;other=group2"``). A malformed entry is logged and
    skipped: like :meth:`BlockPolicy.from_config`, this never raises."""
    out = {}
    for raw in str(config().block_isolate_groups or "").replace(",", ";").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        name, sep, group = raw.partition("=")
        if not sep or not name.strip() or not group.strip():
            log.error("bad block_isolate_groups entry %r (want name=group)", raw)
            continue
        out[name.strip()] = group.strip()
    return out


def policy_allows_fusion(kernel, restartable: bool = False) -> bool:
    """May ``kernel`` be fused? ``fail_fast`` members always, ``restart``
    members where the fused kernel restarts in place (``restartable``,
    device-graph fusion), ``isolate`` members (their own policy or a config
    group) never."""
    pol = getattr(kernel, "policy", None)
    if pol is None:
        name = getattr(getattr(kernel, "meta", None), "instance_name", None)
        if name and name in isolate_groups_from_config():
            return False
    on_error = getattr(pol, "on_error", "fail_fast") if pol is not None else "fail_fast"
    return on_error == "fail_fast" or (restartable and on_error == "restart")


def fusion_degraded(fault_sites=("work",), allow_restart: bool = False) -> bool:
    """Should fusion decline for the whole process? A non-``fail_fast``
    ``block_policy`` default (``restart`` exempted with ``allow_restart``),
    or an injector armed on any of ``fault_sites``: the fused blocks bypass
    the per-block supervision and fault points."""
    pol = str(config().block_policy)
    if pol != "fail_fast" and not (allow_restart and pol == "restart"):
        return True
    p = _faults.plan()
    return any(p.has_site(s) for s in fault_sites)


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
        # restart attempts, init and work alike; the policy resolves on
        # first use (the config may change until the launch)
        self.restarts = 0
        self._policy: Optional[BlockPolicy] = None
        self._restart_ctr = None
        # the work-duration child, bound once (labels() takes the family's
        # lock); the event loop observes 1 call in 8 (a local countdown),
        # billed by the telemetry overhead gate
        self._work_hist = _WORK_DURATION.labels(block=kernel.meta.instance_name)
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

    @property
    def policy(self) -> BlockPolicy:
        """The kernel's own ``policy`` when it is a :class:`BlockPolicy`,
        else the config default, with a ``block_isolate_groups`` group for a
        block that names none (resolved once)."""
        p = self._policy
        if p is None:
            p = getattr(self.kernel, "policy", None)
            if not isinstance(p, BlockPolicy):
                p = BlockPolicy.from_config()
                group = isolate_groups_from_config().get(self.instance_name)
                if group:
                    p = BlockPolicy(on_error="isolate", isolate_group=group,
                                    max_restarts=p.max_restarts, backoff=p.backoff)
            self._policy = p
        return p

    def metrics(self) -> dict:
        """The block's counters, in the reference's keys, updated with the
        kernel's ``extra_metrics()`` where it has one (a fused device chain's
        members report through it, ``devchain.py``). In-place ports have no
        ring, so no fill."""
        k = self.kernel
        # extra_metrics first: a hook may refresh the port counters read below
        extra = getattr(k, "extra_metrics", None)
        extra_out = {}
        if callable(extra):
            try:
                extra_out = extra() or {}
            except Exception as e:             # noqa: BLE001 — metrics never raise
                log.debug("block %s extra_metrics raised: %r", self.instance_name, e)
        m = {
            "work_calls": self.work_calls,
            "work_time_s": round(self.work_time_s, 6),
            "messages_handled": self.messages_handled,
            "restarts": self.restarts,
            "items_in": {p.name: p.items_consumed for p in k.stream_inputs},
            "items_out": {p.name: p.items_produced for p in k.stream_outputs},
            "buffer_fill": {p.name: round(f, 4) for p in k.stream_inputs
                            if (f := getattr(p, "fill", lambda: None)()) is not None},
            "stalls": {p.name: p.stalls for p in k.stream_outputs},
            "starved": {p.name: p.starved for p in k.stream_inputs},
        }
        m.update(extra_out)
        return m

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
            blocking=k.meta.blocking,
            policy=self.policy.on_error,
            restarts=self.restarts,
            isolate_group=self.policy.isolate_group)

    def _note_park(self) -> tuple:
        """Count a park against the ports that cause it: a full output
        (backpressure) or an input below ``min_items`` (starvation); returns
        the (stalled, starved) port names for the park span."""
        k = self.kernel
        stalled, starved = [], []
        for p in k.stream_outputs:
            space = getattr(p, "space", None)        # in-place ports have no ring
            if space is not None and p.connected and space() < p.min_items:
                p.stalls += 1
                stalled.append(p.name)
        for p in k.stream_inputs:
            avail = getattr(p, "available", None)
            if avail is not None and p.connected and not p.finished() \
                    and avail() < p.min_items:
                p.starved += 1
                starved.append(p.name)
        return stalled, starved

    # -- the restart policy ----------------------------------------------------
    async def _note_restart(self, err: Exception, fg_inbox, phase: str) -> None:
        """Count one restart attempt, tell the supervisor, and sleep out the
        capped exponential backoff."""
        from .runtime import BlockRestartMsg
        pol = self.policy
        self.restarts += 1
        if self._restart_ctr is None:
            self._restart_ctr = _RESTARTS.labels(block=self.instance_name)
        self._restart_ctr.inc()
        log.warning("block %s failed in %s (%r): restart %d/%d", self.instance_name,
                    phase, err, self.restarts, pol.max_restarts)
        _trace.instant("runtime", "block_restart",
                       args={"block": self.instance_name, "phase": phase,
                             "attempt": self.restarts})
        fg_inbox.send(BlockRestartMsg(self.id, self.restarts, err, phase))
        delay = min(pol.backoff * (2 ** (self.restarts - 1)), pol.backoff_cap)
        if delay > 0:
            await asyncio.sleep(delay)

    async def _reinit_for_restart(self, err: Exception, fg_inbox) -> Optional[Exception]:
        """Restart the kernel in place after a work error: the backoff, then
        its ``recover()`` where it has one (bit-exact replay from its carry
        checkpoint), else, or where recovery declines, deinit (best effort)
        and init, which forfeits the in-flight state. A fault during
        recovery takes another attempt (the replay log is intact). Returns
        None on success, or the exception that ended the block once the
        budget is spent (the one to report, not the first work error)."""
        kernel = self.kernel
        await self._note_restart(err, fg_inbox, phase="work")
        recover = getattr(kernel, "recover", None)
        while callable(recover):
            try:
                if not await recover(err):
                    break                       # declined: no usable checkpoint
                log.info("block %s recovered in place from its carry checkpoint",
                         self.instance_name)
                return None
            except Exception as e:              # noqa: BLE001 — another attempt
                if self.restarts >= self.policy.max_restarts:
                    log.warning("block %s checkpoint recovery failed on the final "
                                "restart (%r): falling back to a fresh init",
                                self.instance_name, e)
                    break
                await self._note_restart(e, fg_inbox, phase="work")
                err = e
        while True:
            try:
                await kernel.deinit(kernel.mio, kernel.meta)
            except Exception as e:              # noqa: BLE001 — best effort
                log.debug("deinit of failed block %s raised: %r", self.instance_name, e)
            try:
                await kernel.init(kernel.mio, kernel.meta)
                return None
            except Exception as e2:             # noqa: BLE001
                if self.restarts >= self.policy.max_restarts:
                    log.error("block %s re-init failed on the final restart: %r",
                              self.instance_name, e2)
                    return e2
                await self._note_restart(e2, fg_inbox, phase="init")

    def _drop_block_on(self, task) -> None:
        """Cancel a parked ``block_on`` awaitable and close one never
        started (no warning)."""
        if task is not None:
            task.cancel()
        leftover = self.io.take_block_on()
        if leftover is not None and hasattr(leftover, "close"):
            leftover.close()

    def _notify_ports_finished(self) -> None:
        """End every port (downstream drains, upstream detaches): orderly
        shutdown, and a block that failed in init, which under ``isolate``
        must still release its neighbours."""
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
            while True:
                try:
                    await kernel.init(kernel.mio, meta)
                    break
                except Exception as e:
                    # the restart budget covers init failures too
                    pol = self.policy
                    if pol.on_error != "restart" or self.restarts >= pol.max_restarts:
                        raise
                    try:
                        await kernel.deinit(kernel.mio, meta)   # init need not be idempotent
                    except Exception as e2:                     # noqa: BLE001
                        log.debug("deinit after failed init raised: %r", e2)
                    await self._note_restart(e, fg_inbox, phase="init")
            fg_inbox.send(InitializedMsg(self.id, ok=True))
        except Exception as e:
            log.error("block %s failed in init: %r", self.instance_name, e)
            try:
                self._notify_ports_finished()
            except Exception as e2:                             # noqa: BLE001
                log.debug("port EOS after init failure raised: %r", e2)
            fg_inbox.send(BlockErrorMsg(self.id, e))
            return

        # ---- event loop -------------------------------------------------------
        error = None
        self.loop = asyncio.get_running_loop()
        self.live = True                    # direct dispatch may target us now
        # the work:<block> fault site (runtime/faults.py), resolved once
        fplan = _faults.plan()
        work_fault = fplan.resolve("work", self.instance_name) if fplan.armed() else None
        # the work-duration histogram's systematic 1-in-8 sample: a local
        # countdown keeps the per-call cost to an add and a test
        work_hist, tick = self._work_hist, 0
        try:
            # a work error under a restart policy re-initializes the kernel in
            # place and enters the event loop again
            while True:
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
                                stalled, starved = self._note_park()
                                t_park = time.perf_counter_ns()
                                await self.inbox.wait()
                                if _trace.enabled:
                                    _trace.complete("park", self.instance_name, t_park,
                                                    args={"stalled": stalled,
                                                          "starved": starved})
                            continue
                        io.reset()
                        if work_fault is not None:
                            work_fault.check()      # before work() touches a port
                        t0 = time.perf_counter_ns()
                        await kernel.work(io, kernel.mio, meta)
                        end = time.perf_counter_ns()
                        self.work_time_s += (end - t0) * 1e-9
                        self.work_calls += 1
                        tick += 1
                        if not tick & 7:
                            work_hist.observe((end - t0) * 1e-9)
                        if _trace.enabled:
                            _trace.complete("block", self.instance_name, t0, end_ns=end)
                except Exception as e:
                    pol = self.policy
                    if pol.on_error == "restart" and self.restarts < pol.max_restarts:
                        self._drop_block_on(block_on_task)
                        block_on_task = None
                        terminal = await self._reinit_for_restart(e, fg_inbox)
                        if terminal is None:
                            io.reset()
                            io.finished = False
                            io.call_again = True     # look at the ports again
                            continue
                        e = terminal                 # what ended the block
                    log.error("block %s failed: %r", self.instance_name, e)
                    error = e
                break
        finally:
            self.live = False               # direct dispatch falls back to the inbox
            self._drop_block_on(block_on_task)

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

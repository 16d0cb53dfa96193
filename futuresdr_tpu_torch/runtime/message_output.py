"""Named message output ports: fan-out of Pmt values to connected handlers.

A copy of ``futuresdr_tpu/runtime/message_output.py`` (reference:
``src/runtime/message_output.rs:12-121``). ``post`` clones the Pmt to every
connected handler's inbox as a ``Call``; ``notify_finished`` posts ``Pmt::Finished`` so downstream
message-driven blocks can complete (``message_output.rs:37-47``).

Direct dispatch (the message-plane hot path): when the destination block is a
PURE message block (base no-op ``work()``), its handler for the wired port is
a plain function, it runs on the SAME event loop, is live, and its inbox is
empty, the handler is invoked directly in the sender's stack frame instead of
being enqueued — one dict hit and a call replace enqueue → wake → drain →
dispatch. This keeps full per-message semantics (every handler runs once per
message, per-sender FIFO order holds because an empty inbox means everything
this sender previously enqueued was already drained) while removing the
per-message actor-loop round-trip.
Fallbacks (any gate fails, re-entrancy onto a block already in a direct call,
or nesting deeper than _DIRECT_DEPTH_MAX) take the classic inbox path.
"""

from __future__ import annotations

import asyncio
import threading
import types
from typing import Dict, List

from ..log import logger
from ..types import Pmt, PortId
from .inbox import BlockInbox, Call

__all__ = ["MessageOutputs"]

log = logger("runtime.message_output")

# bound on synchronous call-through nesting: a linear chain nests one frame per
# stage per message; cycles and pathological depths fall back to the inbox.
# The counter is PER-THREAD: nesting is a per-event-loop property, and each
# blocking block runs its own loop on its own thread.
_DIRECT_DEPTH_MAX = 64
_tl = threading.local()

_get_running_loop = asyncio.get_running_loop
_CoroType = types.CoroutineType


def _deliver_direct(conn, pmt: Pmt, loop_now) -> bool:
    """Invoke the connection's sync handler in the sender's frame if every
    safety gate passes; False → the caller must enqueue instead."""
    inbox, _handler, dw, fn, dio, dmio, dmeta = conn
    depth = getattr(_tl, "depth", 0)
    if fn is None or not dw.live or dw._in_direct or dw.loop is not loop_now \
            or depth >= _DIRECT_DEPTH_MAX or inbox._q:
        return False
    dw._in_direct = True
    _tl.depth = depth + 1
    try:
        result = fn(dio, dmio, dmeta, pmt)
        if type(result) is _CoroType:
            # a plain function returning a coroutine (pathological but legal):
            # run it through the loop like the actor path would
            asyncio.ensure_future(result)
    except Exception as e:                              # noqa: BLE001
        # same containment as the block event loop's Call branch
        log.error("block %s handler error: %r", dw.instance_name, e)
    finally:
        _tl.depth = depth
        dw._in_direct = False
    dw.messages_handled += 1
    if dio.finished:
        dw.inbox.notify()           # wake the parked event loop to observe EOS
    return True


class MessageOutputs:
    def __init__(self, names: List[str]):
        self._names = list(names)
        # (inbox, handler port, wrapped, sync handler|None, dst io, dst mio,
        #  dst meta) — destination attributes prebound at connect time so the
        # per-message hop does one tuple unpack, not an attribute chase
        self._conns: Dict[str, List[tuple]] = {n: [] for n in names}

    @property
    def names(self) -> List[str]:
        return list(self._names)

    def add_port(self, name: str) -> None:
        if name not in self._conns:
            self._names.append(name)
            self._conns[name] = []

    def connect(self, name: str, inbox: BlockInbox, handler: PortId,
                wrapped=None) -> None:
        """Wire this output to a destination handler. ``wrapped`` (the
        destination WrappedKernel, when the caller has it) enables the direct
        dispatch fast path; without it every post takes the inbox."""
        pid = PortId.coerce(handler)
        fn = dio = dmio = dmeta = None
        if wrapped is not None:
            k = wrapped.kernel
            hname = pid.id
            if isinstance(hname, int):
                names = k.message_input_names()
                hname = names[hname] if 0 <= hname < len(names) else None
            if hname is not None and getattr(k, "_direct_ok", False):
                fn = k._sync_handler(hname)
            dio, dmio, dmeta = wrapped.io, k.mio, k.meta
        self._conns[name].append((inbox, pid, wrapped, fn, dio, dmio, dmeta))

    def connections(self, name: str):
        return [(c[0], c[1]) for c in self._conns[name]]

    def post(self, name: str, pmt: Pmt) -> None:
        """Fire-and-forget fan-out (`message_output.rs:49-66`); the inbox
        fallback is unbounded — for low-rate posts. High-rate producers use
        :meth:`post_async` (the direct path, when it applies, has no queue to
        bound at all)."""
        try:
            loop_now = _get_running_loop()
        except RuntimeError:
            loop_now = None
        for conn in self._conns[name]:
            if not _deliver_direct(conn, pmt, loop_now):
                conn[0].send(Call(conn[1], pmt))

    async def post_async(self, name: str, pmt: Pmt) -> None:
        """Fan-out with backpressure: awaits space in each full target inbox — the
        semantics of the reference's async `post` over its bounded channel."""
        loop_now = _get_running_loop()
        for conn in self._conns[name]:
            if not _deliver_direct(conn, pmt, loop_now):
                await conn[0].send_async(Call(conn[1], pmt))

    def notify_finished(self) -> None:
        for name in self._names:
            self.post(name, Pmt.finished())

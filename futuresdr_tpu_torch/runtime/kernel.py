"""The block base class: ``Kernel`` with async ``init``/``work``/``deinit``.

A reduced copy of ``futuresdr_tpu/runtime/kernel.py``. Ports are declared
in ``__init__`` with ``add_stream_input``/``add_stream_output``, or
``add_inplace_input``/``add_inplace_output`` for the device-frame plane
(``buffer/circuit.py``); message handlers are registered with
``add_message_input`` or marked with the :func:`message_handler` decorator,
and message outputs are declared with ``add_message_output`` and posted to
through ``mio`` (:class:`MessageOutputs`), which ``init``/``work``/``deinit``
receive.
"""

from __future__ import annotations

import inspect
import types
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..types import Pmt, PortId
from .buffer import StreamInput, StreamOutput
from .message_output import MessageOutputs
from .work_io import WorkIo

__all__ = ["Kernel", "BlockMeta", "message_handler"]


@dataclass
class BlockMeta:
    type_name: str = ""
    instance_name: str = ""
    blocking: bool = False
    id: int = -1


def message_handler(fn=None, *, name: Optional[str] = None):
    """Mark a method as a message-input handler.

    Signature: ``h(self, io: WorkIo, mio: MessageOutputs, meta: BlockMeta,
    pmt: Pmt) -> Pmt``, plain or ``async def``. A plain handler skips the
    per-message coroutine and may be called directly by a sender on the same
    event loop (``message_output.py``). The handler gets the live WorkIo, so
    it can set ``finished`` or ``call_again``."""

    def mark(f):
        f._message_handler_name = name or f.__name__
        return f

    return mark(fn) if fn is not None else mark


class Kernel:
    """Base class for all blocks. A kernel that keeps the base ``work`` is a
    pure message block."""

    #: run this block's event loop on a dedicated thread
    BLOCKING: bool = False

    def __init__(self, type_name: Optional[str] = None):
        self._stream_inputs: List[StreamInput] = []
        self._stream_outputs: List[StreamOutput] = []
        self._message_handlers: Dict[str, Callable] = {}
        self._handler_names = None       # index -> name cache (call_handler)
        self._mio = MessageOutputs([])
        self.meta = BlockMeta(type_name=type_name or type(self).__name__,
                              blocking=type(self).BLOCKING)
        # decorated handlers are kept by attribute name and bound when
        # called: a bound method stored on the kernel would make every kernel
        # a reference cycle, freed (with its CUDA resources) only when the
        # garbage collector gets to it, on whatever thread runs then
        for attr_name, member in inspect.getmembers(type(self), inspect.isfunction):
            hname = getattr(member, "_message_handler_name", None)
            if hname:
                self._message_handlers[hname] = attr_name
        # direct dispatch (message_output.py) may call a sync handler in the
        # sender's frame only where no work coroutine could interleave with it
        self._direct_ok = type(self).work is Kernel.work

    def _handler(self, name: str) -> Optional[Callable]:
        h = self._message_handlers.get(name)
        return getattr(self, h) if isinstance(h, str) else h

    def _sync_handler(self, name: str) -> Optional[Callable]:
        """The named handler if it is a plain (non-coroutine) function."""
        fn = self._handler(name)
        if fn is not None and not inspect.iscoroutinefunction(fn):
            return fn
        return None

    # -- port declaration ------------------------------------------------------
    def add_stream_input(self, name: str, dtype, min_items: int = 1,
                         preferred_buffer_size: Optional[int] = None) -> StreamInput:
        """``preferred_buffer_size``: the byte budget this port would like
        for its buffer (a real-time sink wants a short queue); the smallest
        preference of a buffer's ports replaces config ``buffer_size``."""
        port = StreamInput(name, dtype, min_items, preferred_buffer_size)
        self._stream_inputs.append(port)
        return port

    def add_stream_output(self, name: str, dtype, min_items: int = 1,
                          min_buffer_size: int = 0) -> StreamOutput:
        port = StreamOutput(name, dtype, min_items, min_buffer_size)
        self._stream_outputs.append(port)
        return port

    def add_inplace_input(self, name: str, dtype=None):
        """An in-place (device frame) input port (``buffer/circuit.py``)."""
        from .buffer.circuit import InplaceInput
        port = InplaceInput(name, dtype)
        self._stream_inputs.append(port)
        return port

    def add_inplace_output(self, name: str, dtype=None):
        """An in-place (device frame) output port (``buffer/circuit.py``)."""
        from .buffer.circuit import InplaceOutput
        port = InplaceOutput(name, dtype)
        self._stream_outputs.append(port)
        return port

    def add_message_input(self, name: str, handler: Callable) -> None:
        self._message_handlers[name] = handler
        self._handler_names = None

    def add_message_output(self, name: str) -> None:
        self._mio.add_port(name)

    # -- port lookup -----------------------------------------------------------
    @property
    def stream_inputs(self) -> List[StreamInput]:
        return self._stream_inputs

    @property
    def stream_outputs(self) -> List[StreamOutput]:
        return self._stream_outputs

    @property
    def mio(self) -> MessageOutputs:
        return self._mio

    def stream_input(self, id) -> StreamInput:
        return self._port(self._stream_inputs, id, "input")

    def stream_output(self, id) -> StreamOutput:
        return self._port(self._stream_outputs, id, "output")

    @staticmethod
    def _port(ports, id, kind):
        if isinstance(id, PortId):
            id = id.id
        if isinstance(id, int):
            try:
                return ports[id]
            except IndexError:
                raise KeyError(f"no stream {kind} #{id}") from None
        for p in ports:
            if p.name == id:
                return p
        raise KeyError(f"no stream {kind} named {id!r} (have {[p.name for p in ports]})")

    def message_input_names(self) -> List[str]:
        return list(self._message_handlers)

    async def call_handler(self, io: WorkIo, meta: BlockMeta, port, pmt: Pmt) -> Pmt:
        """Dispatch a message to the handler named (or numbered) ``port``;
        an unknown handler answers ``Pmt.invalid_value()``."""
        pid = port.id if isinstance(port, PortId) else port
        if isinstance(pid, int):
            names = self._handler_names
            if names is None:
                names = self._handler_names = tuple(self._message_handlers)
            try:
                pid = names[pid]
            except IndexError:
                return Pmt.invalid_value()
        handler = self._handler(pid)
        if handler is None:
            return Pmt.invalid_value()
        result = handler(io, self._mio, meta, pmt)
        if type(result) is types.CoroutineType or inspect.isawaitable(result):
            result = await result
        return result if isinstance(result, Pmt) else Pmt.from_py(result)

    def validate_ports(self) -> None:
        for p in self._stream_inputs:
            if p.reader is None:
                raise RuntimeError(
                    f"{self.meta.instance_name or self.meta.type_name}: "
                    f"input {p.name!r} not connected")

    # -- lifecycle -------------------------------------------------------------
    async def init(self, mio: MessageOutputs, meta: BlockMeta) -> None:
        pass

    async def work(self, io: WorkIo, mio: MessageOutputs, meta: BlockMeta) -> None:
        pass

    async def deinit(self, mio: MessageOutputs, meta: BlockMeta) -> None:
        pass

    # connect DSL: `fg.connect(a >> b >> c)`
    def __rshift__(self, other):
        from .flowgraph import Chain
        return Chain([self]) >> other

    def __repr__(self):
        nm = self.meta.instance_name or self.meta.type_name
        return f"<{nm}>"

"""The block base class: ``Kernel`` with async ``init``/``work``/``deinit``.

A reduced copy of ``futuresdr_tpu/runtime/kernel.py`` with stream ports only
(message ports are a later slice). Ports are declared in ``__init__`` with
``add_stream_input``/``add_stream_output``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .buffer import StreamInput, StreamOutput
from .work_io import WorkIo

__all__ = ["Kernel", "BlockMeta"]


@dataclass
class BlockMeta:
    type_name: str = ""
    instance_name: str = ""
    blocking: bool = False
    id: int = -1


class Kernel:
    """Base class for all blocks."""

    #: run this block's event loop on a dedicated thread
    BLOCKING: bool = False

    def __init__(self, type_name: str = ""):
        self._stream_inputs: List[StreamInput] = []
        self._stream_outputs: List[StreamOutput] = []
        self.meta = BlockMeta(type_name=type_name or type(self).__name__,
                              blocking=type(self).BLOCKING)

    def add_stream_input(self, name: str, dtype, min_items: int = 1) -> StreamInput:
        port = StreamInput(name, dtype, min_items)
        self._stream_inputs.append(port)
        return port

    def add_stream_output(self, name: str, dtype, min_items: int = 1,
                          min_buffer_size: int = 0) -> StreamOutput:
        port = StreamOutput(name, dtype, min_items, min_buffer_size)
        self._stream_outputs.append(port)
        return port

    @property
    def stream_inputs(self) -> List[StreamInput]:
        return self._stream_inputs

    @property
    def stream_outputs(self) -> List[StreamOutput]:
        return self._stream_outputs

    def stream_input(self, id) -> StreamInput:
        return self._port(self._stream_inputs, id, "input")

    def stream_output(self, id) -> StreamOutput:
        return self._port(self._stream_outputs, id, "output")

    @staticmethod
    def _port(ports, id, kind):
        if isinstance(id, int):
            try:
                return ports[id]
            except IndexError:
                raise KeyError(f"no stream {kind} #{id}") from None
        for p in ports:
            if p.name == id:
                return p
        raise KeyError(f"no stream {kind} named {id!r} (have {[p.name for p in ports]})")

    def validate_ports(self) -> None:
        for p in self._stream_inputs:
            if p.reader is None:
                raise RuntimeError(
                    f"{self.meta.instance_name or self.meta.type_name}: "
                    f"input {p.name!r} not connected")

    # lifecycle: the reference's signatures; ``mio`` (the message outputs)
    # is None until message ports are ported
    async def init(self, mio, meta: BlockMeta) -> None:
        pass

    async def work(self, io: WorkIo, mio, meta: BlockMeta) -> None:
        pass

    async def deinit(self, mio, meta: BlockMeta) -> None:
        pass

    # connect DSL: `fg.connect(a >> b >> c)`
    def __rshift__(self, other):
        from .flowgraph import Chain
        return Chain([self]) >> other

    def __repr__(self):
        nm = self.meta.instance_name or self.meta.type_name
        return f"<{nm}>"

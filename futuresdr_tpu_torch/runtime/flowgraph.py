"""Flowgraph: the graph container with typed stream and message connect.

A reduced copy of ``futuresdr_tpu/runtime/flowgraph.py``: ``connect`` is
idempotent on already-added blocks, stream connects are dtype-checked at
connect time, and buffers are materialized at launch with connect-time size
negotiation. ``fg.connect(a >> b >> c)`` chains default ports, an in-place
edge where both ports are in-place (device-frame) ports;
``fg.connect_stream(a, "out", b, "in")`` and ``fg.connect_inplace(a, "out",
b, "in")`` name them, and ``fg.connect_message(a, "out", b, "in")`` wires a message output to a
handler. A stream edge's writer class is ``connect_stream(..., buffer=cls)``,
else its output port's ``buffer``, else :func:`default_buffer`; its byte
budget is ``connect_stream(..., buffer_size=)``, else the smallest
``preferred_buffer_size`` of its output and input ports, else config
``buffer_size`` (:func:`~.buffer.negotiate_capacity` floors it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

from ..log import logger
from ..types import FlowgraphDescription
from .block import WrappedKernel
from .buffer import negotiate_capacity
from .buffer.ring import RingWriter
from .kernel import Kernel

__all__ = ["Flowgraph", "Chain", "ConnectError", "default_buffer"]

log = logger("runtime.flowgraph")


#: process-default stream buffer; None: the double-mapped circular buffer,
#: resolved at first use (its library builds then)
_DEFAULT_BUFFER: list = [None]


def default_buffer(cls=None):
    """The process's default stream buffer writer class; ``cls`` sets it.
    Unset, it is the double-mapped circular buffer, or the pure-Python ring
    (with one warning) where the circular buffer's library cannot build."""
    if cls is not None:
        _DEFAULT_BUFFER[0] = cls
    if _DEFAULT_BUFFER[0] is not None:
        return _DEFAULT_BUFFER[0]
    from .buffer import circular
    return circular.CircularWriter if circular.available() else RingWriter


class ConnectError(Exception):
    """Bad port name / dtype mismatch at connect time."""


class Chain:
    """Accumulator for the ``a >> b >> c`` stream-connect DSL."""

    def __init__(self, kernels: List[Kernel]):
        self.kernels = kernels

    def __rshift__(self, other) -> "Chain":
        if isinstance(other, Kernel):
            return Chain(self.kernels + [other])
        if isinstance(other, Chain):
            return Chain(self.kernels + other.kernels)
        return NotImplemented


@dataclass
class StreamEdge:
    src: Kernel
    src_port: str
    dst: Kernel
    dst_port: str
    buffer: Optional[type] = None       # BufferWriter subclass override
    buffer_size: Optional[int] = None   # this edge's byte budget (min_items
    #                                     and min_buffer_size still floor it)


@dataclass
class InplaceEdge:
    src: Kernel
    src_port: str
    dst: Kernel
    dst_port: str


@dataclass
class MessageEdge:
    src: Kernel
    src_port: str
    dst: Kernel
    dst_port: str


class Flowgraph:
    def __init__(self):
        self._blocks: List[Optional[WrappedKernel]] = []
        self._kernel_ids: dict = {}           # id(kernel) -> block id
        self.stream_edges: List[StreamEdge] = []
        self.message_edges: List[MessageEdge] = []
        self.inplace_edges: List[InplaceEdge] = []
        self._circuits: List[tuple] = []      # (Circuit, source kernel)
        self._launched = False

    def add(self, kernel: Kernel) -> Kernel:
        """Add a block; idempotent."""
        key = id(kernel)
        if key in self._kernel_ids:
            return kernel
        bid = len(self._blocks)
        self._blocks.append(WrappedKernel(kernel, bid))
        self._kernel_ids[key] = bid
        return kernel

    def block_id(self, kernel: Kernel) -> int:
        return self._kernel_ids[id(kernel)]

    def wrapped(self, kernel_or_id: Union[Kernel, int]) -> WrappedKernel:
        bid = kernel_or_id if isinstance(kernel_or_id, int) else self.block_id(kernel_or_id)
        blk = self._blocks[bid]
        if blk is None:
            raise RuntimeError("block currently taken by a running flowgraph")
        return blk

    def connect(self, *items) -> None:
        """Chain default ports: ``fg.connect(src, mid, snk)`` or ``fg.connect(src >> mid >> snk)``."""
        kernels: List[Kernel] = []
        for it in items:
            if isinstance(it, Chain):
                kernels.extend(it.kernels)
            elif isinstance(it, Kernel):
                kernels.append(it)
            else:
                raise ConnectError(f"cannot connect {it!r}")
        from .buffer.circuit import InplaceInput, InplaceOutput
        for a, b in zip(kernels, kernels[1:]):
            if not a.stream_outputs:
                raise ConnectError(f"{a!r} has no stream outputs")
            if not b.stream_inputs:
                raise ConnectError(f"{b!r} has no stream inputs")
            out, inp = a.stream_outputs[0], b.stream_inputs[0]
            # dispatch on the port kind: a stream edge over in-place ports
            # would deadlock the graph
            o_inpl, i_inpl = isinstance(out, InplaceOutput), isinstance(inp, InplaceInput)
            if o_inpl and i_inpl:
                self.connect_inplace(a, out.name, b, inp.name)
            elif o_inpl or i_inpl:
                raise ConnectError(
                    f"port kind mismatch: {a!r}.{out.name} -> {b!r}.{inp.name} "
                    f"connects an inplace port to a stream port")
            else:
                self.connect_stream(a, out.name, b, inp.name)

    def connect_stream(self, src: Kernel, src_port: str, dst: Kernel, dst_port: str,
                       buffer: Optional[type] = None,
                       buffer_size: Optional[int] = None) -> None:
        """Typed stream connect; ``buffer`` is the edge's writer class
        (default: the output port's, else :func:`default_buffer`).
        ``buffer_size`` overrides the edge's byte budget, the finest latency
        lever (a short buffer is a short queue); ``min_items`` and
        ``min_buffer_size`` still floor the capacity. The edges of one
        broadcast output share one buffer, so their overrides must agree. A
        fused native chain (``runtime/fastchain.py``) runs on its own rings
        and ignores it, as the reference's does."""
        self.add(src)
        self.add(dst)
        op = src.stream_output(src_port)   # raises on bad name
        ip = dst.stream_input(dst_port)
        from .buffer.circuit import InplaceInput, InplaceOutput
        if isinstance(op, InplaceOutput) or isinstance(ip, InplaceInput):
            raise ConnectError(
                f"{src!r}.{src_port} -> {dst!r}.{dst_port} involves an inplace "
                f"(frame-plane) port; use connect_inplace (or plain connect, "
                f"which dispatches on port kind)")
        if op.dtype is not None and ip.dtype is not None and op.dtype != ip.dtype:
            raise ConnectError(
                f"dtype mismatch: {src!r}.{src_port} is {op.dtype}, {dst!r}.{dst_port} is {ip.dtype}")
        if ip.reader is not None or any(
                e.dst is dst and e.dst_port == dst_port for e in self.stream_edges):
            raise ConnectError(f"input {dst!r}.{dst_port} already connected")
        self.stream_edges.append(
            StreamEdge(src, src_port, dst, dst_port, buffer, buffer_size))

    def connect_inplace(self, src: Kernel, src_port: str, dst: Kernel,
                        dst_port: str) -> None:
        """Connect an in-place (device frame) output to an in-place input;
        an output wired to several inputs broadcasts its frames."""
        self.add(src)
        self.add(dst)
        op = src.stream_output(src_port)
        ip = dst.stream_input(dst_port)
        if op.dtype is not None and ip.dtype is not None and op.dtype != ip.dtype:
            raise ConnectError(f"dtype mismatch on inplace edge {src_port}->{dst_port}")
        self.inplace_edges.append(InplaceEdge(src, src_port, dst, dst_port))

    def close_circuit(self, circuit, source: Kernel) -> None:
        """Close a host-frame circuit (``buffer/circuit.py`` :class:`Circuit`):
        a frame returned to its pool wakes ``source``."""
        self.add(source)
        self._circuits.append((circuit, source))

    def connect_message(self, src: Kernel, src_port: str, dst: Kernel, dst_port: str) -> None:
        """Wire message output ``src_port`` of ``src`` to handler ``dst_port``
        of ``dst``."""
        self.add(src)
        self.add(dst)
        if src_port not in src.mio.names:
            raise ConnectError(f"{src!r} has no message output {src_port!r}")
        if dst_port not in dst.message_input_names():
            raise ConnectError(f"{dst!r} has no message input {dst_port!r}")
        self.message_edges.append(MessageEdge(src, src_port, dst, dst_port))

    def _materialize(self) -> None:
        """Create one buffer per source port (1 writer → N readers broadcast)
        and wire the message outputs."""
        groups: dict = {}
        for e in self.stream_edges:
            groups.setdefault((id(e.src), e.src_port), []).append(e)
        for edges in groups.values():
            src = edges[0].src
            op = src.stream_output(edges[0].src_port)
            dst_ports = [e.dst.stream_input(e.dst_port) for e in edges]
            dtype = op.dtype or next((p.dtype for p in dst_ports if p.dtype is not None),
                                     np.dtype(np.uint8))
            sizes = {e.buffer_size for e in edges if e.buffer_size is not None}
            if len(sizes) > 1:
                raise ConnectError(f"conflicting buffer_size overrides on broadcast "
                                   f"output {src!r}.{edges[0].src_port}: {sizes}")
            # the edge's override wins, else the smallest preference of the
            # ports (a real-time sink wants a short queue), else config
            prefs = [p.preferred_buffer_size for p in [op] + dst_ports
                     if getattr(p, "preferred_buffer_size", None)]
            budget = sizes.pop() if sizes else (min(prefs) if prefs else None)
            cap = negotiate_capacity(dtype.itemsize,
                                     [op.min_items] + [p.min_items for p in dst_ports],
                                     [op.min_buffer_size], override_bytes=budget)
            overrides = {e.buffer for e in edges if e.buffer is not None}
            if len(overrides) > 1:
                raise ConnectError(f"conflicting buffer overrides on broadcast output "
                                   f"{src!r}.{edges[0].src_port}: {overrides}")
            buffer_cls = (overrides.pop() if overrides else None) or op.buffer \
                or default_buffer()
            writer = buffer_cls(dtype, cap, self.wrapped(src).inbox,
                                src.stream_outputs.index(op))
            op.writer = writer
            for e, ip in zip(edges, dst_ports):
                ip.reader = writer.add_reader(self.wrapped(e.dst).inbox,
                                              e.dst.stream_inputs.index(ip))
        # in-place (device frame) edges: no buffer, the ports queue frames
        for e in self.inplace_edges:
            op = e.src.stream_output(e.src_port)
            ip = e.dst.stream_input(e.dst_port)
            op.connect(ip)
            ip.bind(self.wrapped(e.dst).inbox, e.dst.stream_inputs.index(ip))
            ip.bind_producer(self.wrapped(e.src).inbox)
        for circuit, source in self._circuits:
            circuit.attach_source(self.wrapped(source).inbox)
        # message edges (the wrapped destination enables direct dispatch)
        for e in self.message_edges:
            dw = self.wrapped(e.dst)
            e.src.mio.connect(e.src_port, dw.inbox, e.dst_port, wrapped=dw)

    def take_blocks(self) -> List[WrappedKernel]:
        """Materialize and hand the blocks to the runtime."""
        if self._launched:
            raise RuntimeError("flowgraph already running")
        self._materialize()
        self._launched = True
        blocks = [b for b in self._blocks if b is not None]
        self._blocks = [None] * len(self._blocks)
        return blocks

    def restore_blocks(self, blocks: List[WrappedKernel]) -> None:
        """Put finished blocks back so final state is readable, and the
        flowgraph may run again."""
        for b in blocks:
            self._blocks[b.id] = b
        self._launched = False

    def describe(self, fg_id: int = 0) -> FlowgraphDescription:
        return FlowgraphDescription(
            id=fg_id,
            blocks=[b.description() for b in self._blocks if b is not None],
            stream_edges=[(self.block_id(e.src), e.src_port, self.block_id(e.dst),
                           e.dst_port) for e in self.stream_edges],
            message_edges=[(self.block_id(e.src), e.src_port, self.block_id(e.dst),
                            e.dst_port) for e in self.message_edges],
            # the last run's policy decisions (runtime.py), recovered or not
            policy_decisions=list(getattr(self, "_policy_decisions", ())))

    def __len__(self):
        return len(self._blocks)

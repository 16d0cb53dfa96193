"""Flowgraph: the graph container with typed stream connect.

A reduced copy of ``futuresdr_tpu/runtime/flowgraph.py`` (stream edges only):
``connect`` is idempotent on already-added blocks, stream connects are
dtype-checked at connect time, and ring buffers are materialized at launch
with connect-time size negotiation. ``fg.connect(a >> b >> c)`` chains
default ports; ``fg.connect_stream(a, "out", b, "in")`` names them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

from .block import WrappedKernel
from .buffer import negotiate_capacity
from .buffer.ring import RingWriter
from .kernel import Kernel

__all__ = ["Flowgraph", "Chain", "ConnectError"]


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


class Flowgraph:
    def __init__(self):
        self._blocks: List[Optional[WrappedKernel]] = []
        self._kernel_ids: dict = {}           # id(kernel) -> block id
        self.stream_edges: List[StreamEdge] = []
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
        for a, b in zip(kernels, kernels[1:]):
            if not a.stream_outputs:
                raise ConnectError(f"{a!r} has no stream outputs")
            if not b.stream_inputs:
                raise ConnectError(f"{b!r} has no stream inputs")
            self.connect_stream(a, a.stream_outputs[0].name, b, b.stream_inputs[0].name)

    def connect_stream(self, src: Kernel, src_port: str, dst: Kernel, dst_port: str) -> None:
        """Typed stream connect."""
        self.add(src)
        self.add(dst)
        op = src.stream_output(src_port)   # raises on bad name
        ip = dst.stream_input(dst_port)
        if op.dtype is not None and ip.dtype is not None and op.dtype != ip.dtype:
            raise ConnectError(
                f"dtype mismatch: {src!r}.{src_port} is {op.dtype}, {dst!r}.{dst_port} is {ip.dtype}")
        if ip.reader is not None or any(
                e.dst is dst and e.dst_port == dst_port for e in self.stream_edges):
            raise ConnectError(f"input {dst!r}.{dst_port} already connected")
        self.stream_edges.append(StreamEdge(src, src_port, dst, dst_port))

    def _materialize(self) -> None:
        """Create one ring per source port (1 writer → N readers broadcast)."""
        groups: dict = {}
        for e in self.stream_edges:
            groups.setdefault((id(e.src), e.src_port), []).append(e)
        for edges in groups.values():
            src = edges[0].src
            op = src.stream_output(edges[0].src_port)
            dst_ports = [e.dst.stream_input(e.dst_port) for e in edges]
            dtype = op.dtype or next((p.dtype for p in dst_ports if p.dtype is not None),
                                     np.dtype(np.uint8))
            cap = negotiate_capacity(dtype.itemsize,
                                     [op.min_items] + [p.min_items for p in dst_ports],
                                     [op.min_buffer_size])
            writer = RingWriter(dtype, cap, self.wrapped(src).inbox,
                                src.stream_outputs.index(op))
            op.writer = writer
            for e, ip in zip(edges, dst_ports):
                ip.reader = writer.add_reader(self.wrapped(e.dst).inbox,
                                              e.dst.stream_inputs.index(ip))

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
        """Put finished blocks back so final state is readable."""
        for b in blocks:
            self._blocks[b.id] = b

"""Stream I/O blocks: file, TCP, UDP, in-process channels.

A copy of ``futuresdr_tpu/blocks/io.py`` (reference: ``src/blocks/{file_source,
file_sink,tcp_source,tcp_sink,udp_source,blob_to_udp,channel_source,
channel_sink}.rs``). Network blocks use asyncio transports directly: the
runtime is an asyncio actor system, so the reference's async-std sockets map
1:1. The sinks drain until nothing is left before they honour end of stream,
since the pure-Python ring's slices stop at its wrap.
"""

from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np

from ..log import logger
from ..runtime.kernel import Kernel, message_handler
from ..types import Pmt

__all__ = ["FileSource", "FileSink", "TcpSource", "TcpSink", "UdpSource", "BlobToUdp",
           "ChannelSource", "ChannelSink"]

log = logger("blocks.io")


class FileSource(Kernel):
    """Stream items from a file (`file_source.rs`), optional repeat."""

    def __init__(self, path: str, dtype, repeat: bool = False, chunk_items: int = 1 << 16):
        super().__init__()
        self.path = path
        self.repeat = repeat
        self.chunk = chunk_items
        self._f = None
        self.output = self.add_stream_output("out", dtype)

    async def init(self, mio, meta):
        self._f = open(self.path, "rb")

    async def deinit(self, mio, meta):
        if self._f:
            self._f.close()

    async def work(self, io, mio, meta):
        out = self.output.slice()
        n = len(out)
        if n == 0:
            return
        itemsize = self.output.dtype.itemsize
        data = self._f.read(min(n, self.chunk) * itemsize)
        if not data:
            if self.repeat:
                self._f.seek(0)
                io.call_again = True
                return
            io.finished = True
            return
        k = len(data) // itemsize
        out[:k] = np.frombuffer(data[:k * itemsize], dtype=self.output.dtype)
        self.output.produce(k)
        io.call_again = True


class FileSink(Kernel):
    """Write stream items to a file (`file_sink.rs`)."""

    def __init__(self, path: str, dtype):
        super().__init__()
        self.path = path
        self._f = None
        self.input = self.add_stream_input("in", dtype)
        self.n_written = 0

    async def init(self, mio, meta):
        self._f = open(self.path, "wb")

    async def deinit(self, mio, meta):
        if self._f:
            self._f.flush()
            self._f.close()

    async def work(self, io, mio, meta):
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            self._f.write(inp.tobytes())
            self.n_written += len(inp)
            self.input.consume(len(inp))
        if finished:
            io.finished = True


class TcpSource(Kernel):
    """Read a byte/item stream from a TCP connection (`tcp_source.rs`). Connects as a
    client, or accepts one connection when ``listen=True``."""

    def __init__(self, host: str, port: int, dtype=np.uint8, listen: bool = False):
        super().__init__()
        self.host, self.port, self.listen = host, port, listen
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer = None
        self._server = None
        self._tail = b""
        self.output = self.add_stream_output("out", dtype)

    async def init(self, mio, meta):
        # bind in init, but accept lazily in work: blocking the init barrier on a peer
        # that connects only after launch would deadlock the whole flowgraph
        if self.listen:
            self._accept_fut = asyncio.get_running_loop().create_future()

            async def on_conn(r, w):
                if not self._accept_fut.done():
                    self._accept_fut.set_result((r, w))

            self._server = await asyncio.start_server(on_conn, self.host, self.port)
        else:
            self._reader, self._writer = await asyncio.open_connection(self.host, self.port)

    async def deinit(self, mio, meta):
        if self._writer:
            self._writer.close()
        if self._server:
            self._server.close()

    async def work(self, io, mio, meta):
        if self._reader is None:
            self._reader, self._writer = await self._accept_fut
        out = self.output.slice()
        if len(out) == 0:
            return
        itemsize = self.output.dtype.itemsize
        data = await self._reader.read(len(out) * itemsize - len(self._tail))
        if not data and self._reader.at_eof():
            io.finished = True
            return
        buf = self._tail + data
        k = len(buf) // itemsize
        if k:
            out[:k] = np.frombuffer(buf[:k * itemsize], dtype=self.output.dtype)
            self.output.produce(k)
        self._tail = buf[k * itemsize:]
        io.call_again = True


class TcpSink(Kernel):
    """Write the stream to a TCP connection (`tcp_sink.rs`)."""

    def __init__(self, host: str, port: int, dtype=np.uint8, listen: bool = False):
        super().__init__()
        self.host, self.port, self.listen = host, port, listen
        self._writer: Optional[asyncio.StreamWriter] = None
        self._server = None
        self.input = self.add_stream_input("in", dtype)

    async def init(self, mio, meta):
        if self.listen:
            self._accept_fut = asyncio.get_running_loop().create_future()

            async def on_conn(r, w):
                if not self._accept_fut.done():
                    self._accept_fut.set_result((r, w))

            self._server = await asyncio.start_server(on_conn, self.host, self.port)
        else:
            _, self._writer = await asyncio.open_connection(self.host, self.port)

    async def deinit(self, mio, meta):
        if self._writer:
            try:
                await self._writer.drain()
                self._writer.close()
            except Exception:
                pass
        if self._server:
            self._server.close()

    async def work(self, io, mio, meta):
        if self._writer is None:
            _, self._writer = await self._accept_fut
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            self._writer.write(inp.tobytes())
            await self._writer.drain()
            self.input.consume(len(inp))
        if finished:
            io.finished = True


class _UdpProto(asyncio.DatagramProtocol):
    def __init__(self, queue: asyncio.Queue, event: asyncio.Event):
        self.queue = queue
        self.event = event

    def datagram_received(self, data, addr):
        try:
            self.queue.put_nowait(data)
            self.event.set()
        except asyncio.QueueFull:
            pass  # drop on overrun, like a real radio


class UdpSource(Kernel):
    """Receive UDP datagrams as a sample stream (`udp_source.rs`)."""

    def __init__(self, bind: str, port: int, dtype=np.uint8, queue_size: int = 256):
        super().__init__()
        self.bind, self.port = bind, port
        self._queue: asyncio.Queue = None
        self._event: asyncio.Event = None
        self._transport = None
        self._tail = b""
        self._qsize = queue_size
        self.output = self.add_stream_output("out", dtype)

    async def init(self, mio, meta):
        self._queue = asyncio.Queue(self._qsize)
        self._event = asyncio.Event()
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpProto(self._queue, self._event),
            local_addr=(self.bind, self.port))

    async def deinit(self, mio, meta):
        if self._transport:
            self._transport.close()

    async def work(self, io, mio, meta):
        # never await the socket inside work (it would starve Terminate handling);
        # drain what's there and park on the arrival event via block_on
        out = self.output.slice()
        if len(out) == 0:
            return
        self._event.clear()
        produced = 0
        buf = self._tail
        while not self._queue.empty():
            buf += self._queue.get_nowait()
        itemsize = self.output.dtype.itemsize
        k = min(len(buf) // itemsize, len(out))
        if k:
            out[:k] = np.frombuffer(buf[:k * itemsize], dtype=self.output.dtype)
            self.output.produce(k)
        self._tail = buf[k * itemsize:]
        if not self._queue.empty():
            io.call_again = True
        else:
            io.block_on(self._event.wait())


class BlobToUdp(Kernel):
    """Send each Blob message as a UDP datagram (`blob_to_udp.rs`)."""

    def __init__(self, host: str, port: int):
        super().__init__()
        self.host, self.port = host, port
        self._transport = None

    async def init(self, mio, meta):
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: asyncio.DatagramProtocol(), remote_addr=(self.host, self.port))

    async def deinit(self, mio, meta):
        if self._transport:
            self._transport.close()

    @message_handler(name="in")
    async def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        try:
            self._transport.sendto(p.to_blob())
        except Exception:
            return Pmt.invalid_value()
        return Pmt.ok()


class ChannelSource(Kernel):
    """Feed samples pushed from outside (an asyncio queue) into the flowgraph
    (`channel_source.rs`). Push ``None`` for EOS."""

    def __init__(self, dtype, queue: Optional[asyncio.Queue] = None):
        super().__init__()
        self.queue = queue or asyncio.Queue()
        self._carry: Optional[np.ndarray] = None
        self.output = self.add_stream_output("out", dtype)

    async def work(self, io, mio, meta):
        out = self.output.slice()
        if len(out) == 0:
            return
        if self._carry is None:
            item = await self.queue.get()
            if item is None:
                io.finished = True
                return
            self._carry = np.asarray(item, dtype=self.output.dtype)
        k = min(len(out), len(self._carry))
        out[:k] = self._carry[:k]
        self.output.produce(k)
        self._carry = self._carry[k:] if k < len(self._carry) else None
        io.call_again = True


class ChannelSink(Kernel):
    """Push received chunks into an asyncio queue (`channel_sink.rs`)."""

    def __init__(self, dtype, queue: Optional[asyncio.Queue] = None):
        super().__init__()
        self.queue = queue or asyncio.Queue()
        self.input = self.add_stream_input("in", dtype)

    async def work(self, io, mio, meta):
        finished = self.input.finished()
        while True:
            inp = self.input.slice()
            if not len(inp):
                break
            await self.queue.put(inp.copy())
            self.input.consume(len(inp))
        if finished:
            await self.queue.put(None)
            io.finished = True

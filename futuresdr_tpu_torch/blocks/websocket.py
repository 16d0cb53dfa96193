"""WebSocket sinks feeding GUIs (waterfall, constellation, time sink).

The counterpart of ``futuresdr_tpu/blocks/websocket.py`` (reference:
``src/blocks/{websocket_sink,websocket_pmt_sink}.rs``): a server that pushes
the latest stream chunk (or each Pmt) to every connected client. The server
is RFC 6455 on the standard library (``asyncio.start_server``; the
reference's ``websockets`` package is not a dependency of the port): the
``Sec-WebSocket-Accept`` handshake, unmasked server frames with 7-, 16- and
64-bit lengths (binary for stream chunks, text for Pmt JSON), ping answered
with pong, and the close handshake. A client that takes longer than
``DRAIN_TIMEOUT_S`` to take one frame is dropped. Bind port 0 to take a
free port; ``bound_port`` holds the bound one once ``init`` has run.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
from typing import Optional, Set

from ..log import logger
from ..runtime.kernel import Kernel, message_handler
from ..types import Pmt

__all__ = ["WebsocketSink", "WebsocketPmtSink", "frame", "accept_key"]

log = logger("blocks.websocket")

_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x1, 0x2, 0x8, 0x9, 0xA


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1(key.encode() + _GUID).digest()).decode()


def frame(payload: bytes, opcode: int = OP_BINARY) -> bytes:
    """One unmasked, final server frame."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x80 | opcode, n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack("!BBQ", 0x80 | opcode, 127, n)
    return head + payload


async def _read_frame(reader: asyncio.StreamReader):
    """One client frame: ``(opcode, payload)``, unmasked."""
    b0, b1 = await reader.readexactly(2)
    n = b1 & 0x7F
    if n == 126:
        n, = struct.unpack("!H", await reader.readexactly(2))
    elif n == 127:
        n, = struct.unpack("!Q", await reader.readexactly(8))
    mask = await reader.readexactly(4) if b1 & 0x80 else b"\0\0\0\0"
    data = await reader.readexactly(n)
    return b0 & 0x0F, bytes(c ^ mask[i % 4] for i, c in enumerate(data))


class _Client:
    #: seconds a client may take to drain one frame before it is dropped (a
    #: stalled GUI must not stall the stream, nor its shutdown)
    DRAIN_TIMEOUT_S = 5.0

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.lock = asyncio.Lock()     # one frame at a time on the socket

    async def send(self, data: bytes) -> None:
        async with self.lock:
            self.writer.write(data)
            await asyncio.wait_for(self.writer.drain(), self.DRAIN_TIMEOUT_S)


class _WsServerMixin:
    """The server shared by both sinks; it runs on the block's event loop."""

    async def _start_ws(self, port: int, host: str = "0.0.0.0"):
        self._clients: Set[_Client] = set()
        self._server = await asyncio.start_server(self._ws_session, host, port)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        log.info("websocket sink listening on %s:%d", host, self.bound_port)

    async def _stop_ws(self):
        server: Optional[asyncio.AbstractServer] = getattr(self, "_server", None)
        if server is None:
            return
        server.close()
        for c in list(self._clients):
            try:
                await asyncio.wait_for(c.send(frame(struct.pack("!H", 1001), OP_CLOSE)), 1.0)
            except (ConnectionError, asyncio.TimeoutError):
                pass
            c.writer.close()
        self._clients.clear()

    async def _ws_session(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        client = None
        try:
            head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
            headers = {}
            for line in head.split("\r\n")[1:]:
                k, sep, v = line.partition(":")
                if sep:
                    headers[k.strip().lower()] = v.strip()
            key = headers.get("sec-websocket-key")
            if "websocket" not in headers.get("upgrade", "").lower() or not key:
                writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n"
                             b"Connection: close\r\n\r\n")
                await writer.drain()
                return
            writer.write(("HTTP/1.1 101 Switching Protocols\r\n"
                          "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                          f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n").encode())
            await writer.drain()
            client = _Client(writer)
            self._clients.add(client)
            while True:
                opcode, payload = await _read_frame(reader)
                if opcode == OP_CLOSE:
                    self._clients.discard(client)
                    await client.send(frame(payload[:2], OP_CLOSE))
                    return
                if opcode == OP_PING:
                    await client.send(frame(payload, OP_PONG))
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            pass
        finally:
            if client is not None:
                self._clients.discard(client)
            writer.close()

    async def _broadcast(self, data: bytes) -> None:
        """Send one frame to every client; a client that fails is dropped."""
        for c in list(self._clients):
            try:
                await c.send(data)
            except (ConnectionError, asyncio.TimeoutError):
                self._clients.discard(c)
                c.writer.close()


class WebsocketSink(Kernel, _WsServerMixin):
    """Push fixed-size binary chunks of the stream to WS clients (`websocket_sink.rs`).

    ``mode``: "drop" sends only the latest chunk per send opportunity (GUI rate),
    "block" sends every chunk.
    """

    def __init__(self, port: int, dtype, chunk_items: int = 2048, mode: str = "drop"):
        super().__init__()
        if mode not in ("drop", "block"):
            raise ValueError(f"mode {mode!r}: want 'drop' or 'block'")
        self.port = port
        self.bound_port: Optional[int] = None
        self.chunk = chunk_items
        self.mode = mode
        self.input = self.add_stream_input("in", dtype, min_items=chunk_items)

    async def init(self, mio, meta):
        await self._start_ws(self.port)

    async def deinit(self, mio, meta):
        await self._stop_ws()

    async def work(self, io, mio, meta):
        inp = self.input.slice()
        n = (len(inp) // self.chunk) * self.chunk
        if n:
            if self._clients:
                if self.mode == "drop":
                    await self._broadcast(frame(inp[n - self.chunk:n].tobytes()))
                else:
                    for i in range(0, n, self.chunk):
                        await self._broadcast(frame(inp[i:i + self.chunk].tobytes()))
            self.input.consume(n)
        # available() re-reads the buffer: the ring's slices stop at its wrap
        if self.input.finished() and self.input.available() < self.chunk:
            io.finished = True
        elif n:
            io.call_again = True


class WebsocketPmtSink(Kernel, _WsServerMixin):
    """Push received Pmts to WS clients as JSON text frames (`websocket_pmt_sink.rs`)."""

    def __init__(self, port: int):
        super().__init__()
        self.port = port
        self.bound_port: Optional[int] = None

    async def init(self, mio, meta):
        await self._start_ws(self.port)

    async def deinit(self, mio, meta):
        await self._stop_ws()

    @message_handler(name="in")
    async def in_handler(self, io, mio, meta, p: Pmt) -> Pmt:
        if p.is_finished():
            io.finished = True
            return Pmt.ok()
        await self._broadcast(frame(json.dumps(p.to_json()).encode(), OP_TEXT))
        return Pmt.ok()

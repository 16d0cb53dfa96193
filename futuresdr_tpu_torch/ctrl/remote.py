"""Typed async HTTP client for the REST control plane.

A copy of ``futuresdr_tpu/ctrl/remote.py`` (the reference's
``crates/remote/src/remote.rs:17-291``): ``Remote → RemoteFlowgraph →
RemoteBlock.call/callback`` over the control port's routes, with the same
names, JSON bodies (the externally tagged Pmt JSON) and async API. Where the
reference opens an ``aiohttp`` session a request, this client speaks
HTTP/1.1 over ``asyncio.open_connection`` with ``Connection: close``, so it
needs nothing beyond the standard library. A status outside 2xx raises
:class:`RemoteError`, as aiohttp's ``raise_for_status`` does.
"""

from __future__ import annotations

import asyncio
import json
from typing import List, Optional
from urllib.parse import urlsplit

from ..types import Pmt

__all__ = ["Connection", "Remote", "RemoteBlock", "RemoteError", "RemoteFlowgraph"]

#: seconds a request may take (aiohttp's default total timeout)
TIMEOUT_S = 300.0


class RemoteError(RuntimeError):
    """A response outside 2xx: ``status`` and the raw ``body``."""

    def __init__(self, status: int, reason: str, url: str, body: bytes = b""):
        super().__init__(f"{status} {reason} from {url}")
        self.status = status
        self.body = body


class Remote:
    """The control port at ``url`` (``http://host:port``)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        parts = urlsplit(self.url)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"not an http URL: {url!r}")
        self._host = parts.hostname
        self._port = parts.port or 80
        self._prefix = parts.path

    async def _request(self, method: str, path: str, body=None):
        data = b"" if body is None else json.dumps(body).encode()
        head = (f"{method} {self._prefix}{path} HTTP/1.1\r\n"
                f"Host: {self._host}:{self._port}\r\n"
                "Accept: application/json\r\n"
                "Connection: close\r\n")
        if body is not None:
            head += "Content-Type: application/json\r\n"
        head += f"Content-Length: {len(data)}\r\n\r\n"
        reader, writer = await asyncio.open_connection(self._host, self._port)
        try:
            writer.write(head.encode("latin-1") + data)
            await writer.drain()
            raw = await reader.read()          # the server closes after its answer
        finally:
            writer.close()
        head, sep, payload = raw.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status_line = lines[0].split(" ", 2)
        if not sep or len(status_line) < 2 or not status_line[0].startswith("HTTP/"):
            raise RemoteError(0, "malformed response", self.url + path, raw)
        status = int(status_line[1])
        for line in lines[1:]:
            k, _, v = line.partition(":")
            if k.strip().lower() == "content-length":
                payload = payload[:int(v)]
        if not 200 <= status < 300:
            raise RemoteError(status, status_line[2] if len(status_line) > 2 else "",
                              self.url + path, payload)
        return json.loads(payload)

    async def _get(self, path: str):
        return await asyncio.wait_for(self._request("GET", path), TIMEOUT_S)

    async def _post(self, path: str, body):
        return await asyncio.wait_for(self._request("POST", path, body), TIMEOUT_S)

    async def flowgraphs(self) -> List["RemoteFlowgraph"]:
        ids = await self._get("/api/fg/")
        return [RemoteFlowgraph(self, i) for i in ids]

    async def flowgraph(self, fg_id: int = 0) -> "RemoteFlowgraph":
        return RemoteFlowgraph(self, fg_id)


class Connection:
    """A typed edge of the remote flowgraph (`remote.rs:246-291`)."""

    def __init__(self, kind: str, src: "RemoteBlock", src_port, dst: "RemoteBlock",
                 dst_port):
        self.kind = kind                      # "stream" | "message"
        self.src, self.src_port = src, src_port
        self.dst, self.dst_port = dst, dst_port

    def __repr__(self):
        return (f"Connection({self.kind}: {self.src.instance_name}.{self.src_port} → "
                f"{self.dst.instance_name}.{self.dst_port})")


class RemoteFlowgraph:
    def __init__(self, remote: Remote, fg_id: int):
        self.remote = remote
        self.id = fg_id

    async def description(self) -> dict:
        return await self.remote._get(f"/api/fg/{self.id}/")

    async def blocks(self) -> List["RemoteBlock"]:
        desc = await self.description()
        return [RemoteBlock(self, b["id"], b) for b in desc["blocks"]]

    async def block(self, block_id: int) -> "RemoteBlock":
        desc = await self.remote._get(f"/api/fg/{self.id}/block/{block_id}/")
        return RemoteBlock(self, block_id, desc)

    async def connections(self) -> List[Connection]:
        """Typed stream + message edges (`remote.rs` Connection/ConnectionType)."""
        desc = await self.description()
        by_id = {b["id"]: RemoteBlock(self, b["id"], b) for b in desc["blocks"]}
        out: List[Connection] = []
        for kind, key in (("stream", "stream_edges"), ("message", "message_edges")):
            for s, sp, d, dp in desc.get(key, []):
                out.append(Connection(kind, by_id[s], sp, by_id[d], dp))
        return out


class RemoteBlock:
    def __init__(self, fg: RemoteFlowgraph, block_id: int, description: Optional[dict] = None):
        self.fg = fg
        self.id = block_id
        self.description = description or {}

    @property
    def instance_name(self) -> str:
        return self.description.get("instance_name", f"block{self.id}")

    @property
    def type_name(self) -> str:
        return self.description.get("type_name", "")

    def handlers(self) -> List[str]:
        """Names of the block's message handlers, addressable by name or index
        (`remote.rs` Handler::Name/Handler::Id)."""
        return list(self.description.get("message_inputs", []))

    async def call(self, handler) -> Pmt:
        """Call with ``Pmt::Null``, the get-style form (`remote.rs:211-214`:
        `call` delegates to `callback` with Null)."""
        return await self.callback(handler, Pmt.null())

    async def callback(self, handler, pmt: Pmt = None) -> Pmt:
        """Call a handler (by name or index) with ``pmt``; returns the reply."""
        if pmt is None:
            pmt = Pmt.null()
        pmt = Pmt.from_py(pmt) if not isinstance(pmt, Pmt) else pmt
        r = await self.fg.remote._post(
            f"/api/fg/{self.fg.id}/block/{self.id}/call/{handler}/", pmt.to_json())
        return Pmt.from_json(r)

    def __repr__(self):
        return f"{self.instance_name} ({self.type_name}, {self.id})"

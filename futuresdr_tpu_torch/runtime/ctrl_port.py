"""REST control port: the running flowgraphs over HTTP/1.1.

The counterpart of ``futuresdr_tpu/runtime/ctrl_port.py``'s flowgraph
routes, on the standard library only (``asyncio.start_server``; the
reference's aiohttp is not a dependency of the port). A server on its own
thread and event loop answers:

  GET  /api/fg/                                   → list of flowgraph ids
  GET  /api/fg/{fg}/                              → FlowgraphDescription
  GET  /api/fg/{fg}/metrics/                      → per-block metrics
  GET  /api/fg/{fg}/block/{blk}/                  → BlockDescription
  GET  /api/fg/{fg}/block/{blk}/call/{handler}/   → call with Pmt::Null
  POST /api/fg/{fg}/block/{blk}/call/{handler}/   → call with a JSON-Pmt body

with the reference's JSON bodies (``json.dumps`` of the same objects) and
status codes: 404 ``{"error": "flowgraph not found"}`` or ``{"error":
"block not found"}``, 400 ``{"error": "bad pmt: …"}``, and 404/405 text for
an unknown path or method. Every response carries
``Access-Control-Allow-Origin: *`` and ``Connection: close`` (no
keep-alive). Pmt values use the reference's externally tagged JSON. Bind
port 0 to take a free port; :attr:`ControlPort.port` holds the bound one.

Also mounted: the serving plane's session routes, ``/healthz`` and
``/readyz`` (``serve/api.py``), and ``GET /metrics``, the Prometheus
registry's text (``telemetry/prom.py``; the reference's per-block families
are not rendered yet).

Not ported (ROADMAP Queue 1 item 4b): trace, doctor, profile, lineage,
events, host, fleet and the GUI page.
"""

from __future__ import annotations

import asyncio
import json
import re
import threading
from http import HTTPStatus
from typing import Optional, Tuple

from ..config import config
from ..log import logger
from ..types import Pmt

__all__ = ["ControlPort"]

log = logger("ctrl_port")

_MAX_HEAD = 64 * 1024
_MAX_BODY = 16 * 1024 * 1024

_FG = r"^/api/fg/(?P<fg>[^/]+)/"
_ROUTES = (
    (("GET",), re.compile(r"^/api/fg/$"), "_list_fgs"),
    (("GET",), re.compile(_FG + r"$"), "_describe_fg"),
    (("GET",), re.compile(_FG + r"metrics/$"), "_metrics"),
    (("GET",), re.compile(_FG + r"block/(?P<blk>[^/]+)/$"), "_describe_block"),
    (("GET", "POST"),
     re.compile(_FG + r"block/(?P<blk>[^/]+)/call/(?P<handler>[^/]+)/$"), "_call"),
    (("GET",), re.compile(r"^/metrics/?$"), "_prom_metrics"),
)


def _response(status: int, body: bytes, content_type: str,
              headers: Optional[dict] = None) -> bytes:
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    head = (f"HTTP/1.1 {status} {HTTPStatus(status).phrase}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}"
            "Access-Control-Allow-Origin: *\r\n"
            "Connection: close\r\n\r\n")
    return head.encode("latin-1") + body


def _json(obj, status: int = 200) -> Tuple[int, bytes, str]:
    return status, json.dumps(obj).encode(), "application/json; charset=utf-8"


def _text(status: int) -> Tuple[int, bytes, str]:
    return status, f"{status}: {HTTPStatus(status).phrase}".encode(), \
        "text/plain; charset=utf-8"


class ControlPort:
    """The REST server over a :class:`~.runtime.RuntimeHandle`; ``bind`` is
    ``host:port`` (default config ``ctrlport_bind``)."""

    def __init__(self, runtime_handle, bind: Optional[str] = None):
        self.handle = runtime_handle
        host, _, port = (bind or config().ctrlport_bind).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 1337)
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._error: Optional[BaseException] = None

    # -- lifecycle (own thread and loop) -----------------------------------------
    def start(self) -> None:
        """Start serving; returns once the socket listens (raises if it
        could not bind)."""
        if self._thread is not None:
            return
        self._started.clear()
        self._error = None

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(self._serve, self.host, self.port))
                self.port = self._server.sockets[0].getsockname()[1]
            except OSError as e:
                self._error = e
                self._started.set()
                loop.close()
                return
            self._started.set()
            try:
                loop.run_forever()
            finally:
                self._server.close()
                loop.run_until_complete(self._server.wait_closed())
                loop.close()

        self._thread = threading.Thread(target=run, name="fsdr-ctrlport", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        if self._error is not None:
            self._thread = None
            raise self._error
        log.info("control port listening on %s:%d", self.host, self.port)

    def stop(self) -> None:
        if self._loop is not None and self._thread is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- HTTP ----------------------------------------------------------------------
    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                return
            lines = head.decode("latin-1").split("\r\n")
            parts = lines[0].split(" ")
            if len(parts) != 3 or len(head) > _MAX_HEAD:
                writer.write(_response(*_text(400)))
                return
            method, target = parts[0], parts[1]
            headers = {}
            for line in lines[1:]:
                k, sep, v = line.partition(":")
                if sep:
                    headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length", "0") or 0)
            if length > _MAX_BODY:
                writer.write(_response(*_text(413)))
                return
            body = await reader.readexactly(length) if length else b""
            try:
                got = await self._route(method, target.split("?")[0], body)
            except Exception as e:                 # noqa: BLE001 — a route's bug
                log.error("control port %s %s failed: %r", method, target, e)
                got = _text(500)
            writer.write(_response(*got))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            writer.close()

    async def _route(self, method: str, path: str, body: bytes):
        from ..serve import api as serve_api
        allowed = False
        table = [(ms, pat, getattr(self, name)) for ms, pat, name in _ROUTES]
        table += serve_api.routes()
        for methods, pattern, handler in table:
            m = pattern.match(path)
            if m is None:
                continue
            if method not in methods:
                allowed = True
                continue
            return await handler(method, body, **m.groupdict())
        return _text(405 if allowed else 404)

    async def _prom_metrics(self, method, body):
        from ..telemetry import prom
        return 200, prom.render_all().encode(), prom.CONTENT_TYPE

    def _fg(self, fg: str):
        try:
            return self.handle.get_flowgraph(int(fg))
        except ValueError:
            return None

    async def _list_fgs(self, method, body):
        return _json(self.handle.flowgraph_ids())

    async def _describe_fg(self, method, body, fg):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        return _json((await h.describe()).to_json())

    async def _metrics(self, method, body, fg):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        return _json(await h.metrics())

    async def _describe_block(self, method, body, fg, blk):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        desc = await h.describe()
        for b in desc.blocks:
            if str(b.id) == blk:
                return _json(b.to_json())
        return _json({"error": "block not found"}, 404)

    async def _call(self, method, body, fg, blk, handler):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        try:
            blk_id = int(blk)
        except ValueError:
            return _json({"error": "block not found"}, 404)
        try:
            handler = int(handler)
        except ValueError:
            pass
        if method == "POST":
            try:
                pmt = Pmt.from_json(json.loads(body))
            except Exception as e:                 # noqa: BLE001 — bad client JSON
                return _json({"error": f"bad pmt: {e}"}, 400)
        else:
            pmt = Pmt.null()
        result = await h.call(blk_id, handler, pmt)
        return _json(result.to_json())

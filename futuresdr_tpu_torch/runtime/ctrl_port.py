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
  GET  /api/fg/{fg}/trace/                        → drain the span rings as a
                                                    Chrome trace (?keep=1: peek)
  GET  /api/fg/{fg}/doctor/                       → flight record + report
                                                    (?md=1: markdown)
  GET  /api/fg/{fg}/profile/                      → the profile plane
                                                    (?costs=1: count the costs)
  GET  /api/fg/{fg}/lineage/                      → tail report + records (?n=)
  GET  /api/events/                               → the journal (?since=, ?cat=,
                                                    ?limit=)
  GET  /api/host/                                 → this host's fleet export
  GET  /api/fleet/                                → the fleet view (404 with no
                                                    fleet_peers)
  GET  /api/fleet/metrics                         → the fleet's merged /metrics
  POST /api/fleet/serve/{app}/session/            → a pressure-routed admission
  GET  /                                          → the GUI page (index.html)
  GET  /static/{path}                             → a file of the GUI directory

with the reference's JSON bodies (``json.dumps`` of the same objects) and
status codes: 404 ``{"error": "flowgraph not found"}`` or ``{"error":
"block not found"}``, 400 ``{"error": "bad pmt: …"}``, and 404/405 text for
an unknown path or method. Every response carries
``Access-Control-Allow-Origin: *`` and ``Connection: close`` (no
keep-alive). Pmt values use the reference's externally tagged JSON. Bind
port 0 to take a free port; :attr:`ControlPort.port` holds the bound one.

Also mounted: the serving plane's session routes, ``/healthz`` and
``/readyz`` (``serve/api.py``), and ``GET /metrics``, the Prometheus
registry's text with every live flowgraph's per-block families
(``telemetry/prom.py``; ``?openmetrics=1`` adds the lineage exemplars). The
telemetry routes read process-global planes (``telemetry/``), so any live
flowgraph id answers them (an unknown one is a 404, as in the reference);
the fleet view starts with the first control port when config
``fleet_peers`` is set.

Own routes (``Runtime(extra_routes=…)``, the reference's
``Runtime::with_custom_routes``): ``(method, path, handler)`` tuples mounted
after the routes above. A path segment ``{name}`` matches one segment and
lands in ``request.match_info``. The handler, plain or ``async``, gets a
:class:`Request` (``method``, ``path``, ``query``, ``body``,
``match_info``, ``json()``) and returns a ``(status, body, content_type)``
tuple, a ``dict`` or ``list`` (JSON, 200), a ``str`` (``text/html``, 200) or
``bytes`` (200). It runs on the control port's event loop, from which
``Runtime.start_async`` may launch another flowgraph.

The GUI routes are matched after the own routes, as the reference mounts
them after its ``extra_routes``. They serve config ``frontend_path`` (the
package's ``gui/`` when empty) as the reference's aiohttp ``add_static``
does: a content type from the file's extension, 404 with an empty body for
a file that is not there, 403 for the directory itself, and 404 for any
path that resolves outside the directory (``..``, percent-encoded dots or
slashes, a symbolic link that leads out).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import mimetypes
import os
import re
import threading
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import Optional, Tuple
from urllib.parse import parse_qsl, unquote

from ..config import config
from ..log import logger
from ..types import Pmt

__all__ = ["ControlPort", "Request"]

log = logger("ctrl_port")

_MAX_HEAD = 64 * 1024


def parse_qs(qs: str) -> dict:
    """A query string's parameters, the last value of each."""
    return dict(parse_qsl(qs, keep_blank_values=True))
_MAX_BODY = 16 * 1024 * 1024

_FG = r"^/api/fg/(?P<fg>[^/]+)/"
_ROUTES = (
    (("GET",), re.compile(r"^/api/fg/$"), "_list_fgs"),
    (("GET",), re.compile(_FG + r"$"), "_describe_fg"),
    (("GET",), re.compile(_FG + r"metrics/$"), "_metrics"),
    (("GET",), re.compile(_FG + r"trace/$"), "_trace"),
    (("GET",), re.compile(_FG + r"doctor/$"), "_doctor"),
    (("GET",), re.compile(_FG + r"profile/$"), "_profile"),
    (("GET",), re.compile(_FG + r"lineage/$"), "_lineage"),
    (("GET",), re.compile(r"^/api/events/$"), "_events"),
    (("GET",), re.compile(r"^/api/host/$"), "_host_summary"),
    (("GET",), re.compile(r"^/api/fleet/$"), "_fleet"),
    (("GET",), re.compile(r"^/api/fleet/metrics$"), "_fleet_metrics"),
    (("POST",), re.compile(r"^/api/fleet/serve/(?P<app>[^/]+)/session/$"), "_fleet_admit"),
    (("GET",), re.compile(_FG + r"block/(?P<blk>[^/]+)/$"), "_describe_block"),
    (("GET", "POST"),
     re.compile(_FG + r"block/(?P<blk>[^/]+)/call/(?P<handler>[^/]+)/$"), "_call"),
    (("GET",), re.compile(r"^/metrics/?$"), "_prom_metrics"),
)
#: the GUI's routes, matched after the own routes
_GUI_ROUTES = (
    (("GET",), re.compile(r"^/$"), "_gui_index"),
    (("GET",), re.compile(r"^/static(?:/(?P<rel>.*))?$"), "_gui_static"),
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


def _json(obj, status: int = 200, headers: Optional[dict] = None):
    # default=str: span args and extra_metrics may carry numpy scalars
    out = (status, json.dumps(obj, default=str).encode(), "application/json; charset=utf-8")
    return out + (headers,) if headers else out


def _text(status: int) -> Tuple[int, bytes, str]:
    return status, f"{status}: {HTTPStatus(status).phrase}".encode(), \
        "text/plain; charset=utf-8"


@dataclass
class Request:
    """What an own route's handler gets: the request and the path's
    ``{name}`` segments (``match_info``)."""

    method: str
    path: str
    query: dict
    body: bytes
    match_info: dict = field(default_factory=dict)

    def json(self):
        return json.loads(self.body) if self.body else None


def _frontend_dir() -> Optional[str]:
    """The GUI directory: config ``frontend_path``, else the package's own
    ``gui/`` (None where the package has none); a configured path that is
    not a directory raises."""
    path = config().frontend_path
    if not path:
        builtin = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "gui")
        return os.path.realpath(builtin) if os.path.isdir(builtin) else None
    if not os.path.isdir(path):
        raise ValueError(f"frontend_path {path!r} is not a directory")
    return os.path.realpath(path)


def _route_pattern(path: str):
    """``path``'s regex: ``{name}`` matches one segment, the rest literally."""
    out, pos = "^", 0
    for m in re.finditer(r"\{(\w+)\}", path):
        out += re.escape(path[pos:m.start()]) + f"(?P<{m.group(1)}>[^/]+)"
        pos = m.end()
    return re.compile(out + re.escape(path[pos:]) + "$")


def _own_response(got):
    """An own route's return value as ``(status, body, content_type)``."""
    if isinstance(got, tuple):
        return got
    if isinstance(got, (dict, list)):
        return _json(got)
    if isinstance(got, str):
        return 200, got.encode(), "text/html; charset=utf-8"
    if isinstance(got, (bytes, bytearray)):
        return 200, bytes(got), "application/octet-stream"
    raise TypeError(f"route handler returned {type(got).__name__}")


class ControlPort:
    """The REST server over a :class:`~.runtime.RuntimeHandle`; ``bind`` is
    ``host:port`` (default config ``ctrlport_bind``); ``extra_routes`` are
    ``(method, path, handler)`` tuples (see the module docstring)."""

    def __init__(self, runtime_handle, bind: Optional[str] = None, extra_routes=None):
        self.handle = runtime_handle
        self.extra_routes = [(method.upper(), _route_pattern(path), handler)
                             for method, path, handler in (extra_routes or ())]
        host, _, port = (bind or config().ctrlport_bind).rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 1337)
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self._fleet_router = None          # built at the first routed admission
        self.frontend = _frontend_dir()

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
        try:
            from ..telemetry import fleet as _fleet
            _fleet.ensure_started()        # None (and nothing runs) with no peers
        except Exception as e:             # noqa: BLE001 — an optional plane
            log.warning("fleet plane unavailable: %r", e)

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
            path, _, qs = target.partition("?")
            try:
                got = await self._route(method, path, body, parse_qs(qs))
            except Exception as e:                 # noqa: BLE001 — a route's bug
                log.error("control port %s %s failed: %r", method, target, e)
                got = _text(500)
            writer.write(_response(*got))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            writer.close()

    async def _route(self, method: str, path: str, body: bytes, query: dict):
        from ..serve import api as serve_api
        allowed = False
        table = [(ms, pat, getattr(self, name), "port") for ms, pat, name in _ROUTES]
        table += [(ms, pat, h, "serve") for ms, pat, h in serve_api.routes()]
        table += [((ms,), pat, h, "extra") for ms, pat, h in self.extra_routes]
        if self.frontend is not None:
            table += [(ms, pat, getattr(self, name), "port") for ms, pat, name in _GUI_ROUTES]
        for methods, pattern, handler, kind in table:
            m = pattern.match(path)
            if m is None:
                continue
            if method not in methods:
                allowed = True
                continue
            if kind == "port":             # this port's routes read the query
                return await handler(method, body, query, **m.groupdict())
            if kind == "extra":
                got = handler(Request(method, path, query, body, m.groupdict()))
                if inspect.isawaitable(got):
                    got = await got
                return _own_response(got)
            return await handler(method, body, **m.groupdict())
        return _text(405 if allowed else 404)

    def _gui_file(self, path: str):
        """A file of the GUI directory as the reference's ``FileResponse``
        gives it: 404 with an empty body where there is none."""
        try:
            with open(path, "rb") as f:
                body = f.read()
        except OSError:
            return 404, b"", "application/octet-stream"
        return 200, body, mimetypes.guess_type(path)[0] or "application/octet-stream"

    async def _gui_index(self, method, body, query):
        return self._gui_file(os.path.join(self.frontend, "index.html"))

    async def _gui_static(self, method, body, query, rel=None):
        try:
            path = os.path.realpath(os.path.join(self.frontend, unquote(rel or "")))
        except ValueError:                 # a NUL byte in the path
            return _text(404)
        if os.path.commonpath([path, self.frontend]) != self.frontend:
            return _text(404)
        if os.path.isdir(path):
            return _text(403)
        return self._gui_file(path)

    async def _fg_metrics(self) -> dict:
        """Every live flowgraph's per-block metrics, by id."""
        out = {}
        for fg_id in self.handle.flowgraph_ids():
            h = self.handle.get_flowgraph(fg_id)
            if h is None:
                continue
            try:
                out[fg_id] = await h.metrics()
            except Exception as e:         # noqa: BLE001 — a scrape never fails
                log.warning("metrics scrape of fg %d failed: %r", fg_id, e)
        return out

    async def _prom_metrics(self, method, body, query):
        """The registry with every live flowgraph's per-block families; the
        live gauges refresh first (their own minimum interval keeps a scrape
        storm from shrinking the window into noise)."""
        from ..telemetry import profile, prom
        try:
            profile.plane().update_live_gauges()
        except Exception as e:             # noqa: BLE001 — a scrape never fails
            log.warning("profile gauge refresh failed: %r", e)
        fg_metrics = await self._fg_metrics()
        if query.get("openmetrics"):
            text = prom.registry().render_openmetrics()
            if fg_metrics:
                text = text[:-len("# EOF\n")] + prom.render_block_metrics(fg_metrics) \
                    + "# EOF\n"
            return 200, text.encode(), prom.CONTENT_TYPE_OPENMETRICS
        return 200, prom.render_all(fg_metrics).encode(), prom.CONTENT_TYPE

    async def _trace(self, method, body, query, fg):
        """Drain every thread's span ring as a Chrome trace (``?keep=1``
        reads without draining, so another consumer keeps its events)."""
        from ..telemetry import spans
        if self._fg(fg) is None:
            return _json({"error": "flowgraph not found"}, 404)
        rec = spans.recorder()
        events = rec.snapshot() if query.get("keep") else rec.drain()
        return _json(rec.chrome_trace(events))

    async def _doctor(self, method, body, query, fg):
        """A flight record and the bottleneck report over a snapshot of the
        spans (``?md=1``: the record as markdown)."""
        from ..telemetry import doctor as doc
        from ..telemetry import spans
        if self._fg(fg) is None:
            return _json({"error": "flowgraph not found"}, 404)
        d = doc.doctor()
        loop = asyncio.get_running_loop()
        record = await loop.run_in_executor(None, d.flight_record, "endpoint")
        if query.get("md"):
            return 200, doc.render_markdown(record).encode(), "text/markdown; charset=utf-8"
        report = await loop.run_in_executor(
            None, lambda: d.report(events=spans.recorder().snapshot()))
        return _json({"report": report, "flight_record": record})

    async def _profile(self, method, body, query, fg):
        """The profile plane: compiles by program and reason, active
        compiles, storms, the live roofline (``?costs=1`` counts the lazily
        registered costs first, off the event loop)."""
        from ..telemetry import profile
        if self._fg(fg) is None:
            return _json({"error": "flowgraph not found"}, 404)
        if query.get("costs"):
            snap = await asyncio.get_running_loop().run_in_executor(
                None, lambda: profile.plane().snapshot(ensure_costs=True))
        else:
            profile.plane().update_live_gauges()
            snap = profile.plane().snapshot()
        return _json(snap)

    async def _lineage(self, method, body, query, fg):
        """The sampled lineage: the tail report and the newest completed
        records (``?n=``, default 32)."""
        from ..telemetry import lineage
        if self._fg(fg) is None:
            return _json({"error": "flowgraph not found"}, 404)
        try:
            n = max(0, int(query.get("n", 32)))
        except ValueError:
            return _json({"error": "bad n"}, 400)
        tr = lineage.tracer()
        return _json({"stride": tr.stride, "dropped": tr.dropped,
                      "tail": lineage.tail_report(), "records": tr.records_dicts(n or None)})

    async def _events(self, method, body, query):
        """The journal's cursor read: ``?since=<seq>``, ``?cat=``,
        ``?limit=``; ``next`` is the following cursor, ``gap`` marks events
        the ring dropped."""
        from ..telemetry import journal
        try:
            since = int(query.get("since", 0))
            limit = int(query["limit"]) if "limit" in query else None
        except ValueError:
            return _json({"error": "bad since/limit"}, 400)
        return _json(journal.journal().events(since=since, cat=query.get("cat") or None,
                                              limit=limit))

    async def _host_summary(self, method, body, query):
        """This host's fleet export (lock-free reads only)."""
        from ..telemetry import fleet
        return _json(fleet.host_summary())

    def _fleet_view(self):
        from ..telemetry import fleet
        return fleet.ensure_started()

    async def _fleet(self, method, body, query):
        view = self._fleet_view()
        if view is None:
            return _json({"error": "fleet plane disabled (set fleet_peers)"}, 404)
        return _json(view.snapshot())

    async def _fleet_metrics(self, method, body, query):
        """Every peer's /metrics merged with a ``host=`` label (the scrapes
        are blocking HTTP: off the event loop)."""
        from ..telemetry import prom
        view = self._fleet_view()
        if view is None:
            return _json({"error": "fleet plane disabled (set fleet_peers)"}, 404)
        text = await asyncio.get_running_loop().run_in_executor(None, view.merged_metrics)
        return 200, text.encode(), prom.CONTENT_TYPE

    async def _fleet_admit(self, method, body, query, app):
        """A pressure-routed admission (``serve/router.py``): the least
        pressured ready host, failing over on a 503."""
        from ..serve.router import AdmissionRouter, NoReadyHost
        view = self._fleet_view()
        if view is None:
            return _json({"error": "fleet plane disabled (set fleet_peers)"}, 404)
        if self._fleet_router is None:
            self._fleet_router = AdmissionRouter(view)
        try:
            req = json.loads(body) if body else {}
            if not isinstance(req, dict):
                raise ValueError("not an object")
        except ValueError:
            return _json({"error": "bad json body", "app": app}, 400)
        try:
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._fleet_router.admit(
                    app, tenant=str(req.get("tenant", "default")), sid=req.get("sid"),
                    body=req))
        except NoReadyHost as e:
            return _json({"error": str(e), "app": app}, 503,
                         {"Retry-After": str(e.retry_after)})
        return _json(out, 201)

    def _fg(self, fg: str):
        try:
            return self.handle.get_flowgraph(int(fg))
        except ValueError:
            return None

    async def _list_fgs(self, method, body, query):
        return _json(self.handle.flowgraph_ids())

    async def _describe_fg(self, method, body, query, fg):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        return _json((await h.describe()).to_json())

    async def _metrics(self, method, body, query, fg):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        return _json(await h.metrics())

    async def _describe_block(self, method, body, query, fg, blk):
        h = self._fg(fg)
        if h is None:
            return _json({"error": "flowgraph not found"}, 404)
        desc = await h.describe()
        for b in desc.blocks:
            if str(b.id) == blk:
                return _json(b.to_json())
        return _json({"error": "block not found"}, 404)

    async def _call(self, method, body, query, fg, blk, handler):
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

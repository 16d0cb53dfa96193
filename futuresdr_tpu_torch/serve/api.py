"""REST session plane of the serving front-end, on the control port.

The port of ``futuresdr_tpu/serve/api.py``. The reference mounts aiohttp
handlers; the port's control port (``runtime/ctrl_port.py``) is standard
library HTTP with a fixed route table, and mounts these routes (plus
:func:`routes` for a bespoke server):

  GET    /api/serve/                              → registered serving apps
  GET    /api/serve/{app}/                        → engine view
  POST   /api/serve/{app}/session/                → admit {"tenant", "sid"?}
  GET    /api/serve/{app}/session/{sid}/          → per-session view
  POST   /api/serve/{app}/session/{sid}/evict/    → evict the carry to the host
  POST   /api/serve/{app}/session/{sid}/readmit/  → restore it bit for bit
  POST   /api/serve/{app}/session/{sid}/ctrl/     → lane retune
                                                    {"stage": …, "params": {…}}
  DELETE /api/serve/{app}/session/{sid}/          → leave
  POST   /api/serve/{app}/drain/                  → graceful drain
  GET    /healthz                                 → liveness
  GET    /readyz                                  → every app compiled, none
                                                    draining (503 + Retry-After)

Errors are JSON (``{"error": ..., "app": ...}``); every 503 (``ServeFull``,
draining, overload) carries ``Retry-After`` from the engine's step rate.
``/readyz`` has no compile-storm gate yet: the reference reads it from the
profile plane, which is ROADMAP item 4b.

A handler is ``async fn(method, body, **path groups) -> (status, payload,
content type, headers)``; engine calls run off the event loop (surgery waits
for the engine's step lock, which a stepper holds across a dispatch).
"""

from __future__ import annotations

import asyncio
import functools
import json
import re
import threading
from typing import Dict, List, Optional, Tuple

from ..log import logger
from .slots import ServeFull

__all__ = ["register_app", "unregister_app", "get_app", "apps", "routes", "readiness",
           "readyz_retry_after"]

log = logger("serve.api")

# app name -> ServeEngine (process-global, like the control port's planes)
_apps: Dict[str, object] = {}
_lock = threading.Lock()

_JSON = "application/json; charset=utf-8"


def register_app(engine, name: Optional[str] = None) -> str:
    """Register a :class:`~.engine.ServeEngine` under an app name (default:
    its own ``app``). With config ``serve_drain_on_sigterm`` set, the first
    registration also installs the SIGTERM drain hook."""
    name = str(name or engine.app)
    with _lock:
        _apps[name] = engine
    try:
        from ..config import config
        if config().serve_drain_on_sigterm:
            from .engine import install_sigterm_drain
            install_sigterm_drain()
    except Exception as e:                 # noqa: BLE001 — lifecycle sugar
        log.warning("sigterm drain hook unavailable: %r", e)
    return name


def unregister_app(name: str) -> None:
    with _lock:
        _apps.pop(str(name), None)


def get_app(name: str):
    with _lock:
        return _apps.get(str(name))


def apps() -> Dict[str, object]:
    with _lock:
        return dict(_apps)


async def _call(fn, *args, **kw):
    """A blocking engine call off the event loop."""
    return await asyncio.get_running_loop().run_in_executor(
        None, functools.partial(fn, *args, **kw))


def _json(obj, status: int = 200, headers: Optional[dict] = None):
    return status, json.dumps(obj).encode(), _JSON, headers or {}


def _error(app: Optional[str], message: str, status: int,
           retry_after: Optional[int] = None):
    return _json({"error": message, "app": app}, status,
                 {"Retry-After": str(int(retry_after))} if retry_after is not None else None)


def _serve_full(eng, name: str, e: BaseException):
    try:
        after = int(eng.retry_after_s())
    except Exception:                      # noqa: BLE001 — the header is advisory
        after = 1
    return _error(name, str(e), 503, retry_after=after)


def _body(body: bytes) -> dict:
    """A request's JSON object (an empty body is ``{}``); ValueError when it
    is not one."""
    if not body:
        return {}
    got = json.loads(body)
    if not isinstance(got, dict):
        raise ValueError("body must be a JSON object")
    return got


def _not_found(app: str):
    return _error(app, "serving app not found", 404)


async def _list_apps(method, body):
    return _json({name: {"sessions": len(eng.table.sessions), "active": eng.table.active,
                         "capacity": eng.capacity,
                         "draining": bool(getattr(eng, "draining", False))}
                  for name, eng in sorted(apps().items())})


async def _describe_app(method, body, app):
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    return _json(await _call(eng.describe))


async def _create_session(method, body, app):
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    try:
        req = _body(body)
    except ValueError:
        return _error(app, "bad json body", 400)
    try:
        s = await _call(eng.admit, tenant=str(req.get("tenant", "default")),
                        sid=req.get("sid"))
    except ServeFull as e:
        return _serve_full(eng, app, e)
    except ValueError as e:
        return _error(app, str(e), 409)
    return _json(s.view(), 201)


async def _session(method, body, app, sid):
    """GET: the session's view; DELETE: leave."""
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    try:
        if method == "DELETE":
            await _call(eng.close, sid)
            return _json({"ok": True})
        return _json(await _call(eng.session_view, sid))
    except KeyError:
        return _error(app, "session not found", 404)


async def _session_evict(method, body, app, sid):
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    try:
        s = await _call(eng.evict, sid)
    except KeyError:
        return _error(app, "session not found", 404)
    except ValueError as e:
        return _error(app, str(e), 409)
    return _json(s.view())


async def _session_readmit(method, body, app, sid):
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    try:
        s = await _call(eng.readmit, sid)
    except KeyError:
        return _error(app, "session not found", 404)
    except ServeFull as e:
        return _serve_full(eng, app, e)
    except ValueError as e:
        return _error(app, str(e), 409)
    return _json(s.view())


async def _session_ctrl(method, body, app, sid):
    """Lane retune: ``{"stage": <name|index>, "params": {...}}``; a bad
    stage address or a stage with no update hook is a 409, a malformed body
    a 400, an unknown session a 404."""
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    try:
        req = _body(body)
        stage = req["stage"]
        params = req.get("params") or {}
        if not isinstance(params, dict):
            raise TypeError("params must be an object")
    except (ValueError, KeyError, TypeError):
        return _error(app, 'bad json body: expected {"stage": ..., "params": {...}}', 400)
    try:
        s = await _call(eng.retune, sid, stage, **params)
    except KeyError:
        return _error(app, "session not found", 404)
    except (ValueError, TypeError) as e:
        return _error(app, str(e), 409)
    return _json(s.view())


async def _drain_app(method, body, app):
    """Graceful drain; ``{"pump": false}`` only marks draining (an app with
    its own pump thread), ``{"timeout": s}`` bounds the pump."""
    eng = get_app(app)
    if eng is None:
        return _not_found(app)
    try:
        req = _body(body)
    except ValueError:
        req = {}
    try:
        report = await _call(eng.drain, pump=bool(req.get("pump", True)),
                             timeout=float(req.get("timeout", 30.0)))
    except Exception as e:                 # noqa: BLE001 — a drain must report
        return _error(app, f"drain failed: {e!r}", 500)
    return _json(report)


def readiness() -> Tuple[bool, dict]:
    """Process readiness for ``GET /readyz``: every registered serving app
    ready (its current bucket compiled, not draining); the detail names the
    unready app and why."""
    detail: Dict[str, dict] = {}
    ready = True
    for name, eng in sorted(apps().items()):
        try:
            h = eng.health()
        except Exception as e:             # noqa: BLE001 — an engine that cannot
            h = {"ready": False, "error": repr(e)}     # answer is not ready
        detail[name] = h
        ready = ready and bool(h.get("ready"))
    return ready, {"apps": detail, "compile_storms": None}


def readyz_retry_after() -> int:
    """An unready 503's Retry-After: the largest registered engine's
    ``retry_after_s()``, in [1, 30]."""
    after = 1
    for _name, eng in apps().items():
        try:
            after = max(after, int(eng.retry_after_s()))
        except Exception:                  # noqa: BLE001 — advisory header
            pass
    return int(min(30, max(1, after)))


async def _healthz(method, body):
    return _json({"ok": True})


async def _readyz(method, body):
    ready, detail = readiness()
    if ready:
        return _json({"ready": True, **detail})
    return _json({"ready": False, **detail}, 503,
                 {"Retry-After": str(readyz_retry_after())})


_APP = r"^/api/serve/(?P<app>[^/]+)/"
_SID = _APP + r"session/(?P<sid>[^/]+)/"


def routes() -> List[Tuple[Tuple[str, ...], "re.Pattern", object]]:
    """The session plane's routes as ``(methods, path pattern, handler)``,
    the control port's table form."""
    return [
        (("GET",), re.compile(r"^/api/serve/$"), _list_apps),
        (("GET",), re.compile(_APP + r"$"), _describe_app),
        (("POST",), re.compile(_APP + r"session/$"), _create_session),
        (("GET", "DELETE"), re.compile(_SID + r"$"), _session),
        (("POST",), re.compile(_SID + r"evict/$"), _session_evict),
        (("POST",), re.compile(_SID + r"readmit/$"), _session_readmit),
        (("POST",), re.compile(_SID + r"ctrl/$"), _session_ctrl),
        (("POST",), re.compile(_APP + r"drain/$"), _drain_app),
        (("GET",), re.compile(r"^/healthz$"), _healthz),
        (("GET",), re.compile(r"^/readyz$"), _readyz),
    ]

"""Pressure-routed admissions across a fleet of serving hosts.

The port's copy of ``futuresdr_tpu/serve/router.py``. :class:`AdmissionRouter`
routes each admission to the least-pressure READY host of a fleet view and
fails over on a 503 or overload, honouring ``Retry-After``. The score is
lexicographic, worst signal first::

    (shed-ladder level, credit pressure, e2e p99 seconds)

and switching is hysteretic (``hysteresis``, default config
``fleet_hysteresis``): the previous pick keeps the traffic unless a
candidate beats it outside the band (a shed-rung difference always
switches). Each decision is journaled under ``fleet``. The view is
injected: a ``telemetry/fleet.FleetView`` (which polls the hosts'
``/api/host/`` exports; the control port builds one from config
``fleet_peers`` and routes ``POST /api/fleet/serve/{app}/session/`` here),
or any object with ``ready_hosts() -> {peer: {"summary": {...}}}``.
``post=`` injects the HTTP call, so the scoring and failover test without
sockets.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from ..log import logger
from ..telemetry import journal as _journal
from ..telemetry import prom

__all__ = ["AdmissionRouter", "NoReadyHost", "score"]

log = logger("serve.router")

ROUTES = prom.counter(
    "fsdr_fleet_route_total",
    "fleet admissions routed by app, target host and outcome",
    ("app", "host", "outcome"))
ROUTE_SECONDS = prom.histogram(
    "fsdr_fleet_route_seconds",
    "end-to-end fleet admission routing latency (pick + remote admit, "
    "failover hops included)", ("app",))


class NoReadyHost(RuntimeError):
    """No fleet host could take the admission (none ready, or every ready
    host 503'd). ``retry_after`` carries the smallest backoff any refusing
    host asked for — the front door's own 503 honors it upward."""

    def __init__(self, msg: str, retry_after: int = 1):
        super().__init__(msg)
        self.retry_after = max(1, int(retry_after))


def score(summary: dict, app: Optional[str] = None
          ) -> Optional[Tuple[float, float, float]]:
    """The routing score of one host summary — ``None`` when the host (or
    the named app on it) is not ready, which removes it from the candidate
    set entirely. Lower is better, compared lexicographically."""
    if not summary or not summary.get("ready"):
        return None
    apps = summary.get("apps") or {}
    if app is not None and app in apps:
        a = apps[app]
        if not a.get("ready"):
            return None
        rung = float(a.get("shed_level", 0))
        pressure = float(a.get("pressure", 0.0))
    else:
        rung = float(summary.get("shed_level", 0))
        pressure = float(summary.get("pressure", 0.0))
    p99 = (summary.get("e2e") or {}).get("p99_s") or 0.0
    return (rung, pressure, float(p99))


def _better(cand: Tuple[float, float, float],
            cur: Tuple[float, float, float], h: float) -> bool:
    """Hysteretic "worth switching": the candidate must beat the CURRENT
    pick by more than the band ``h`` on the component that decides —
    except the shed rung, where any strict improvement switches (the
    ladder is already hysteretic at the source)."""
    if cand[0] != cur[0]:
        return cand[0] < cur[0]
    if abs(cand[1] - cur[1]) > h:
        return cand[1] < cur[1]
    # pressure within the band: p99 decides, same relative band
    if cur[2] > 0 and abs(cand[2] - cur[2]) > h * cur[2]:
        return cand[2] < cur[2]
    return False


def _http_post(url: str, body: dict, timeout: float
               ) -> Tuple[int, Dict[str, str], bytes]:
    data = json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers or {}), e.read()


class AdmissionRouter:
    """Route admissions over a fleet view's ready hosts.

    ``post`` is injectable (``post(url, body, timeout) -> (status,
    headers, body_bytes)``); ``hysteresis`` defaults to the
    ``fleet_hysteresis`` config knob.
    """

    def __init__(self, view, hysteresis: Optional[float] = None,
                 timeout: float = 5.0,
                 post: Optional[Callable] = None):
        if hysteresis is None:
            from ..config import config
            hysteresis = float(config().get("fleet_hysteresis", 0.1))
        self.view = view
        self.hysteresis = float(hysteresis)
        self.timeout = float(timeout)
        self._post = post or _http_post
        self._last: Dict[str, str] = {}    # app -> host of the previous pick

    # -- picking -------------------------------------------------------------
    def candidates(self, app: str) -> Dict[str, Tuple[float, float, float]]:
        """Ready hosts and their scores for ``app`` (down/stale/unready
        hosts are filtered out by :func:`score` returning None)."""
        out: Dict[str, Tuple[float, float, float]] = {}
        for peer, h in self.view.ready_hosts().items():
            s = score(h.get("summary") or {}, app)
            if s is not None:
                out[peer] = s
        return out

    def pick(self, app: str, exclude: Tuple[str, ...] = ()
             ) -> Tuple[str, Dict[str, Tuple[float, float, float]]]:
        """The host the next admission for ``app`` should land on, plus
        every score considered (journaled with the decision). Sticky under
        hysteresis: the previous pick keeps the traffic unless a candidate
        beats it outside the band. Raises :class:`NoReadyHost` when the
        candidate set is empty."""
        cands = {p: s for p, s in self.candidates(app).items()
                 if p not in exclude}
        if not cands:
            raise NoReadyHost(f"{app}: no ready fleet host "
                              f"(excluded: {list(exclude) or None})")
        cur = self._last.get(app)
        if cur not in cands:
            # no sticky pick: plain lexicographic best (address breaks
            # exact ties deterministically)
            cur = min(sorted(cands), key=lambda p: cands[p])
        for peer in sorted(cands):
            if peer != cur and _better(cands[peer], cands[cur],
                                       self.hysteresis):
                cur = peer
        self._last[app] = cur
        return cur, cands

    # -- admission -----------------------------------------------------------
    def admit(self, app: str, tenant: str = "default",
              sid: Optional[str] = None, body: Optional[dict] = None
              ) -> dict:
        """Route one admission: pick, POST to the target's own
        ``/api/serve/{app}/session/``, fail over to the next-best host on
        503/overload (honoring the refusing host's ``Retry-After`` as the
        floor of the error we ultimately raise). Returns the admitting
        host's 201 body plus routing metadata; raises
        :class:`NoReadyHost` when every candidate refused."""
        t0 = time.monotonic()
        payload = dict(body or {})
        payload.setdefault("tenant", tenant)
        if sid is not None:
            payload.setdefault("sid", sid)
        tried: List[str] = []
        retry_after = 1
        while True:
            try:
                host, scores = self.pick(app, exclude=tuple(tried))
            except NoReadyHost as e:
                ROUTES.inc(app=app, host="-", outcome="no-host")
                _journal.emit("fleet", "route-failed", app=app,
                              tenant=tenant, tried=tried,
                              retry_after=retry_after)
                e.retry_after = max(e.retry_after, retry_after)
                raise
            try:
                status, headers, raw = self._post(
                    f"http://{host}/api/serve/{app}/session/", payload,
                    self.timeout)
            except Exception as err:       # noqa: BLE001 — a dead host mid-
                status, headers, raw = 599, {}, repr(err).encode()  # admit
            if status == 201:              # is a failover, not an error
                out = json.loads(raw)
                dur = time.monotonic() - t0
                ROUTES.inc(app=app, host=host, outcome="ok")
                ROUTE_SECONDS.observe(dur, app=app)
                _journal.emit("fleet", "route", app=app, host=host,
                              tenant=tenant, sid=out.get("sid"),
                              scores={p: list(s) for p, s
                                      in sorted(scores.items())},
                              failovers=len(tried),
                              dur_ms=round(dur * 1e3, 3))
                return {"host": host, "session": out,
                        "failovers": len(tried)}
            tried.append(host)
            self._last.pop(app, None)      # the sticky pick refused: re-pick
            try:
                retry_after = max(retry_after,
                                  int(headers.get("Retry-After", 1)))
            except (TypeError, ValueError):
                pass
            ROUTES.inc(app=app, host=host, outcome=f"http-{status}")
            _journal.emit("fleet", "route-failover", app=app, host=host,
                          tenant=tenant, status=status,
                          retry_after=retry_after)

"""Fleet observability plane.

The port's copy of ``futuresdr_tpu/telemetry/fleet.py``: plain HTTP between
the standard-library control ports (``runtime/ctrl_port.py``).

Every observability surface below this module — doctor, profile plane,
lineage, journal, /metrics — is process-local. The pod-scale serving
fabric needs the cross-host half: which hosts exist, which are ready,
which are shedding, and where the next admission should land. This module
builds that on plain HTTP between control ports, in three parts:

* :func:`host_summary` — the cheap per-host export behind
  ``GET /api/host/`` on every control port: host id, uptime, readyz
  verdict, per-app shed rung + credit pressure + session counts, windowed
  MFU/HBM-util, compile-storm flag, doctor verdict, e2e p50/p99, journal
  cursor head. Built strictly on the serving plane's lock-free
  ``health()``/``retry_after_s()`` discipline — a wedged ``step()``
  holding the engine lock through a multi-second compile must not stall a
  fleet poll (that is exactly when the fleet needs the answer).
* :class:`FleetView` — the aggregator: polls a configured peer list
  (config ``fleet_peers``) every ``fleet_poll_interval`` seconds with
  bounded staleness. Host states: ``up`` → ``stale`` (first failed poll,
  or last good summary older than ``fleet_stale_s``) → ``down``
  (``fleet_down_errors`` consecutive failures — a SIGKILLed peer reads
  down within two poll intervals) → ``up`` again on the next success.
  Every transition lands in the journal under the ``fleet`` category.
  Feeds ``GET /api/fleet/`` (aggregated readyz + per-host table +
  rollups + cross-host verdicts), ``GET /api/fleet/metrics`` (merged
  Prometheus exposition, ``host=`` label, stable ordering) and the
  ``fleet`` section of doctor reports/flight records.
* :func:`tick` — the serving hot-path hook (``ServeEngine.step`` calls it
  once per step): time-gated refresh of this host's own fleet gauges.
  Disabled (no ``fleet_peers``) it is ONE falsy check — the sixth
  per-call hook class billed by the ≤3% telemetry overhead gate
  (tests/test_torch_telemetry.py).

Cross-host verdicts (:meth:`FleetView.verdicts`):

* ``host-down`` / ``host-stale`` — a peer stopped answering.
* ``host-wedged`` — a peer answers but its own doctor tripped.
* ``pressure-skew`` — max−min credit pressure across up hosts exceeds
  ``fleet_skew``; the verdict carries the hottest host's resident session
  ids as EVICTION CANDIDATES (each has an evict-to-disk snapshot path via
  ``POST .../evict/`` + readmit on another host) — the migration hint the
  pod-scale router can act on.
* ``fleet-compile-storm`` — more than half the up hosts flag a compile
  storm at once (a fleet-wide retune/rollout churning every pod).

The module needs no device plane and imports the serve plane lazily —
a host-only aggregator process (no engine, no compute plane) can run a
FleetView + AdmissionRouter on nothing but the control port.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from ..log import logger
from . import journal as _journal
from . import prom

__all__ = ["host_summary", "host_id", "FleetView", "merge_metrics",
           "enabled", "ensure_started", "active_view", "shutdown", "tick",
           "fleet_section", "HOST_STATES"]

log = logger("telemetry.fleet")

#: the FleetView host state machine, in degradation order
HOST_STATES = ("up", "stale", "down")

FLEET_HOSTS = prom.gauge(
    "fsdr_fleet_hosts", "fleet hosts by state (the aggregator's view)",
    ("state",))
FLEET_HOST_PRESSURE = prom.gauge(
    "fsdr_fleet_host_pressure",
    "per-host max credit pressure as last polled by the fleet aggregator",
    ("host",))
FLEET_POLLS = prom.counter(
    "fsdr_fleet_polls_total", "fleet peer polls by outcome", ("outcome",))

_T0 = time.monotonic()


# ---------------------------------------------------------------------------
# per-host summary (GET /api/host/)
# ---------------------------------------------------------------------------

def host_id() -> str:
    """This host's fleet identity: the ``fleet_host_id`` config knob, else
    ``<hostname>:<pid>`` (unique across a multi-process single-box fleet —
    the test topology — and readable across a real pod)."""
    from ..config import config
    hid = str(config().get("fleet_host_id", "") or "")
    return hid or f"{socket.gethostname()}:{os.getpid()}"


def _apps_section() -> Dict[str, dict]:
    """Per-app pressure block, lock-free by the health()/retry_after_s()
    discipline: plain attribute reads under the GIL (at most one step
    stale), never the engine lock — step() holds that across whole
    dispatches including graph captures."""
    try:
        from ..serve import api as serve_api
        engines = serve_api.apps()
    except Exception:                      # noqa: BLE001 — serve plane is
        return {}                          # optional on a host-only port
    out: Dict[str, dict] = {}
    for name, eng in sorted(engines.items()):
        try:
            h = eng.health()
            occ = [s.sid for s in eng.table.occupants()]
            out[name] = {
                **h,
                "pressure": round(float(eng.credits.pressure()), 4),
                "sessions": len(eng.table.sessions),
                "tenants": eng.table.tenants(),
                "retry_after_s": int(eng.retry_after_s()),
                # resident sids, slot order: the pressure-skew verdict's
                # eviction candidates (each has an evict-to-disk snapshot)
                "occupants": occ[:16],
            }
        except Exception as e:             # noqa: BLE001 — one sick engine
            out[name] = {"ready": False, "error": repr(e)}
    return out


def _doctor_verdict() -> dict:
    try:
        from . import doctor as _doctor
        return _doctor.doctor().verdicts()
    except Exception as e:                 # noqa: BLE001
        return {"verdict": "unknown", "error": repr(e)}


def host_summary() -> dict:
    """The ``GET /api/host/`` body: everything a fleet poller needs in one
    cheap, lock-free read. Never raises — a summary must come back even
    with half the planes unimportable."""
    from . import profile as _profile
    try:
        from ..serve.api import readiness
        ready, detail = readiness()
    except Exception as e:                 # noqa: BLE001 — no serve plane:
        ready, detail = True, {"apps": {}, "error": repr(e)}   # host ready
    prof = {"mfu": 0.0, "hbm_util": 0.0}
    storm = False
    try:
        p = _profile.plane()
        p.update_live_gauges()             # default min_interval guard
        prof["mfu"] = round(max(
            [v for _l, v in _profile.MFU.samples()] or [0.0]), 4)
        prof["hbm_util"] = round(max(
            [v for _l, v in _profile.HBM_UTIL.samples()] or [0.0]), 4)
        storm = bool(p.storm_report())
    except Exception:                      # noqa: BLE001
        pass
    try:
        from . import doctor as _doctor
        e2e = {"p50_s": _doctor.E2E_LATENCY.quantile(0.5),
               "p99_s": _doctor.E2E_LATENCY.quantile(0.99)}
    except Exception:                      # noqa: BLE001
        e2e = {"p50_s": None, "p99_s": None}
    apps = _apps_section()
    hid = host_id()
    pressure = max([a.get("pressure", 0.0) for a in apps.values()] or [0.0])
    # the pressure export lands in THIS host's own /metrics exposition too
    # (scraping any one host shows its fleet signal without an aggregator);
    # the merged fleet exposition keeps the host's own label as-is
    FLEET_HOST_PRESSURE.set(pressure, host=hid)
    return {
        "host": hid,
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _T0, 3),
        "t_wall": time.time(),
        "ready": bool(ready),
        "readyz": detail,
        "apps": apps,
        "sessions": sum(a.get("sessions", 0) for a in apps.values()),
        "pressure": pressure,
        "shed_level": max([a.get("shed_level", 0) for a in apps.values()]
                          or [0]),
        "mfu": prof["mfu"],
        "hbm_util": prof["hbm_util"],
        "compile_storm": storm,
        "doctor": _doctor_verdict(),
        "e2e": e2e,
        "journal_seq": _journal.journal().seq,
    }


# ---------------------------------------------------------------------------
# merged Prometheus exposition
# ---------------------------------------------------------------------------

def _inject_host_label(line: str, host: str) -> str:
    """``name{a="b"} v`` → ``name{host="h",a="b"} v`` (and the unlabelled
    form gains ``{host="h"}``). The host label leads, existing labels keep
    their order — per-host text stays recognizably itself. A sample that
    ALREADY carries a ``host=`` label (a host's own fleet gauges) keeps it
    untouched — doubling the label name would break the exposition."""
    h = host.replace("\\", r"\\").replace('"', r'\"')
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        labels = line[brace:line.find("}", brace)]
        if 'host="' in labels:
            return line
        return f'{line[:brace + 1]}host="{h}",{line[brace + 1:]}'
    name, _, rest = line.partition(" ")
    return f'{name}{{host="{h}"}} {rest}'


def merge_metrics(texts: Dict[str, str]) -> str:
    """Merge per-host Prometheus expositions into one document with a
    ``host=`` label on every sample.

    Stable-ordering contract (the fleet-smoke gate diffs two scrapes):
    families sort by name, hosts sort by address within a family, and each
    host's sample lines keep their ORIGINAL order within the family — a
    histogram's cumulative ``le=`` buckets must not be resorted
    lexically. Sample lines are assigned to the family whose header they
    appeared under (expositions are family-contiguous), so ``_bucket`` /
    ``_sum`` / ``_count`` suffixes need no special-casing."""
    # family name -> {"help": line|None, "type": line|None,
    #                 "hosts": {host: [sample lines]}}
    fams: Dict[str, dict] = {}

    def fam(name: str) -> dict:
        return fams.setdefault(name, {"help": None, "type": None,
                                      "hosts": {}})

    for host in sorted(texts):
        cur: Optional[dict] = None
        for line in texts[host].splitlines():
            if not line or line == "# EOF":
                continue
            if line.startswith("# HELP "):
                f = fam(line.split(" ", 3)[2])
                f["help"] = f["help"] or line
                cur = f
            elif line.startswith("# TYPE "):
                f = fam(line.split(" ", 3)[2])
                f["type"] = f["type"] or line
                cur = f
            elif line.startswith("#"):
                continue
            else:
                if cur is None:            # headerless sample: own family
                    cur = fam(line.partition("{")[0].partition(" ")[0])
                cur["hosts"].setdefault(host, []).append(
                    _inject_host_label(line, host))
    lines: List[str] = []
    for name in sorted(fams):
        f = fams[name]
        if f["help"]:
            lines.append(f["help"])
        if f["type"]:
            lines.append(f["type"])
        for host in sorted(f["hosts"]):
            lines.extend(f["hosts"][host])
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

def _http_get(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        if r.status >= 400:
            raise urllib.error.HTTPError(url, r.status, "fleet poll",
                                         r.headers, None)
        return r.read()


class FleetView:
    """Poll a peer list of control ports; keep a bounded-staleness view.

    ``fetch`` is injectable (``fetch(url, timeout) -> bytes``) so the
    staleness state machine unit-tests without sockets. A peer address is
    ``host:port`` — the poll hits ``http://<peer>/api/host/``.
    """

    def __init__(self, peers: List[str], poll_interval: float = 1.0,
                 stale_s: float = 0.0, down_errors: int = 2,
                 skew: float = 0.5,
                 fetch: Optional[Callable[[str, float], bytes]] = None):
        self.peers = [p.strip() for p in peers if p.strip()]
        self.poll_interval = max(0.05, float(poll_interval))
        # auto staleness: three missed cadences — one slow scrape must not
        # flap a healthy host
        self.stale_s = float(stale_s) or 3.0 * self.poll_interval
        self.down_errors = max(1, int(down_errors))
        self.skew = float(skew)
        self._fetch = fetch or _http_get
        self._lock = threading.Lock()
        self._hosts: Dict[str, dict] = {
            p: {"state": "stale", "errors": 0, "summary": None,
                "t_ok": 0.0, "polls": 0}
            for p in self.peers}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetView":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fsdr-fleet")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.poll_interval + 1.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception as e:         # noqa: BLE001 — the poller must
                log.warning("fleet poll failed: %r", e)        # outlive one
                                                               # bad round

    # -- polling ------------------------------------------------------------
    def poll_once(self) -> None:
        """One poll round over every peer (also the test-driven entry:
        unit tests call it directly instead of starting the thread)."""
        for peer in self.peers:
            try:
                body = self._fetch(f"http://{peer}/api/host/",
                                   self.poll_interval)
                summary = json.loads(body)
                FLEET_POLLS.inc(outcome="ok")
                self._observe(peer, summary)
            except Exception as e:         # noqa: BLE001 — any failure mode
                FLEET_POLLS.inc(outcome="error")   # (refused, timeout, bad
                self._observe(peer, None, err=e)   # json) is the same: the
        self._age_sweep()                          # peer did not answer
        self._export_gauges()

    def _observe(self, peer: str, summary: Optional[dict],
                 err: Optional[BaseException] = None) -> None:
        with self._lock:
            h = self._hosts[peer]
            prev = h["state"]
            h["polls"] += 1
            if summary is not None:
                h.update(summary=summary, errors=0, t_ok=time.monotonic(),
                         state="up")
                if prev != "up":
                    _journal.emit(
                        "fleet",
                        "host-recovered" if prev == "down" else "host-up",
                        host=peer, prev=prev)
            else:
                h["errors"] += 1
                h["state"] = ("down" if h["errors"] >= self.down_errors
                              else "stale")
                if h["state"] != prev:
                    _journal.emit("fleet", f"host-{h['state']}", host=peer,
                                  prev=prev, errors=h["errors"],
                                  error=repr(err))

    def _age_sweep(self) -> None:
        """A host that answered once but has not answered RECENTLY goes
        stale on age even between its own polls (bounded staleness)."""
        now = time.monotonic()
        with self._lock:
            for peer, h in self._hosts.items():
                if h["state"] == "up" and h["t_ok"] and \
                        now - h["t_ok"] > self.stale_s:
                    h["state"] = "stale"
                    _journal.emit("fleet", "host-stale", host=peer,
                                  prev="up", age_s=round(now - h["t_ok"], 3))

    def _export_gauges(self) -> None:
        snap = self.hosts()
        for state in HOST_STATES:
            FLEET_HOSTS.set(
                sum(1 for h in snap.values() if h["state"] == state),
                state=state)
        for peer, h in snap.items():
            s = h.get("summary") or {}
            FLEET_HOST_PRESSURE.set(float(s.get("pressure", 0.0)), host=peer)

    # -- views --------------------------------------------------------------
    def hosts(self) -> Dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            return {p: {"state": h["state"], "errors": h["errors"],
                        "age_s": round(now - h["t_ok"], 3) if h["t_ok"]
                        else None,
                        "summary": h["summary"]}
                    for p, h in self._hosts.items()}

    def ready_hosts(self) -> Dict[str, dict]:
        """``up`` hosts whose own readyz verdict is ready — the admission
        router's candidate set."""
        return {p: h for p, h in self.hosts().items()
                if h["state"] == "up" and h["summary"]
                and h["summary"].get("ready")}

    def verdicts(self) -> List[dict]:
        """Cross-host verdicts, worst first (see module docstring)."""
        snap = self.hosts()
        out: List[dict] = []
        up = {p: h["summary"] for p, h in snap.items()
              if h["state"] == "up" and h["summary"]}
        for peer, h in sorted(snap.items()):
            if h["state"] in ("down", "stale"):
                out.append({"verdict": f"host-{h['state']}", "host": peer,
                            "errors": h["errors"], "age_s": h["age_s"]})
        for peer, s in sorted(up.items()):
            doc = s.get("doctor") or {}
            if doc.get("verdict") not in (None, "ok", "unknown"):
                out.append({"verdict": "host-wedged", "host": peer,
                            "doctor": doc})
        if len(up) >= 2:
            press = {p: float(s.get("pressure", 0.0)) for p, s in up.items()}
            hot = max(press, key=press.get)
            cold = min(press, key=press.get)
            if press[hot] - press[cold] > self.skew:
                cands = []
                for app, a in (up[hot].get("apps") or {}).items():
                    cands += [{"app": app, "sid": sid}
                              for sid in (a.get("occupants") or [])[:4]]
                out.append({"verdict": "pressure-skew", "hot": hot,
                            "cold": cold,
                            "skew": round(press[hot] - press[cold], 4),
                            "evict_candidates": cands})
            storms = [p for p, s in up.items() if s.get("compile_storm")]
            if len(storms) * 2 > len(up):
                out.append({"verdict": "fleet-compile-storm",
                            "hosts": sorted(storms)})
        return out

    def snapshot(self) -> dict:
        """The ``GET /api/fleet/`` body: aggregated readyz + per-host table
        + rollups + verdicts."""
        snap = self.hosts()
        states = {s: sorted(p for p, h in snap.items() if h["state"] == s)
                  for s in HOST_STATES}
        ready = sorted(self.ready_hosts())
        summaries = [h["summary"] for h in snap.values() if h["summary"]]
        return {
            "ready": bool(ready) and not states["down"],
            "hosts_ready": len(ready),
            "hosts": snap,
            "states": states,
            "rollup": {
                "sessions": sum(s.get("sessions", 0) for s in summaries),
                "pressure_max": max([s.get("pressure", 0.0)
                                     for s in summaries] or [0.0]),
                "mfu_max": max([s.get("mfu", 0.0) for s in summaries]
                               or [0.0]),
            },
            "verdicts": self.verdicts(),
        }

    def merged_metrics(self) -> str:
        """Fetch ``/metrics`` from every non-down peer and merge (stable
        ordering — :func:`merge_metrics`). Down hosts are skipped, not
        errored: a merged scrape degrades, it does not fail."""
        texts: Dict[str, str] = {}
        for peer, h in self.hosts().items():
            if h["state"] == "down":
                continue
            try:
                texts[peer] = self._fetch(
                    f"http://{peer}/metrics",
                    self.poll_interval).decode("utf-8", "replace")
            except Exception as e:         # noqa: BLE001
                log.warning("fleet metrics scrape of %s failed: %r", peer, e)
        return merge_metrics(texts)


# ---------------------------------------------------------------------------
# module lifecycle + the hot-path hook
# ---------------------------------------------------------------------------

_active: Optional[FleetView] = None
_alock = threading.Lock()
#: non-None only while the fleet plane is enabled — `tick()` reads it with
#: ONE falsy check when disabled (the overhead-gate contract)
_tick_state: Optional[dict] = None


def enabled() -> bool:
    from ..config import config
    return bool(str(config().get("fleet_peers", "") or "").strip())


def ensure_started() -> Optional[FleetView]:
    """Build + start the process FleetView from config (idempotent); None
    when the fleet plane is disabled. The control port calls this at
    startup; a bespoke aggregator may call it directly."""
    global _active, _tick_state
    if not enabled():
        return None
    with _alock:
        if _active is None:
            from ..config import config
            c = config()
            _active = FleetView(
                peers=str(c.get("fleet_peers", "")).split(","),
                poll_interval=float(c.get("fleet_poll_interval", 1.0)),
                stale_s=float(c.get("fleet_stale_s", 0.0)),
                down_errors=int(c.get("fleet_down_errors", 2)),
                skew=float(c.get("fleet_skew", 0.5))).start()
            _tick_state = {"next": 0.0,
                           "interval": _active.poll_interval}
            _journal.emit("fleet", "view-start", peers=_active.peers,
                          poll_interval=_active.poll_interval)
        return _active


def active_view() -> Optional[FleetView]:
    return _active


def shutdown() -> None:
    global _active, _tick_state
    with _alock:
        v, _active = _active, None
        _tick_state = None
    if v is not None:
        v.stop()


def tick() -> None:
    """The serving hot-path hook (``ServeEngine.step`` calls this once per
    step). Disabled — the default, no ``fleet_peers`` — it is one global
    read + one falsy check, billed as the sixth per-call hook class by the
    telemetry overhead gate. Enabled, it refreshes this host's own fleet
    gauges at poll cadence (never per step)."""
    st = _tick_state
    if not st:
        return
    now = time.monotonic()
    if now < st["next"]:
        return
    st["next"] = now + st["interval"]
    try:
        s = host_summary()
        FLEET_HOST_PRESSURE.set(float(s.get("pressure", 0.0)),
                                host=s["host"])
    except Exception:                      # noqa: BLE001 — a gauge refresh
        pass                               # must never fail a serving step


def fleet_section() -> Optional[dict]:
    """The doctor's ``fleet`` report/flight-record section: the aggregated
    snapshot when a FleetView is live, else None (guarded like the
    precision/shard sections — a report must come out regardless)."""
    v = _active
    if v is None:
        return None
    try:
        return v.snapshot()
    except Exception as e:                 # noqa: BLE001
        return {"error": repr(e)}

"""Flowgraph doctor: stall watchdog, flight recorder, bottleneck attribution.

The port's copy of ``futuresdr_tpu/telemetry/doctor.py``. The spans and
the metrics record *what happened*; this module diagnoses it. Three
cooperating pieces, all hanging off one process-global :class:`Doctor`:

* **Latency histograms** — always-on log2 histograms (``telemetry/hist.py``
  via :class:`~.prom.Histogram`): per-frame end-to-end latency
  (``fsdr_e2e_latency_seconds{source}``, fed by ``TpuKernel``'s drain loop and
  the ``utils/trace.py`` latency probes), per-block ``work()`` duration
  (``fsdr_block_work_duration_seconds{block}``, fed by the block event loop),
  and link occupancy per transfer (``fsdr_xfer_seconds{direction}``,
  ``ops/xfer.py``). Quantile estimation is exact to one log2 bucket.

* **Watchdog** — a sampling thread (``doctor_interval``, default 1 s) over
  every *attached* flowgraph (the supervisor attaches its blocks + stream
  edges at launch, detaches at teardown). Progress is the sum of each block's
  monotonic counters (work calls, items in/out, messages — read through
  ``metrics()`` so fastchain/devchain bridges refresh); ``doctor_window``
  consecutive no-progress samples trip the watchdog. The trip classifies the
  stall from live port state — **backpressured** (a full output ring whose
  consumer is the one not consuming), **starved** (an empty input whose
  producer stopped), **deadlocked** (neither explains it) — names the suspect
  edge/block, and fires the flight recorder. A slow-but-progressing graph
  (progress in every window) never trips.

* **Flight recorder** — a black-box dump on watchdog trip, supervisor error,
  ``GET /api/fg/{fg}/doctor/``, or SIGUSR1: every Python thread's stack, each
  attached flowgraph's per-port ring occupancy + stall/starve counters and
  in-flight frame/dispatch state (``TpuKernel``/devchain ``extra_metrics``),
  the last-N spans of every thread ring (non-destructive snapshot), e2e
  latency quantiles, and the full Prometheus registry text — as JSON
  (:meth:`Doctor.flight_record`) and markdown (:func:`render_markdown`),
  optionally written to ``doctor_dir``.

* **Bottleneck attribution** — :meth:`Doctor.report` over drained trace
  events: interval-union busy fraction per streamed-pipeline lane
  (encode/H2D/compute/D2H/decode) and per block work lane; the busiest device
  lane is the rate limiter (``bottleneck_lane``).

This module deliberately imports nothing from ``runtime/`` at module level:
the runtime imports *us* (block event loop, supervisor, control port), and the
doctor only ever touches runtime objects handed to :meth:`Doctor.attach`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..log import logger
from . import prom, spans
from . import journal as _journal
from . import lineage as _lineage
from . import profile as _profile

__all__ = [
    "Doctor", "doctor", "enable", "disable", "enabled", "flight_record",
    "report", "render_markdown", "E2E_LATENCY", "WORK_DURATION", "LANES",
    "WATCHDOG_STATES",
]

log = logger("telemetry.doctor")

#: the streamed-pipeline lanes attribution unions (cat="tpu" span names)
LANES = ("encode", "H2D", "compute", "D2H", "decode")

#: every state a watchdog diagnosis can carry (``idle``: a message-plane-only
#: flowgraph with drained inboxes — waiting for events, not wedged;
#: ``compiling``: a program compile (a CUDA-graph capture) was in progress or finished inside the
#: no-progress window — the stall is the compiler's, not a deadlock;
#: ``serve_wedged``: an attached serving engine with queued frames made no
#: dispatch progress for the window — a wedged step() loop or a lane stuck
#: in drain, naming the app/bucket/stuck sessions)
WATCHDOG_STATES = ("progressing", "backpressured", "starved", "deadlocked",
                   "idle", "compiling", "serve_wedged")

# always-on histogram families (the metrics plane contract: frame-rate
# updates, never per-sample) — observation sites bind children once
E2E_LATENCY = prom.histogram(
    "fsdr_e2e_latency_seconds",
    "per-frame / per-probe end-to-end latency", ("source",))
WORK_DURATION = prom.histogram(
    "fsdr_block_work_duration_seconds",
    "duration of one work() call", ("block",))
_TRIPS = prom.counter(
    "fsdr_doctor_trips_total", "watchdog stall trips", ("state",))


class _Attached:
    """One supervised flowgraph under watch."""

    __slots__ = ("key", "blocks", "edges", "t_attach", "progress", "strikes",
                 "tripped", "diagnosis", "cancel")

    def __init__(self, key: int, blocks, edges, cancel=None):
        self.key = key
        self.blocks = list(blocks)        # WrappedKernels
        self.edges = list(edges)          # (src_wk, src_port, dst_wk, dst_port)
        self.cancel = cancel              # fn(diag, flight_record_path) — the
        #   supervisor's CancelMsg hook for doctor_action=cancel escalation
        self.t_attach = time.monotonic()
        self.progress: Optional[int] = None   # None = no baseline sample yet
        self.strikes = 0
        self.tripped = False
        self.diagnosis: Optional[dict] = None


class _AttachedServe:
    """One serving engine under watch (``serve/engine.py``) — held by WEAKREF:
    test/app churn constructs engines freely and must not leak attachments;
    a collected engine detaches itself on the next tick."""

    __slots__ = ("key", "engine", "t_attach", "frames", "strikes", "tripped",
                 "diagnosis")

    def __init__(self, key: int, engine):
        import weakref
        self.key = key
        self.engine = weakref.ref(engine)
        self.t_attach = time.monotonic()
        self.frames: Optional[int] = None     # None = no baseline sample yet
        self.strikes = 0
        self.tripped = False
        self.diagnosis: Optional[dict] = None


def _block_progress(wk) -> int:
    """Monotonic progress sum of one block. Via ``metrics()`` so fastchain/
    devchain bridges refresh their members' counters first."""
    try:
        m = wk.metrics()
    except Exception:                                  # noqa: BLE001 — a dying
        return 0                                       # block must not kill us
    p = int(m.get("work_calls", 0)) + int(m.get("messages_handled", 0))
    for key in ("items_in", "items_out"):
        v = m.get(key)
        if isinstance(v, dict):
            p += int(sum(v.values()))
    return p


def _port_state(wk) -> Tuple[dict, dict]:
    """Live (inputs, outputs) ring state of one block — occupancy, stall and
    starve counters, min_items. getattr-guarded: inplace frame-plane ports
    duck-type only part of the stream surface."""
    k = wk.kernel
    ins: Dict[str, dict] = {}
    outs: Dict[str, dict] = {}
    for p in getattr(k, "stream_inputs", ()):
        d: Dict[str, Any] = {"min_items": getattr(p, "min_items", 1),
                             "starved": getattr(p, "starved", 0)}
        avail = getattr(p, "available", None)
        if callable(avail):
            try:
                d["available"] = int(avail())
            except Exception:                          # noqa: BLE001
                pass
        fill = getattr(p, "fill", None)
        if callable(fill):
            try:
                f = fill()
                if f is not None:
                    d["fill"] = round(f, 4)
            except Exception:                          # noqa: BLE001
                pass
        fin = getattr(p, "finished", None)
        if callable(fin):
            d["finished"] = bool(fin())
        ins[p.name] = d
    for p in getattr(k, "stream_outputs", ()):
        d = {"min_items": getattr(p, "min_items", 1),
             "stalls": getattr(p, "stalls", 0)}
        space = getattr(p, "space", None)
        if callable(space) and getattr(p, "connected", False):
            try:
                d["space"] = int(space())
            except Exception:                          # noqa: BLE001
                pass
        outs[p.name] = d
    return ins, outs


def _edge_full(src_wk, src_port: str) -> Optional[bool]:
    """Is the writer side of ``src_wk.src_port`` full (below min_items of
    space)? None when the port hides its state."""
    for p in getattr(src_wk.kernel, "stream_outputs", ()):
        if p.name == src_port:
            space = getattr(p, "space", None)
            if callable(space) and getattr(p, "connected", False):
                try:
                    return space() < max(1, getattr(p, "min_items", 1))
                except Exception:                      # noqa: BLE001
                    return None
    return None


def _edge_empty(dst_wk, dst_port: str) -> Optional[bool]:
    """Is the reader side of ``dst_wk.dst_port`` starving (below min_items,
    upstream not finished)?"""
    for p in getattr(dst_wk.kernel, "stream_inputs", ()):
        if p.name == dst_port:
            avail = getattr(p, "available", None)
            if callable(avail) and getattr(p, "connected", False):
                try:
                    fin = p.finished() if callable(
                        getattr(p, "finished", None)) else False
                    return (not fin) and \
                        avail() < max(1, getattr(p, "min_items", 1))
                except Exception:                      # noqa: BLE001
                    return None
    return None


class Doctor:
    """Process-global diagnosis hub; see the module docstring for the parts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fgs: Dict[int, _Attached] = {}
        self._serve: Dict[int, _AttachedServe] = {}
        self._next_key = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.interval = 1.0
        self.window = 5
        self.last_trip: Optional[dict] = None      # most recent trip diagnosis
        self.last_report: Optional[dict] = None    # most recent flight record
        self._prev_sigusr1 = None
        self._signal_dump = False

    # -- attachment (called by the flowgraph supervisor) -----------------------
    def attach(self, blocks: Sequence, edges: Sequence, cancel=None) -> int:
        """Register a launching flowgraph's WrappedKernels + resolved stream
        edges ``(src_wk, src_port, dst_wk, dst_port)``; returns the detach
        token. ``cancel`` is the supervisor's escalation hook — called with
        ``(diagnosis, flight_record_path)`` on a trip when the
        ``doctor_action`` config knob is ``"cancel"``. Cheap enough to run
        unconditionally per launch."""
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._fgs[key] = _Attached(key, blocks, edges, cancel)
            return key

    def detach(self, token: int) -> None:
        with self._lock:
            self._fgs.pop(token, None)

    def attached(self) -> List[int]:
        with self._lock:
            return list(self._fgs)

    # -- serving-plane attachment (ServeEngine registers at construction) ------
    def attach_serve(self, engine) -> int:
        """Register a serving engine for watchdog coverage (weakref — a
        collected engine detaches itself). The engine's ``watch_sample``
        contract: a dict with monotonic ``frames``/``pending`` counters, or
        None while the engine lock is busy (a dispatch in flight IS
        progress)."""
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._serve[key] = _AttachedServe(key, engine)
            return key

    def detach_serve(self, token: int) -> None:
        with self._lock:
            self._serve.pop(token, None)

    def serve_engines(self) -> List[object]:
        """Live attached serving engines (pruning collected ones)."""
        with self._lock:
            atts = list(self._serve.items())
        out = []
        dead = []
        for key, att in atts:
            eng = att.engine()
            if eng is None:
                dead.append(key)
            else:
                out.append(eng)
        if dead:
            with self._lock:
                for key in dead:
                    self._serve.pop(key, None)
        return out

    def verdicts(self) -> dict:
        """Lock-cheap doctor verdict summary for the per-host fleet export
        (telemetry/fleet.py): the watchdog state, the most recent trip's
        diagnosis (trimmed — ``last_trip`` persists after recovery, so the
        fleet verdict reads the LIVE attached diagnoses, not history), and
        any currently-diagnosed flowgraph/serve attachment. Never takes an
        engine lock."""
        with self._lock:
            fg_diag = {str(a.key): a.diagnosis for a in self._fgs.values()
                       if a.diagnosis}
            sv_diag = {str(a.key): a.diagnosis for a in self._serve.values()
                       if a.diagnosis}
        wedged = {**fg_diag, **sv_diag}
        verdict = "ok"
        if wedged:
            verdict = next(iter(sorted(
                d.get("state", "wedged") for d in wedged.values())))
        return {"enabled": self.enabled,
                "verdict": verdict,
                "wedged": wedged or None,
                "last_trip": ({k: self.last_trip.get(k) for k in
                               ("state", "fg", "suspect_block", "detail")}
                              if self.last_trip else None)}

    # -- watchdog --------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def enable(self, interval: Optional[float] = None,
               window: Optional[int] = None) -> None:
        """Start the watchdog thread (idempotent); ``interval``/``window``
        default to the ``doctor_interval``/``doctor_window`` config knobs.
        Installs a SIGUSR1 flight-record trigger when called from the main
        thread (the handler only sets a flag; the dump runs on the watchdog
        thread — signal handlers must not take the registry locks)."""
        from ..config import config
        c = config()
        self.interval = float(interval if interval is not None
                              else c.get("doctor_interval", 1.0))
        self.window = int(window if window is not None
                          else c.get("doctor_window", 5))
        if self.enabled:
            return
        # each watchdog thread owns ITS stop event: if a wedged tick outlives
        # disable()'s join timeout, a later enable() must not hand the old
        # thread a cleared event (two concurrent tickers would double-count
        # trips and write duplicate dumps) — the old one exits on its own
        # event after its in-flight pass
        stop = threading.Event()
        self._stop = stop
        self._thread = threading.Thread(target=self._run, args=(stop,),
                                        name="fsdr-doctor", daemon=True)
        self._thread.start()
        self._install_signal()

    def disable(self) -> None:
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout=5)
            if t.is_alive():
                log.error("watchdog thread still inside a tick after 5s "
                          "(wedged metrics()?); it will exit after the "
                          "current pass")
        self._thread = None
        self._restore_signal()

    def _install_signal(self) -> None:
        import signal
        if not hasattr(signal, "SIGUSR1"):
            return
        try:
            def on_usr1(_sig, _frm):
                self._signal_dump = True
            self._prev_sigusr1 = signal.signal(signal.SIGUSR1, on_usr1)
        except ValueError:      # not the main thread: no signal trigger
            self._prev_sigusr1 = None

    def _restore_signal(self) -> None:
        import signal
        if self._prev_sigusr1 is not None and hasattr(signal, "SIGUSR1"):
            try:
                signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except ValueError:
                pass
            self._prev_sigusr1 = None

    def _run(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:                     # noqa: BLE001 — the
                log.error("watchdog tick failed: %r", e)   # dog must not die

    def tick(self) -> None:
        """One sampling pass over every attached flowgraph (the thread body;
        callable directly from tests for deterministic stepping)."""
        if self._signal_dump:
            self._signal_dump = False
            self.dump(self.flight_record("SIGUSR1"))
        try:
            # live-roofline refresh rides the watchdog cadence: the
            # fsdr_mfu/fsdr_hbm_util gauges stay fresh whenever the doctor
            # is armed (scrapes refresh too — ctrl_port /metrics)
            _profile.plane().update_live_gauges()
        except Exception as e:                         # noqa: BLE001 — the
            log.error("profile gauge refresh failed: %r", e)   # dog survives
        with self._lock:
            atts = list(self._fgs.values())
        for att in atts:
            prog = sum(_block_progress(b) for b in att.blocks)
            if att.progress is None:          # first sample: baseline only
                att.progress = prog
                continue
            if prog != att.progress:
                att.progress = prog
                att.strikes = 0
                if att.tripped:
                    log.info("flowgraph %d progressing again (watchdog "
                             "re-armed)", att.key)
                    att.tripped = False
                att.diagnosis = {"state": "progressing"}
                continue
            att.strikes += 1
            if att.strikes >= self.window and not att.tripped:
                att.tripped = True
                diag = self.diagnose(att)
                prev_state = (att.diagnosis or {}).get("state")
                att.diagnosis = diag
                benign = ("idle", "compiling")
                if diag["state"] not in benign or prev_state != diag["state"]:
                    # idle/compiling re-fire every window (the re-arm below)
                    # but are not stalls: count only the TRANSITION, so
                    # alerting on rate(fsdr_doctor_trips_total) stays
                    # meaningful
                    _TRIPS.inc(state=diag["state"])
                if diag["state"] in benign:
                    # a quiet message-plane flowgraph (idle) or an in-window
                    # program capture (compiling) is not a wedge: no flight
                    # record, no escalation — and the window RE-ARMS
                    # (tripped stays clear), so a later genuine deadlock
                    # (queued messages a wedged handler never drains, or a
                    # stall that outlives the compile) still gets diagnosed,
                    # dumped and escalated
                    att.tripped = False
                    att.strikes = 0
                    if prev_state != diag["state"]:   # first verdict only —
                        log.info("watchdog: fg %d is %s (%s)", att.key,
                                 diag["state"], diag.get("detail"))
                    self.last_trip = diag
                    continue
                log.error("watchdog trip (fg %d): %s — suspect %s via %s",
                          att.key, diag["state"], diag.get("suspect_block"),
                          diag.get("suspect_edge"))
                paths = self.dump(
                    self.flight_record(f"watchdog:{diag['state']}"))
                self._maybe_cancel(att, diag, paths)
                # published LAST: a waiter seeing last_trip can rely on the
                # flight record (last_report) being complete
                self.last_trip = diag
        self._tick_serve()

    def _tick_serve(self) -> None:
        """Watchdog pass over attached serving engines: queued frames with
        no dispatch progress for the window trip ``serve_wedged`` — a
        wedged step() loop, or a drain stuck on a lane that never finishes.
        An idle engine (nothing queued) and a busy engine lock (a dispatch
        or bucket compile in flight) both count as healthy."""
        with self._lock:
            atts = list(self._serve.items())
        for key, att in atts:
            eng = att.engine()
            if eng is None:
                with self._lock:
                    self._serve.pop(key, None)
                continue
            try:
                sample = eng.watch_sample()
            except Exception as e:                     # noqa: BLE001 — a
                log.error("serve watch sample failed: %r", e)   # dying engine
                continue                               # must not kill the dog
            if sample is None:
                # engine lock busy — a step()/compile in flight is progress
                att.strikes = 0
                continue
            frames = int(sample.get("frames", 0))
            if att.frames is None or frames != att.frames \
                    or not sample.get("pending"):
                if att.tripped and frames != att.frames:
                    log.info("serving app %s progressing again (watchdog "
                             "re-armed)", sample.get("app"))
                att.frames = frames
                att.strikes = 0
                att.tripped = False
                att.diagnosis = None
                continue
            att.strikes += 1
            if att.strikes >= self.window and not att.tripped:
                att.tripped = True
                window_s = round(att.strikes * self.interval, 3)
                comp = _profile.plane().compiling_or_recent(
                    max(window_s, 1e-9))
                if comp is not None and comp.get("in_progress"):
                    # a bucket compile explains the silence — benign,
                    # window re-arms like the flowgraph compiling verdict
                    att.tripped = False
                    att.strikes = 0
                    continue
                diag = {
                    "state": "serve_wedged",
                    "app": sample.get("app"),
                    "capacity": sample.get("capacity"),
                    "active": sample.get("active"),
                    "pending_frames": sample.get("pending"),
                    "draining": sample.get("draining"),
                    "stuck_sessions": sample.get("stuck_sessions"),
                    "no_progress_for_s": window_s,
                    "detail": (f"serving app {sample.get('app')}: "
                               f"{sample.get('pending')} queued frame(s) on "
                               f"{sample.get('active')} lane(s) made no "
                               f"dispatch progress"
                               + (" while draining"
                                  if sample.get("draining") else "")),
                }
                att.diagnosis = diag
                _TRIPS.inc(state="serve_wedged")
                log.error("watchdog trip (serve %s): %s",
                          sample.get("app"), diag["detail"])
                self.dump(self.flight_record("watchdog:serve_wedged"))
                self.last_trip = diag

    def _maybe_cancel(self, att: _Attached, diag: dict, paths) -> None:
        """``doctor_action: cancel`` escalation — after recording, cancel the
        wedged flowgraph through the supervisor's hook (the run then raises a
        FlowgraphError carrying the flight-record path instead of hanging)."""
        from ..config import config
        if att.cancel is None or \
                str(config().get("doctor_action", "record")) != "cancel":
            return
        log.error("doctor_action=cancel: cancelling wedged flowgraph %d",
                  att.key)
        try:
            att.cancel(diag, paths[0] if paths else None)
        except Exception as e:                         # noqa: BLE001 — the
            log.error("doctor cancel hook failed: %r", e)   # dog must not die

    # -- diagnosis -------------------------------------------------------------
    def diagnose(self, att: _Attached) -> dict:
        """Classify a no-progress flowgraph from live port state.

        * ``backpressured``: ≥1 full output ring. The suspect is the consumer
          at the END of the full run — the dst of a full edge that has no full
          outgoing edge of its own (it is not blocked; it is just not
          consuming).
        * ``starved``: no full rings, ≥1 input below ``min_items`` with the
          upstream unfinished. The suspect is the most upstream non-producer —
          the src of an empty edge with no empty incoming edge of its own.
        * ``deadlocked``: neither pattern (message-plane cycles, a wedged
          BLOCKING thread with empty rings, …) — the flight recorder's thread
          stacks carry the rest of the story.
        * ``idle``: a message-plane-ONLY flowgraph (no stream edges, no block
          with stream ports) whose inboxes are drained — it is waiting for
          events, not wedged, so no flight record fires. Queued-but-undrained
          messages instead classify ``deadlocked`` naming the stuck block
          (progress already samples ``messages_handled``, so a handler that IS
          draining never gets here).
        * ``compiling``: a program capture was in progress (overrides any
          verdict) or finished inside the no-progress window (downgrades a
          would-be wedge verdict only — ``idle`` stays ``idle``): the stall
          is the compiler's, not a deadlock. No flight record; the window
          re-arms so a stall outliving the compile still escalates.
        """
        window_s = round(att.strikes * self.interval, 3)
        # compile-aware verdicts (profile plane): a capture IN PROGRESS
        # explains any silence (a long first compile of a big fused program
        # used to false-trip as `deadlocked` here); a compile that FINISHED
        # inside the no-progress window only downgrades a would-be wedge
        # verdict below — an idle message-plane flowgraph stays `idle` (the
        # plane is process-global, so a finished compile says nothing about
        # THIS graph). The window re-arms either way, so a stall that
        # outlives the compile still gets a real diagnosis.
        comp = _profile.plane().compiling_or_recent(max(window_s, 1e-9))
        if comp is not None and comp.get("in_progress"):
            return self._compiling_diag(att, comp, window_s)
        if not att.edges and not any(
                getattr(b.kernel, "stream_inputs", ()) or
                getattr(b.kernel, "stream_outputs", ())
                for b in att.blocks):
            queued = {}
            for b in att.blocks:
                try:
                    n = len(getattr(b, "inbox", ()))
                except TypeError:
                    n = 0
                if n:
                    queued[b.instance_name] = n
            if queued:
                if comp is not None:
                    # the handler's thread may BE the one compiling
                    return self._compiling_diag(att, comp, window_s)
                worst = max(queued, key=queued.get)
                return self._diag(
                    "deadlocked", att, None, suspect=worst,
                    window_s=window_s,
                    detail=f"message-plane flowgraph: {queued[worst]} queued "
                           f"message(s) at {worst} are not draining")
            return self._diag(
                "idle", att, None, suspect=None, window_s=window_s,
                detail="message-plane flowgraph with drained inboxes — "
                       "waiting for events, not wedged")
        if comp is not None:
            # a compile that finished inside the no-progress window explains
            # (part of) the silence — downgrade the would-be wedge verdict
            return self._compiling_diag(att, comp, window_s)
        full = [e for e in att.edges if _edge_full(e[0], e[1])]
        if full:
            full_src = {id(e[0]) for e in full}
            suspects = [e for e in full if id(e[2]) not in full_src] or full
            e = suspects[-1]
            return self._diag("backpressured", att, e,
                              suspect=e[2].instance_name, window_s=window_s,
                              detail=f"output ring {e[0].instance_name}.{e[1]}"
                                     f" is full and {e[2].instance_name} is "
                                     "not consuming")
        empty = [e for e in att.edges if _edge_empty(e[2], e[3])]
        if empty:
            empty_dst = {id(e[2]) for e in empty}
            suspects = [e for e in empty if id(e[0]) not in empty_dst] or empty
            e = suspects[0]
            return self._diag("starved", att, e,
                              suspect=e[0].instance_name, window_s=window_s,
                              detail=f"input {e[2].instance_name}.{e[3]} is "
                                     f"empty and {e[0].instance_name} is not "
                                     "producing")
        return self._diag("deadlocked", att, None, suspect=None,
                          window_s=window_s,
                          detail="no progress, no full or starving ring — "
                                 "see thread stacks in the flight record")

    def _compiling_diag(self, att: _Attached, comp: dict, window_s: float):
        state = ("in progress" if comp.get("in_progress")
                 else f"finished {comp.get('seconds', 0)}s compile")
        return self._diag(
            "compiling", att, None, suspect=comp.get("program"),
            window_s=window_s,
            detail=f"compile (CUDA-graph capture) of {comp.get('program')} "
                   f"({comp.get('reason')}, "
                   f"sig {comp.get('signature') or '?'}) {state} inside "
                   f"the no-progress window — not a deadlock")

    @staticmethod
    def _diag(state: str, att: _Attached, edge, suspect, window_s, detail):
        return {
            "state": state,
            "fg": att.key,
            "suspect_block": suspect,
            "suspect_edge": ([edge[0].instance_name, edge[1],
                              edge[2].instance_name, edge[3]]
                             if edge is not None else None),
            "no_progress_for_s": window_s,
            "detail": detail,
        }

    # -- flight recorder -------------------------------------------------------
    def flight_record(self, reason: str, max_spans: int = 64,
                      extra: Optional[dict] = None) -> dict:
        """The black-box dump (JSON-serializable; see module docstring).
        ``extra`` lands under a ``supervisor`` key — the supervisor's error
        path surfaces its aggregated block-error count and policy decisions
        there."""
        frames = sys._current_frames()
        threads = []
        for t in threading.enumerate():
            stack = frames.get(t.ident)
            threads.append({
                "name": t.name,
                "ident": t.ident,
                "daemon": t.daemon,
                "stack": [f"{f.filename}:{f.lineno} in {f.name}: "
                          f"{(f.line or '').strip()}"
                          for f in traceback.extract_stack(stack)]
                if stack is not None else [],
            })
        with self._lock:
            atts = list(self._fgs.values())
        fgs: Dict[str, dict] = {}
        for att in atts:
            blocks: Dict[str, dict] = {}
            for b in att.blocks:
                try:
                    m = b.metrics()
                except Exception as e:                 # noqa: BLE001
                    m = {"metrics_error": repr(e)}
                ins, outs = _port_state(b)
                blocks[b.instance_name] = {**m, "inputs": ins,
                                           "outputs": outs}
            fgs[str(att.key)] = {
                "age_s": round(time.monotonic() - att.t_attach, 3),
                "diagnosis": att.diagnosis,
                "blocks": blocks,
                "edges": [[e[0].instance_name, e[1],
                           e[2].instance_name, e[3]] for e in att.edges],
            }
        serve: Dict[str, dict] = {}
        with self._lock:
            satts = list(self._serve.values())
        for att in satts:
            eng = att.engine()
            if eng is None:
                continue
            try:
                sample = eng.watch_sample()   # non-blocking: a wedged step()
            except Exception as e:            # noqa: BLE001 — holding the
                sample = {"error": repr(e)}   # engine lock must not hang the
            entry = dict(sample or {"lock": "busy"})        # flight record
            if att.diagnosis:
                entry["diagnosis"] = att.diagnosis
            serve[str(getattr(eng, "app", att.key))] = entry
        rec = spans.recorder()
        ring: Dict[str, List[dict]] = {}
        for e in rec.snapshot():              # non-destructive: other trace
            ring.setdefault(e.thread, []).append({   # consumers keep theirs
                "t0_ns": e.t0_ns, "dur_ns": e.dur_ns,
                "cat": e.cat, "name": e.name, "args": e.args})
        e2e = {f"p{int(q * 100)}_s": E2E_LATENCY.quantile(q)
               for q in (0.5, 0.95, 0.99)}
        prof = _profile.plane()
        report = {
            "reason": reason,
            "unix_time": time.time(),
            "threads": threads,
            "flowgraphs": fgs,
            "spans": {k: v[-max_spans:] for k, v in ring.items()},
            "span_drops": rec.dropped,
            "e2e_latency": e2e if e2e.get("p50_s") is not None else None,
            # compile observability (telemetry/profile.py): active compiles
            # + storm classification ride every flight record — "why is it
            # silent" and "what churned" answer from one dump (cost thunks
            # are NOT materialized here; a flight record must never compile)
            "profile": {"active_compiles": prof.active_compiles(),
                        "compiles_total": prof.compiles_total,
                        "storms": prof.storm_report() or None},
            # serving-plane coverage (serve/engine.py): every attached
            # engine's live occupancy/pending sample plus its watchdog
            # diagnosis — "which app/bucket/session is stuck" answers from
            # the same dump as the flowgraph story
            "serve": serve or None,
            # lifecycle decision history (telemetry/journal.py): the last-N
            # structured events ride every flight record, so the black box
            # carries WHAT the runtime decided next to what it was doing
            "journal": _journal.journal().last(32) or None,
            # sampled per-frame tail attribution (telemetry/lineage.py):
            # which lane/session the slow frames spent their time in
            "tail": _lineage.tail_report(),
            # cross-host fleet view (telemetry/fleet.py): per-host states +
            # verdicts when this process runs a FleetView aggregator — a
            # flight record from the routing front door carries WHERE the
            # fleet stood when it tripped
            "fleet": _fleet_section(),
            "metrics": prom.registry().render(),
        }
        if extra is not None:
            report["supervisor"] = extra
        self.last_report = report
        return report

    def dump(self, report: dict) -> Optional[Tuple[str, str]]:
        """Write ``report`` as ``doctor_<ts>.json`` + ``.md`` under the
        ``doctor_dir`` config knob; no-op (memory-only, ``last_report``)
        when unset."""
        from ..config import config
        d = config().get("doctor_dir", "")
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            stem = os.path.join(
                d, f"doctor_{os.getpid()}_{int(report['unix_time'])}")
            with open(stem + ".json", "w") as f:
                json.dump(report, f, indent=2, default=str)
            with open(stem + ".md", "w") as f:
                f.write(render_markdown(report))
            log.error("flight record written: %s.json", stem)
            return stem + ".json", stem + ".md"
        except OSError as e:
            log.error("flight record write failed: %r", e)
            return None

    def on_supervisor_error(self, err: BaseException,
                            extra: Optional[dict] = None
                            ) -> Optional[Tuple[str, str]]:
        """Supervisor-exception trigger: only records when the watchdog is
        enabled (an expected test-suite FlowgraphError must not spam dumps).
        Returns the dump paths (if written) so the supervisor can attach them
        to its structured FlowgraphError; ``extra`` (error counts, policy
        decisions) lands under the record's ``supervisor`` key."""
        if self.enabled:
            return self.dump(self.flight_record(
                f"supervisor_error:{err!r}", extra=extra))
        return None

    # -- bottleneck attribution ------------------------------------------------
    def report(self, events: Optional[Sequence[spans.SpanEvent]] = None,
               ) -> dict:
        """Interval-union busy fraction per lane over trace events.

        ``events=None`` DRAINS the process recorder (pass
        ``recorder().snapshot()`` to leave the ring for other consumers).
        Lanes: the device-plane spans (encode/H2D/compute/D2H/decode) and one
        ``work:<block>`` lane per actor block. ``bottleneck_lane`` is the
        busiest DEVICE lane when any device span exists (a BLOCKING kernel's
        work() span contains its own waits, so work lanes would always win),
        else the busiest work lane.
        """
        evs = list(spans.drain() if events is None else events)
        lane_iv = {n: spans.intervals(evs, name=n, cat="tpu") for n in LANES}
        blocks: Dict[str, list] = {}
        for e in evs:
            if e.cat == "block" and e.dur_ns is not None:
                blocks.setdefault(e.name, []).append(
                    (e.t0_ns, e.t0_ns + e.dur_ns))
        all_iv = [iv for ivs in lane_iv.values() for iv in ivs] + \
                 [iv for ivs in blocks.values() for iv in ivs]
        if all_iv:
            t0 = min(s for s, _ in all_iv)
            t1 = max(e for _, e in all_iv)
            wall = max(1, t1 - t0)
        else:
            wall = 0
        def lane_entry(iv):
            busy = spans.union_ns(iv)
            return {"spans": len(iv), "busy_s": busy / 1e9,
                    "busy_frac": (busy / wall) if wall else 0.0}
        lanes = {n: lane_entry(iv) for n, iv in lane_iv.items()}
        work = {f"work:{n}": lane_entry(iv) for n, iv in blocks.items()}
        # mesh-sharded runs (shard/): one lane PER DEVICE SHARD
        # from the runner's cat="shard" spans ("shard:d0"…"shard:d7") — each
        # shard's interval is its dispatch window (per-device on-chip timing
        # is not host-visible; the window is when that shard's lane held the
        # device), so a dead shard shows as an idle lane next to its busy
        # siblings
        shard_sp: Dict[str, list] = {}
        for e in evs:
            if e.cat == "shard" and e.dur_ns is not None:
                shard_sp.setdefault(e.name, []).append(
                    (e.t0_ns, e.t0_ns + e.dur_ns))
        shard_lanes = {n: lane_entry(iv)
                       for n, iv in sorted(shard_sp.items())}
        device_busy = {n: v["busy_frac"] for n, v in lanes.items()
                       if v["spans"]}
        if device_busy:
            bottleneck = max(device_busy, key=device_busy.get)
            frac = device_busy[bottleneck]
        elif work:
            bottleneck = max(work, key=lambda n: work[n]["busy_frac"])
            frac = work[bottleneck]["busy_frac"]
        else:
            bottleneck, frac = None, 0.0
        e2e = {f"p{int(q * 100)}_s": E2E_LATENCY.quantile(q)
               for q in (0.5, 0.95, 0.99)}
        # fused device-graph runs (runtime/devchain.py): one entry per
        # `devchain` span, with the fan-out runs' per-branch attribution
        # (branch index, tail block, items out, early-retired?) passed
        # through from the span args — so a report says WHICH branch of a
        # fused region carried the output, not just that the region ran
        devchains = []
        for e in evs:
            if e.cat != "devchain" or e.dur_ns is None:
                continue
            a = e.args or {}
            entry = {"name": e.name, "dur_s": e.dur_ns / 1e9,
                     "members": a.get("members"),
                     "frames": a.get("frames"),
                     "dispatches": a.get("dispatches"),
                     "frames_per_dispatch": a.get("frames_per_dispatch")}
            if a.get("branches"):
                entry["branches"] = a["branches"]
            if a.get("sinks"):
                # general DAG regions: per-SINK attribution (+ merge count)
                entry["sinks"] = a["sinks"]
                entry["merges"] = a.get("merges")
            devchains.append(entry)
        # host codec lanes (encode ∪ decode) against the wall: with the codec
        # worker pool armed (ops/codec_pool.py) these spans land in worker
        # threads, so this fraction is how much of the run the host codec
        # genuinely overlapped under the wire/compute lanes
        # (`host_codec_overlap_frac`)
        codec_iv = lane_iv.get("encode", []) + lane_iv.get("decode", [])
        codec_frac = (spans.union_ns(codec_iv) / wall) if wall else 0.0
        # staging-arena occupancy snapshot (ops/arena.py): hit/miss totals and
        # currently pinned/pooled bytes — steady state shows misses flat and
        # hits climbing once the in-flight window's buffers warmed up
        from ..ops.arena import arena_stats
        # live roofline attribution (telemetry/profile.py): refresh the
        # windowed gauges, then merge each program's hbm/compute-bound
        # classification into the lane verdict — the bottleneck names the
        # binding RESOURCE, not just the busiest lane
        prof = _profile.plane()
        try:
            # default min_interval: a client polling the doctor endpoint
            # must not shrink the gauge window into per-dispatch noise
            prof.update_live_gauges()
        except Exception:                              # noqa: BLE001
            pass
        roofline = prof.roofline_report()
        resource = None
        if bottleneck is not None:
            if bottleneck in ("H2D", "D2H"):
                resource = "link"
            elif bottleneck in ("encode", "decode") or \
                    bottleneck.startswith("work:"):
                resource = "host"
            elif bottleneck == "compute":
                # the compute lane is bound by whatever resource its
                # dominant program sits on: the roofline classification of
                # the program with the most dispatched units (fallback:
                # "device" when no program registered a cost)
                progs = [(v.get("units", 0), v.get("bound"))
                         for v in roofline["programs"].values()
                         if v.get("bound")]
                resource = max(progs)[1] if progs else "device"
        # serving-plane section: each attached engine's full describe()
        # (slots, buckets, shed ladder, persistence) when its lock is free
        # within a short grace, else the non-blocking watch sample — an
        # operator report must not hang on a wedged step()
        serve: Dict[str, dict] = {}
        for eng in self.serve_engines():
            serve[str(getattr(eng, "app", "?"))] = _serve_describe(eng)
        return {
            "wall_s": wall / 1e9,
            "lanes": lanes,
            "blocks": work,
            "bottleneck_lane": bottleneck,
            "bottleneck_busy_frac": round(frac, 4),
            "bottleneck_resource": resource,
            "host_codec_overlap_frac": round(codec_frac, 4),
            "arena": arena_stats(),
            "e2e_latency": e2e if e2e.get("p50_s") is not None else None,
            "devchain": devchains or None,
            "serve": serve or None,
            # mesh-sharded device plane (shard/): published
            # shard plans + live runner stats, and the per-shard lanes above
            "shard": _shard_section(shard_lanes) or None,
            # sampled-frame tail attribution (telemetry/lineage.py): per-lane
            # contribution to sampled e2e, slowest lane (commensurable with
            # the interval-union bottleneck_lane above — same stamp
            # boundaries as the cat="tpu" spans), slowest session/tenant
            "tail": _lineage.tail_report(),
            # cross-host fleet section (telemetry/fleet.py): aggregated
            # readyz + per-host table + verdicts (host-down, host-wedged,
            # pressure-skew, fleet-compile-storm) — None unless this
            # process runs a FleetView aggregator
            "fleet": _fleet_section(),
            "roofline": roofline,
            "compile_storms": prof.storm_report() or None,
            # interior-precision plans (ops/precision.py): per program, the
            # applied mode, each edge's accum/edge verdict with its MEASURED
            # SNR, and every decline reason — None until a kernel publishes
            "precision": _precision_plans() or None,
        }


def _serve_describe(eng) -> Optional[dict]:
    """An engine's describe() without risking a hang: take the engine lock
    only under a short timeout (a wedged step() holds it indefinitely) and
    fall back to the non-blocking watch sample."""
    lock = getattr(eng, "_lock", None)
    try:
        if lock is not None and lock.acquire(timeout=0.2):
            try:
                return eng.describe()
            finally:
                lock.release()
    except Exception:                                  # noqa: BLE001
        pass
    try:
        return eng.watch_sample() or {"lock": "busy"}
    except Exception as e:                             # noqa: BLE001
        return {"error": repr(e)}


def _fleet_section() -> Optional[dict]:
    """The fleet plane's report section (telemetry/fleet.py): the live
    FleetView's aggregated snapshot, None while the plane is disabled.
    Guarded exactly like the precision plans — a report must come out
    even with the fleet plane half-imported."""
    try:
        from . import fleet
        return fleet.fleet_section()
    except Exception:                                  # noqa: BLE001
        return None


def _precision_plans() -> dict:
    """Published interior-precision plans, keyed by program name (guarded:
    the doctor must report even when the ops plane is half-imported)."""
    try:
        from ..ops.precision import plans_report
        return plans_report()
    except Exception:                                  # noqa: BLE001
        return {}


def _shard_section(shard_lanes: dict) -> dict:
    """The mesh-sharded plane's report section: published shard plans with
    their runners' live stats (shard/plan.py) plus the
    per-shard dispatch-window lanes collected from cat="shard" spans.
    Guarded exactly like the precision plans."""
    try:
        from ..shard.plan import plans_report
        plans = plans_report()
    except Exception:                                  # noqa: BLE001
        plans = {}
    out: dict = {}
    if plans:
        out["plans"] = plans
    if shard_lanes:
        out["lanes"] = shard_lanes
    return out


# ---------------------------------------------------------------------------
# markdown rendering
# ---------------------------------------------------------------------------

def render_markdown(report: dict) -> str:
    """Human-readable rendering of a flight record."""
    out = [f"# Flight record — {report.get('reason', '?')}",
           "",
           f"wall time: {report.get('unix_time')}  ·  "
           f"span drops: {report.get('span_drops', 0)}"]
    e2e = report.get("e2e_latency")
    if e2e:
        out += ["", "## End-to-end latency", ""]
        out += [f"- {k}: {v * 1e3:.3f} ms" for k, v in e2e.items()
                if v is not None]
    for key, fg in (report.get("flowgraphs") or {}).items():
        out += ["", f"## Flowgraph {key} (age {fg.get('age_s')}s)", ""]
        diag = fg.get("diagnosis")
        if diag:
            out.append(f"**diagnosis**: `{diag.get('state')}` — "
                       f"{diag.get('detail', '')}")
            if diag.get("suspect_edge"):
                s = diag["suspect_edge"]
                out.append(f"**suspect edge**: `{s[0]}.{s[1]} → {s[2]}.{s[3]}`")
            out.append("")
        out.append("| block | work_calls | items in | items out | "
                   "stalls | starved | fill |")
        out.append("|---|---|---|---|---|---|---|")
        for name, b in (fg.get("blocks") or {}).items():
            ii = sum((b.get("items_in") or {}).values())
            io_ = sum((b.get("items_out") or {}).values())
            st = sum((b.get("stalls") or {}).values())
            sv = sum((b.get("starved") or {}).values())
            fills = [v.get("fill") for v in (b.get("inputs") or {}).values()
                     if v.get("fill") is not None]
            fill = f"{max(fills):.2f}" if fills else "-"
            out.append(f"| {name} | {b.get('work_calls', 0)} | {ii} | {io_} |"
                       f" {st} | {sv} | {fill} |")
    threads = report.get("threads") or []
    out += ["", f"## Threads ({len(threads)})", ""]
    for t in threads:
        out.append(f"### {t['name']} (ident {t['ident']}"
                   f"{', daemon' if t.get('daemon') else ''})")
        out.append("```")
        out.extend(t.get("stack") or ["<no frames>"])
        out.append("```")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# module-level singleton + convenience wrappers
# ---------------------------------------------------------------------------

_doctor: Optional[Doctor] = None
_doc_lock = threading.Lock()


def doctor() -> Doctor:
    """The process-global doctor (created on first use)."""
    global _doctor
    if _doctor is None:
        with _doc_lock:
            if _doctor is None:
                _doctor = Doctor()
    return _doctor


def enable(interval: Optional[float] = None,
           window: Optional[int] = None) -> None:
    doctor().enable(interval, window)


def disable() -> None:
    doctor().disable()


def enabled() -> bool:
    return doctor().enabled


def flight_record(reason: str = "manual") -> dict:
    return doctor().flight_record(reason)


def report(events: Optional[Sequence[spans.SpanEvent]] = None) -> dict:
    return doctor().report(events)

"""Live profile plane: compile observability + runtime roofline attribution.

The port's rewrite of ``futuresdr_tpu/telemetry/profile.py``. There a
program is an XLA executable whose ``cost_analysis()`` is read; here a
program is a CUDA graph (``ops/stages.py`` ``CompiledPipeline``; the CPU's
``EagerProgram`` stands in for it), which has no cost analysis, so the plane
bills the analytic counts the port already keeps: ``utils/roofline.py``
``program_cost`` (each stage's ``Stage.cost``, the hand kernels'
``kernel_cost``, the wire's codec), the same counts the kernels' bounds are
taken from. Every program the runtime captures — ``TpuKernel``/
``TpuFanoutKernel``/``TpuDagKernel`` inits, restarts, ``recover()`` and wire
switches, a resident ``Pipeline.compile``, ``ServeEngine`` slot buckets,
kernel-plan sweeps — reports through ONE process-global
:class:`ProfilePlane`, and every dispatched program bills its registered
flops/bytes so the card's live utilization is a gauge. Two halves:

* **Compile observability.** A "compile" is a CUDA-graph capture with its
  eager warm-up (the kernels' builds, the library plans, the stages' lazy
  tables). :func:`compiling` wraps a capture site (the in-progress window
  is visible to the doctor — a long first capture is "compiling", never
  "deadlocked"); :func:`record_compile` bills
  ``fsdr_compiles_total{program,reason}`` and the ``fsdr_compile_seconds``
  histogram. Reasons: ``warmup`` (first init), ``reinit`` (a restart's
  fresh init, a wire or precision switch, a recapture for a changed carry
  shape), ``recover`` (checkpoint recovery), ``serve_bucket`` (a serving
  slot bucket's capture), ``autotune`` (sweep warm-ups — excluded from storm
  detection so a tuning session never reads as a recompile storm), ``cost``.
  A bounded recent-compiles ring feeds :meth:`ProfilePlane.storm_report`,
  which names the program and the shape signatures that churned.

* **Runtime roofline attribution.** :func:`register` binds a program name
  to its per-unit flops/bytes (computed LAZILY via ``cost_thunk`` so
  registering at init costs nothing; :meth:`ProfilePlane.ensure_costs`
  materializes when the plane is actually read). Dispatch sites call the
  returned entry's :meth:`_Program.dispatch` right after a replay is
  launched — a lock-free counter add at dispatch-group rate, inside the
  telemetry overhead budget; the site passes its own
  ``t=time.monotonic()`` group stamp — and
  :meth:`ProfilePlane.update_live_gauges` turns the windowed unit rate into
  always-on ``fsdr_mfu{program}`` / ``fsdr_hbm_util{program}`` gauges (plus
  Perfetto counter tracks when the span recorder is enabled). The "unit" is
  whatever the registrar says its cost covers: one dispatch group for the
  streamed kernels (the wired megabatch program, K frames per unit), one
  session-frame (lane) for the serving engine, one call for a resident
  program. The rate is host-observed launches, not the card's execution
  (nothing here synchronizes with the card). Peaks come from
  ``utils/roofline.detect_peaks`` (the card's published figures), or from
  the ``peak_flops``/``peak_hbm_gbps`` config pair when both are set; on the
  CPU and on an unknown card there is none and the plane degrades to
  flops/bytes only (no gauge against a wrong denominator).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import prom, spans

__all__ = [
    "ProfilePlane", "plane", "register", "compiling", "record_compile",
    "COMPILES", "COMPILE_SECONDS", "MFU", "HBM_UTIL", "MFU_DEVICE",
    "HBM_UTIL_DEVICE", "COMPILE_REASONS",
]

#: the compile-site vocabulary (free-form strings are accepted; these are
#: the ones the runtime emits — see the module docstring for meanings)
COMPILE_REASONS = ("warmup", "reinit", "recover", "serve_bucket",
                   "autotune", "cost")

COMPILES = prom.counter(
    "fsdr_compiles_total",
    "program compiles (CUDA-graph captures) by program and reason",
    ("program", "reason"))
COMPILE_SECONDS = prom.histogram(
    "fsdr_compile_seconds",
    "wall-clock seconds of one program capture (eager warm-up included)",
    ("program",))
MFU = prom.gauge(
    "fsdr_mfu",
    "live model-flops utilization per program (windowed dispatch rate x "
    "registered flops/unit vs the card peak)", ("program",))
HBM_UTIL = prom.gauge(
    "fsdr_hbm_util",
    "live HBM bandwidth utilization per program (windowed dispatch rate x "
    "registered bytes/unit vs the card peak)", ("program",))
# per-DEVICE attribution of the same two gauges (the mesh-sharded device
# plane, shard/): a sharded program registers one entry per
# shard (register(..., device="3")) and its runner bills each device's
# units, so fsdr_mfu attribution gains the device axis next to program
MFU_DEVICE = prom.gauge(
    "fsdr_mfu_device",
    "live model-flops utilization per (program, device shard) — the "
    "mesh-sharded plane's per-card attribution", ("program", "device"))
HBM_UTIL_DEVICE = prom.gauge(
    "fsdr_hbm_util_device",
    "live HBM bandwidth utilization per (program, device shard)",
    ("program", "device"))


class _Program:
    """One registered program's live accounting. ``dispatch()`` is the hot
    hook — after the first call swaps the slot to :meth:`_dispatch_hot`, a
    bare counter add (plus an is-None check) per dispatch GROUP (frame
    rate, never sample rate), billed by the telemetry overhead gate as its
    fourth hook class. The run-average window's right edge ``t_last`` is
    stamped by the dispatch SITE passing ``t=time.monotonic()`` — the
    kernel drive loop and the serving step do µs–ms of real work per
    group, so the one clock read is theirs to pay at true group rate, not
    this hook's (the gate conservatively bills the hook at work-call
    rate). A refresher-advanced edge was tried instead and rejected: it
    dilutes ``mfu_avg`` by however long the plane sat unread after the run
    (on a bench without an armed doctor, the whole post-run section
    sweep). It is deliberately LOCK-FREE: every program entry has exactly
    one writer (the owning kernel's drain thread / the serving engine's
    step caller under its own engine lock), and the gauge refresher only
    READS the counters — a read racing a write costs at most one unit of
    window skew, never corruption. The lock guards only the cold
    cost-thunk handoff."""

    __slots__ = ("name", "_lock", "units", "t_first", "t_last", "cost",
                 "_cost_thunk", "_window_t", "_window_units", "_units_first",
                 "achieved_flops", "achieved_bytes", "mfu",
                 "hbm_util", "dispatch", "compute_dtype", "device")

    def __init__(self, name: str, device: Optional[str] = None):
        self.name = name
        self.device = device            # shard label ("0"…"7") of a mesh-
        #   sharded program's per-device entry, None for whole-program
        #   entries — selects the per-device gauge family
        self._lock = threading.Lock()
        self.compute_dtype = "f32"      # dominant compute dtype — keys the
        #   MFU denominator on the right per-dtype card peak
        #   (utils/roofline.dtype_peak_flops)
        self.units = 0                  # cost units dispatched (monotonic)
        self._units_first = 0           # units billed by the FIRST dispatch
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.cost: Optional[dict] = None          # {"flops","bytes"} per unit
        self._cost_thunk = None
        self._window_t: Optional[float] = None    # gauge-window left edge
        self._window_units = 0
        self.achieved_flops: Optional[float] = None
        self.achieved_bytes: Optional[float] = None
        self.mfu: Optional[float] = None
        self.hbm_util: Optional[float] = None
        self.dispatch = self._dispatch_first

    def _dispatch_first(self, units: int = 1,
                        t: Optional[float] = None) -> None:
        """The first dispatch seeds the run-average window's left edge,
        then swaps the ``dispatch`` slot to the steady-state hook. The
        guard keeps a stale bound reference captured before the first call
        correct."""
        self.units += units
        if self.t_first is None:
            self.t_first = self.t_last = \
                t if t is not None else time.monotonic()
            self._units_first = self.units
            self.dispatch = self._dispatch_hot
        elif t is not None:
            self.t_last = t

    def _dispatch_hot(self, units: int = 1,
                      t: Optional[float] = None) -> None:
        self.units += units
        if t is not None:
            self.t_last = t

    def ensure_cost(self) -> Optional[dict]:
        """Materialize the lazily-registered cost (one analytic count per
        program SIGNATURE, cached in utils/roofline). A failing
        thunk degrades this program to dispatch-counting only — the plane
        must never take a flowgraph down."""
        with self._lock:
            thunk, self._cost_thunk = self._cost_thunk, None
        if self.cost is None and thunk is not None:
            try:
                c = thunk()
                if c is not None:
                    self.cost = {"flops": float(c["flops"]),
                                 "bytes": float(c["bytes"])}
            except Exception:                       # noqa: BLE001
                pass
        return self.cost


class _Compiling:
    """Context manager marking one compile+warmup window active (the doctor
    reads it) and billing the record on exit."""

    __slots__ = ("_plane", "_entry", "_t0", "seconds")

    def __init__(self, plane: "ProfilePlane", program: str, reason: str,
                 signature: str):
        self._plane = plane
        self._entry = {"program": str(program), "reason": str(reason),
                       "signature": str(signature)}
        self.seconds = 0.0              # the window's length, once it closed

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._entry["since"] = time.monotonic()
        with self._plane._lock:
            self._plane._active.append(self._entry)
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = self.seconds = time.perf_counter() - self._t0
        with self._plane._lock:
            try:
                self._plane._active.remove(self._entry)
            except ValueError:
                pass
        # a raising site did NOT make a program resident — billing it would
        # overcount fsdr_compiles_total on every retry (a transient dispatch
        # fault inside a serve bucket's first step re-enters this window per
        # retry with the jit cache already warm) and could read as a storm.
        # The doctor still saw the in-progress window; the failure itself is
        # the error path's to report.
        if exc_type is None:
            self._plane.record_compile(self._entry["program"],
                                       self._entry["reason"],
                                       self._entry["signature"], secs)
        return False


class ProfilePlane:
    """Process-global compile + roofline accounting; see module docstring."""

    #: storm classification defaults: >= threshold non-autotune compiles of
    #: one program inside the window
    storm_window_s = 60.0
    storm_threshold = 3
    #: reasons that compile BY DESIGN: never a storm, and a FINISHED record
    #: never downgrades a wedge verdict to "compiling" (an autotune sweep or
    #: a one-off cost analysis in another thread says nothing about a
    #: genuinely deadlocked flowgraph; in-progress windows still count —
    #: the compiling thread may be the stalled one)
    benign_reasons = ("autotune", "cost")

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: Dict[str, _Program] = {}
        self._active: List[dict] = []             # in-progress compile sites
        #: (t_end_monotonic, program, reason, signature, seconds) — bounded:
        #: storm detection needs a window, not a history
        self._recent: deque = deque(maxlen=512)
        self.compiles_total = 0
        self.compile_seconds_total = 0.0

    # -- compile observability -------------------------------------------------
    def compiling(self, program: str, reason: str,
                  signature: str = "") -> _Compiling:
        """``with plane.compiling("TpuKernel_3", "warmup", "frame=262144"):``
        around a capture site — active for the doctor, billed on
        exit."""
        return _Compiling(self, program, reason, signature)

    def record_compile(self, program: str, reason: str, signature: str = "",
                       seconds: float = 0.0) -> None:
        program, reason = str(program), str(reason)
        COMPILES.inc(program=program, reason=reason)
        COMPILE_SECONDS.observe(float(seconds), program=program)
        with self._lock:
            self._recent.append((time.monotonic(), program, reason,
                                 str(signature), float(seconds)))
            self.compiles_total += 1
            self.compile_seconds_total += float(seconds)
        # every compile the runtime bills funnels through here — the one
        # journal emit covers kernel warmups, recoveries, serve buckets and
        # autotune sweeps alike (telemetry/journal.py)
        from . import journal as _journal
        _journal.emit("compile", "compile", program=program, reason=reason,
                      signature=str(signature), seconds=round(float(seconds),
                                                              6))

    def active_compiles(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._active]

    def compiling_or_recent(self, window_s: float) -> Optional[dict]:
        """The doctor's watchdog check: an IN-PROGRESS compile, or one that
        finished inside the last ``window_s`` seconds (a no-progress window
        that contains a compile is not a deadlock — the stall is the
        compiler's). Finished records with a :data:`benign_reasons` reason
        are skipped — a background tuning sweep must not mask a genuine
        deadlock for its whole session. None when the window is
        compile-free."""
        now = time.monotonic()
        with self._lock:
            if self._active:
                e = dict(self._active[-1])
                e["in_progress"] = True
                e["for_s"] = round(now - e.pop("since", now), 3)
                return e
            for t_end, program, reason, sig, secs in reversed(self._recent):
                if t_end >= now - window_s and \
                        reason not in self.benign_reasons:
                    return {"program": program, "reason": reason,
                            "signature": sig, "seconds": round(secs, 3),
                            "in_progress": False}
        return None

    def storm_report(self, window_s: Optional[float] = None) -> List[dict]:
        """Recompile storms: programs with >= ``storm_threshold`` compiles
        inside the window, NAMING the shape signatures that churned.
        ``reason="autotune"`` records never count — a tuning sweep compiles
        by design."""
        window = float(window_s if window_s is not None
                       else self.storm_window_s)
        cutoff = time.monotonic() - window
        with self._lock:
            recent = list(self._recent)
        per: Dict[str, list] = {}
        for t_end, program, reason, sig, _secs in recent:
            if t_end < cutoff or reason in self.benign_reasons:
                continue
            per.setdefault(program, []).append(sig)
        out = []
        for program, sigs in sorted(per.items()):
            if len(sigs) >= self.storm_threshold:
                out.append({"program": program, "compiles": len(sigs),
                            "signatures": sorted(set(sigs)),
                            "signature_churn": len(set(sigs)) > 1,
                            "window_s": window})
        return out

    # -- roofline attribution --------------------------------------------------
    def register(self, program: str, cost: Optional[dict] = None,
                 cost_thunk=None, dtype: Optional[str] = None,
                 device: Optional[str] = None) -> _Program:
        """Get-or-create the program's live entry; an explicit ``cost``
        ({"flops", "bytes"} per unit) binds immediately, ``cost_thunk``
        defers the cost-analysis compile until the plane is read
        (:meth:`ensure_costs`). Re-registration updates the cost source and
        keeps the dispatch counters (a restart re-inits the same program).
        ``dtype`` declares the program's dominant compute dtype ("f32"
        default / "bf16" for interior-precision-lowered programs) — the MFU
        denominator keys on it (utils/roofline.dtype_peak_flops), so an
        f32 chain grades against the f32 peak, not the bf16 one it cannot
        reach. ``device`` registers a mesh-sharded program's PER-DEVICE
        entry (one per shard, next to the whole-program one): its gauges
        land in ``fsdr_mfu_device{program,device}`` and its registry key is
        ``program@dev<device>`` so shards never collide with the
        aggregate."""
        name = str(program)
        key = name if device is None else f"{name}@dev{device}"
        with self._lock:
            p = self._programs.get(key)
            if p is None:
                p = self._programs[key] = _Program(name, device=device)
        if dtype is not None:
            p.compute_dtype = str(dtype)
        if cost is not None:
            p.cost = {"flops": float(cost["flops"]),
                      "bytes": float(cost["bytes"])}
        elif cost_thunk is not None:
            # re-registration REPLACES the cost source even when a previous
            # incarnation's cost already materialized — a re-init can change
            # the program (frame/wire/K), and a stale cost silently skews
            # every gauge. Rematerialization is one signature-cache lookup
            # when the program is in fact unchanged. For the same reason the
            # RUN-AVERAGE window restarts at this incarnation (the cumulative
            # `units` counter survives — it is the monotonic /metrics-style
            # figure): mfu_avg must never multiply an old incarnation's
            # units by the new incarnation's cost when the program changed
            # (bench's in-process frame probes collide on per-flowgraph
            # instance names with different frame sizes). No dispatch can
            # race this reset — registration happens inside the owning
            # kernel's init, with the previous incarnation's drain quiesced.
            with p._lock:
                p._cost_thunk = cost_thunk
                p.cost = None
            p.t_first = p.t_last = None
            p._units_first = p.units
            p._window_t = None
            p._window_units = p.units
            p.mfu = p.hbm_util = None
            p.achieved_flops = p.achieved_bytes = None
            p.dispatch = p._dispatch_first
        return p

    def program(self, name: str) -> Optional[_Program]:
        with self._lock:
            return self._programs.get(str(name))

    def programs(self) -> List[_Program]:
        with self._lock:
            return list(self._programs.values())

    def ensure_costs(self) -> None:
        """Materialize every lazily-registered cost (cached per signature in
        utils/roofline, so repeated calls are free)."""
        for p in self.programs():
            p.ensure_cost()

    _NO_PEAKS = object()

    def _peaks(self) -> Optional[dict]:
        """The card's peaks: the ``peak_flops``/``peak_hbm_gbps`` config
        pair when both are set, else ``utils/roofline.detect_peaks`` of the
        card (read once: the card does not change under a process), None on
        the CPU and on an unknown card."""
        from ..config import config
        c = config()
        try:
            pf = float(c.get("peak_flops", 0) or 0)
            pb = float(c.get("peak_hbm_gbps", 0) or 0)
        except (TypeError, ValueError):
            pf = pb = 0.0
        if pf > 0 and pb > 0:
            return {"flops": pf, "hbm_bytes": pb * 1e9, "chip": "config"}
        peaks = getattr(self, "_card_peaks", self._NO_PEAKS)
        if peaks is self._NO_PEAKS:
            try:
                from ..utils.roofline import detect_peaks
                peaks = detect_peaks()
            except Exception:                       # noqa: BLE001
                peaks = None
            self._card_peaks = peaks
        return peaks

    def update_live_gauges(self, min_interval: float = 0.25) -> None:
        """Refresh ``fsdr_mfu``/``fsdr_hbm_util`` from each program's unit
        rate over the window since the previous refresh (the doctor's tick
        and the /metrics scrape both call this — ``min_interval`` keeps a
        scrape storm from degenerating the window into noise). Programs
        whose cost is not materialized, and cards without a known peak,
        simply publish nothing — degradation, not a wrong denominator."""
        peaks = self._peaks()
        rec = spans.recorder()
        now = time.monotonic()
        for p in self.programs():
            units = p.units               # single reader of the window state
            if p.cost is None:
                continue
            if p._window_t is None:
                p._window_t, p._window_units = now, units
                continue
            dt = now - p._window_t
            if dt < min_interval:
                continue
            du = units - p._window_units
            p._window_t, p._window_units = now, units
            rate = du / dt if dt > 0 else 0.0
            p.achieved_flops = rate * p.cost["flops"]
            p.achieved_bytes = rate * p.cost["bytes"]
            if not peaks:
                continue
            from ..utils.roofline import dtype_peak_flops
            p.mfu = p.achieved_flops / dtype_peak_flops(peaks,
                                                        p.compute_dtype)
            p.hbm_util = p.achieved_bytes / peaks["hbm_bytes"]
            if p.device is None:
                MFU.set(p.mfu, program=p.name)
                HBM_UTIL.set(p.hbm_util, program=p.name)
            else:
                # a mesh-sharded program's per-shard entry: the device axis
                # rides its own gauge family so the aggregate exposition
                # keeps its one-label shape
                MFU_DEVICE.set(p.mfu, program=p.name, device=p.device)
                HBM_UTIL_DEVICE.set(p.hbm_util, program=p.name,
                                    device=p.device)
            if rec.enabled:
                # Perfetto counter tracks next to the lane spans
                tag = p.name if p.device is None \
                    else f"{p.name}@dev{p.device}"
                rec.counter(f"mfu:{tag}", p.mfu)
                rec.counter(f"hbm_util:{tag}", p.hbm_util)

    # -- snapshots -------------------------------------------------------------
    def roofline_report(self) -> dict:
        """Per-program roofline table for ``doctor.report()["roofline"]``:
        registered cost, windowed+run-average utilization, and the
        hbm/compute-bound classification against the card's ridge point."""
        peaks = self._peaks()
        ridge = (peaks["flops"] / peaks["hbm_bytes"]) if peaks else None
        out: Dict[str, dict] = {}
        for p in self.programs():
            entry: dict = {"units": p.units}
            if p.device is not None:
                entry["device"] = p.device
            if p.cost is not None:
                fl, by = p.cost["flops"], p.cost["bytes"]
                ai = fl / max(by, 1e-12)
                entry.update({
                    "flops_per_unit": fl, "bytes_per_unit": by,
                    "arith_intensity": round(ai, 4),
                    "compute_dtype": p.compute_dtype,
                })
                # the peak (and so the ridge) is keyed per program on its
                # dominant compute dtype: an f32 chain classifies and grades
                # against the card's f32 peak
                if peaks:
                    from ..utils.roofline import dtype_peak_flops
                    pfl = dtype_peak_flops(peaks, p.compute_dtype)
                    entry["bound"] = ("hbm" if ai < pfl / peaks["hbm_bytes"]
                                      else "compute")
                if p.mfu is not None:
                    entry["mfu"] = round(p.mfu, 6)
                    entry["hbm_util"] = round(p.hbm_util, 6)
                # run-average over first..last dispatch (the bench stamp):
                # robust to idle tails the windowed gauge would decay
                # through. The FIRST dispatch's units mark the interval's
                # left edge and don't count toward it — units/(t1-t0) would
                # inflate short runs by units/(units-1)
                t0, t1 = p.t_first, p.t_last
                units = p.units - p._units_first
                if peaks and t0 is not None and t1 is not None and t1 > t0 \
                        and units >= 1:
                    rate = units / (t1 - t0)
                    entry["mfu_avg"] = round(rate * fl / pfl, 6)
                    entry["hbm_util_avg"] = round(
                        rate * by / peaks["hbm_bytes"], 6)
            out[p.name if p.device is None
                else f"{p.name}@dev{p.device}"] = entry
        return {"peaks": peaks, "ridge_flop_per_byte":
                (round(ridge, 2) if ridge is not None else None),
                "programs": out}

    def snapshot(self, ensure_costs: bool = False) -> dict:
        """The full profile view (the REST ``/api/fg/{fg}/profile/`` body).
        ``ensure_costs`` materializes lazy cost thunks first (one analytic
        count per signature — never pass it from a scrape path)."""
        if ensure_costs:
            self.ensure_costs()
            self.update_live_gauges(min_interval=0.0)
        compiles: Dict[str, Dict[str, int]] = {}
        for labels, v in COMPILES.samples():
            compiles.setdefault(labels["program"], {})[labels["reason"]] = \
                int(v)
        with self._lock:
            totals = (self.compiles_total,
                      round(self.compile_seconds_total, 6))
        try:
            # guarded like doctor._precision_plans: the profile view must
            # serve even when the ops plane is half-imported
            from ..ops.precision import plans_report
            precision = plans_report()
        except Exception:                       # noqa: BLE001
            precision = {}
        return {
            "compiles": compiles,
            "compiles_total": totals[0],
            "compile_seconds_total": totals[1],
            "active_compiles": self.active_compiles(),
            "storms": self.storm_report(),
            "roofline": self.roofline_report(),
            # interior-precision plans per program (ops/precision.py):
            # applied mode, per-edge verdicts + measured SNRs, declines
            "precision": precision,
        }


# ---------------------------------------------------------------------------
# module-level singleton + convenience wrappers
# ---------------------------------------------------------------------------

_plane: Optional[ProfilePlane] = None
_plane_lock = threading.Lock()


def plane() -> ProfilePlane:
    """The process-global profile plane (created on first use)."""
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                _plane = ProfilePlane()
    return _plane


def register(program: str, cost: Optional[dict] = None,
             cost_thunk=None, dtype: Optional[str] = None,
             device: Optional[str] = None) -> _Program:
    return plane().register(program, cost=cost, cost_thunk=cost_thunk,
                            dtype=dtype, device=device)


def compiling(program: str, reason: str, signature: str = "") -> _Compiling:
    return plane().compiling(program, reason, signature)


def record_compile(program: str, reason: str, signature: str = "",
                   seconds: float = 0.0) -> None:
    plane().record_compile(program, reason, signature, seconds)

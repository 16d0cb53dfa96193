"""Span tracing: a lock-cheap, thread-aware ring-buffer span recorder.

The port's copy of ``futuresdr_tpu/telemetry/spans.py``, unchanged in
behaviour: the same events give the same Chrome trace.

Design constraints (the reason this is not just ``logging`` with timestamps):

* **Hot-path cost when disabled is one attribute read.** Instrumented sites
  guard with ``if recorder().enabled:`` (or call :meth:`SpanRecorder.complete`,
  whose first statement is that check). The ≤3% overhead budget of the
  telemetry gate (``tests/test_torch_telemetry.py``) is enforced against this path.
* **Thread-aware without a global hot lock.** Every recording thread owns its
  own bounded ring (registered once under a lock); pushes take only the ring's
  private lock, which is contended solely by a concurrent :func:`drain` — in
  steady state it is uncontended and cheap. Blocks run on scheduler loops AND
  dedicated ``BLOCKING`` threads (TpuKernel et al.), so per-thread rings also
  give Perfetto one track per actual thread.
* **Monotonic clock.** ``time.perf_counter_ns`` everywhere; ``perf_counter()``
  floats (the fake link's deadlines, ``ops/xfer.py``) share the same epoch, so
  wire-occupancy ends can be clamped to link deadlines.
* **Bounded.** Each ring keeps the most recent ``capacity`` events and counts
  drops — a forgotten-enabled trace degrades to a window, never to OOM.

Export is Chrome trace-event JSON (``"X"`` complete events + thread-name
metadata), loadable in Perfetto / ``chrome://tracing``. Span *analysis* lives
here too (:func:`intervals`, :func:`union_ns`, :func:`overlap_report`) so tests
can assert pipeline overlap from the trace instead of from wall clock.

Gating: ``FUTURESDR_TPU_TRACE=1`` (→ ``config().trace``) enables recording at
first use; :func:`enable` flips it at runtime.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "SpanEvent", "SpanRecorder", "recorder", "enable", "enabled", "drain",
    "chrome_trace", "export", "intervals", "union_ns", "overlap_report",
    "PIPELINE_LANES",
]

#: the three streamed-pipeline lanes whose interval union measures overlap
PIPELINE_LANES = ("H2D", "compute", "D2H")


class SpanEvent(NamedTuple):
    """One drained event. ``dur_ns is None`` marks an instant event."""

    tid: int
    thread: str
    t0_ns: int
    dur_ns: Optional[int]
    cat: str
    name: str
    args: Optional[Dict[str, Any]]


class _ThreadRing:
    """Bounded per-thread event ring; lock shared only with drain()."""

    __slots__ = ("tid", "name", "lock", "events", "idx", "dropped", "capacity")

    def __init__(self, capacity: int):
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.name = t.name
        self.lock = threading.Lock()
        self.capacity = capacity
        self.events: List[Tuple] = []
        self.idx = 0              # next overwrite position once full
        self.dropped = 0

    def push(self, ev: Tuple) -> None:
        with self.lock:
            if len(self.events) < self.capacity:
                self.events.append(ev)
            else:                 # ring: keep the newest, count the loss
                self.events[self.idx] = ev
                self.idx = (self.idx + 1) % self.capacity
                self.dropped += 1

    def take(self) -> Tuple[List[Tuple], int]:
        with self.lock:
            evs, self.events, i = self.events, [], self.idx
            self.idx = 0
            dropped, self.dropped = self.dropped, 0
        return evs[i:] + evs[:i], dropped

    def peek(self) -> List[Tuple]:
        with self.lock:
            return self.events[self.idx:] + self.events[:self.idx]


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_rec", "_cat", "_name", "_args", "_t0")

    def __init__(self, rec: "SpanRecorder", cat: str, name: str, args):
        self._rec, self._cat, self._name, self._args = rec, cat, name, args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._rec.complete(self._cat, self._name, self._t0, args=self._args)
        return False


class SpanRecorder:
    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if capacity is None or enabled is None:
            from ..config import config
            c = config()
            capacity = capacity if capacity is not None \
                else int(c.get("trace_ring", 1 << 16))
            enabled = enabled if enabled is not None \
                else bool(c.get("trace", False))
        self.capacity = max(16, int(capacity))
        self.enabled = bool(enabled)
        self.epoch_ns = time.perf_counter_ns()
        self._tls = threading.local()
        self._rings: List[_ThreadRing] = []
        self._reg_lock = threading.Lock()
        self.dropped = 0          # accumulated across drains

    #: registry bound: beyond this many per-thread rings the oldest DEAD
    #: threads' rings are evicted (their events counted as dropped) — so a
    #: trace left enabled in a thread-churning service stays a window, not a
    #: leak, even when nothing ever drains it
    MAX_RINGS = 256

    # -- recording -------------------------------------------------------------
    def _ring(self) -> _ThreadRing:
        r = getattr(self._tls, "ring", None)
        if r is None:
            r = _ThreadRing(self.capacity)
            self._tls.ring = r
            with self._reg_lock:
                self._rings.append(r)
                if len(self._rings) > self.MAX_RINGS:
                    self._prune_locked()
        return r

    def _prune_locked(self) -> None:
        """Drop dead threads' rings: emptied ones for free, then (still over
        the bound) the oldest dead ones with their events counted as drops."""
        alive = {t.ident for t in threading.enumerate()}
        keep = [r for r in self._rings if r.tid in alive or r.events]
        overflow = len(keep) - self.MAX_RINGS
        if overflow > 0:
            kept = []
            for r in keep:
                if overflow > 0 and r.tid not in alive:
                    evs, dropped = r.take()
                    self.dropped += len(evs) + dropped
                    overflow -= 1
                else:
                    kept.append(r)
            keep = kept
        self._rings = keep

    @staticmethod
    def now() -> int:
        """Monotonic span clock (ns). Callers snapshot begin times with this."""
        return time.perf_counter_ns()

    def complete(self, cat: str, name: str, t0_ns: int,
                 end_ns: Optional[int] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record one complete ("X") span beginning at ``t0_ns``."""
        if not self.enabled:
            return
        end = time.perf_counter_ns() if end_ns is None else end_ns
        self._ring().push((t0_ns, max(0, end - t0_ns), cat, name, args))

    def instant(self, cat: str, name: str,
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self._ring().push((time.perf_counter_ns(), None, cat, name, args))

    def counter(self, name: str, value: float, cat: str = "counter") -> None:
        """Record one Perfetto counter-track sample (``"C"`` phase on
        export) — the profile plane's live MFU/HBM-util gauges ride these
        next to the lane spans so utilization is plottable against the
        trace timeline."""
        if not self.enabled:
            return
        self._ring().push((time.perf_counter_ns(), None, cat, name,
                           {"value": float(value)}))

    def span(self, cat: str, name: str, **args):
        """Context manager form for non-hot-path spans."""
        if not self.enabled:
            return _NOOP
        return _Span(self, cat, name, args or None)

    # -- draining / export -----------------------------------------------------
    def drain(self) -> List[SpanEvent]:
        """Take (and clear) every thread's recorded events, oldest-first;
        drained dead threads' rings are unregistered (they can never record
        again)."""
        with self._reg_lock:
            rings = list(self._rings)
        out: List[SpanEvent] = []
        for r in rings:
            evs, dropped = r.take()
            self.dropped += dropped
            out.extend(SpanEvent(r.tid, r.name, *ev) for ev in evs)
        with self._reg_lock:
            self._prune_locked()
        out.sort(key=lambda e: e.t0_ns)
        return out

    def snapshot(self) -> List[SpanEvent]:
        """Non-destructive read of the current ring contents (the ``?keep=1``
        control-port peek): other consumers' drains are unaffected."""
        with self._reg_lock:
            rings = list(self._rings)
        out: List[SpanEvent] = []
        for r in rings:
            out.extend(SpanEvent(r.tid, r.name, *ev) for ev in r.peek())
        out.sort(key=lambda e: e.t0_ns)
        return out

    def chrome_trace(self, events: Optional[Sequence[SpanEvent]] = None) -> dict:
        """Drain (unless given pre-drained events) into a Chrome trace dict.

        Besides the recorded spans, completed **lineage records**
        (telemetry/lineage.py) are synthesized into Perfetto flow events:
        per sampled frame one ``s`` (flow start, at the first stamp), ``t``
        steps at each interior stamp and a binding-point ``f`` at the last,
        all sharing ``id=trace_id`` — each at the thread that took the
        stamp, so Perfetto draws one connected arrow chain from the encode
        thread through H2D/compute/D2H to the decode/drain thread. Stamps
        use the recorder's own ``perf_counter_ns`` clock, so they land
        inside the very lane slices they describe.
        """
        evs = self.drain() if events is None else list(events)
        pid = os.getpid()
        epoch = self.epoch_ns
        trace: List[dict] = []
        seen_tids: Dict[int, str] = {}
        for e in evs:
            seen_tids.setdefault(e.tid, e.thread)
            if e.cat == "counter":
                # counter-track sample (SpanRecorder.counter): Perfetto draws
                # these as a per-name value track, pid-scoped
                trace.append({"ph": "C", "pid": pid, "tid": e.tid,
                              "ts": (e.t0_ns - epoch) / 1e3,
                              "name": e.name, "args": e.args or {}})
                continue
            d = {"ph": "X" if e.dur_ns is not None else "i",
                 "pid": pid, "tid": e.tid,
                 "ts": (e.t0_ns - epoch) / 1e3,   # Chrome wants microseconds
                 "cat": e.cat, "name": e.name,
                 "args": e.args or {}}
            if e.dur_ns is not None:
                d["dur"] = e.dur_ns / 1e3
            else:
                d["s"] = "t"                      # thread-scoped instant
            trace.append(d)
        # lineage flow chains (local import: lineage loads after spans in the
        # telemetry package, and only this export path needs it)
        from . import lineage as _lineage
        flows = 0
        for r in _lineage.tracer().records():
            stamps = r.stamps
            if len(stamps) < 2:
                continue
            last = len(stamps) - 1
            for i, (lane, t_ns, ident, tname) in enumerate(stamps):
                seen_tids.setdefault(ident, tname)
                d = {"ph": "s" if i == 0 else ("f" if i == last else "t"),
                     "pid": pid, "tid": ident,
                     "ts": (t_ns - epoch) / 1e3,
                     "cat": "lineage", "name": "frame", "id": r.tid,
                     "args": {"lane": lane, "source": r.source}}
                if i == last:
                    d["bp"] = "e"     # bind to the enclosing slice's end
                trace.append(d)
            flows += 1
        for tid, name in seen_tids.items():
            trace.append({"ph": "M", "pid": pid, "tid": tid,
                          "name": "thread_name", "args": {"name": name}})
        return {"traceEvents": trace, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "lineage_flows": flows}}

    def export(self, path: str,
               events: Optional[Sequence[SpanEvent]] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(events), f)
        return path


# ---------------------------------------------------------------------------
# trace analysis: interval algebra over drained events
# ---------------------------------------------------------------------------

def intervals(events: Sequence[SpanEvent], name: Optional[str] = None,
              cat: Optional[str] = None) -> List[Tuple[int, int]]:
    """``(start_ns, end_ns)`` of every complete span matching name/cat."""
    return sorted((e.t0_ns, e.t0_ns + e.dur_ns) for e in events
                  if e.dur_ns is not None
                  and (name is None or e.name == name)
                  and (cat is None or e.cat == cat))


def union_ns(iv: Sequence[Tuple[int, int]]) -> int:
    """Total length of the union of intervals (overlaps merged)."""
    total = 0
    cur_s: Optional[int] = None
    cur_e = 0
    for s, e in sorted(iv):
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_s is not None:
        total += cur_e - cur_s
    return total


def overlap_report(events: Sequence[SpanEvent],
                   names: Sequence[str] = PIPELINE_LANES,
                   cat: Optional[str] = "tpu") -> dict:
    """Overlap of the pipeline lanes, measured from the trace.

    ``ratio = union(all lanes) / Σ(span durations)``: 1.0 means the lanes ran
    strictly serialized; a fully hidden second lane pushes it toward
    ``1/len(lanes)``. This replaces the wall-clock `pipelined ≤ 0.75 ×
    serialized` heuristic — the overlap is now computed from the same spans a
    human would look at in Perfetto.
    """
    per = {n: intervals(events, name=n, cat=cat) for n in names}
    all_iv = [x for iv in per.values() for x in iv]
    total = sum(e - s for s, e in all_iv)
    union = union_ns(all_iv)
    return {
        "sum_s": total / 1e9,
        "union_s": union / 1e9,
        "ratio": (union / total) if total else 1.0,
        "lanes": {n: {"spans": len(iv), "busy_s": union_ns(iv) / 1e9}
                  for n, iv in per.items()},
    }


# ---------------------------------------------------------------------------
# module-level singleton + convenience wrappers
# ---------------------------------------------------------------------------

_recorder: Optional[SpanRecorder] = None
_rec_lock = threading.Lock()


def recorder() -> SpanRecorder:
    """The process-global recorder (created on first use; env/config-gated)."""
    global _recorder
    if _recorder is None:
        with _rec_lock:
            if _recorder is None:
                _recorder = SpanRecorder()
    return _recorder


def enable(on: bool = True) -> None:
    recorder().enabled = bool(on)


def enabled() -> bool:
    return recorder().enabled


def drain() -> List[SpanEvent]:
    return recorder().drain()


def chrome_trace(events: Optional[Sequence[SpanEvent]] = None) -> dict:
    return recorder().chrome_trace(events)


def export(path: str, events: Optional[Sequence[SpanEvent]] = None) -> str:
    return recorder().export(path, events)

"""Frame-lineage tracing: sampled per-frame flow records across the machine.

The port's copy of ``futuresdr_tpu/telemetry/lineage.py``. The stamps are
host time; on a card the ``dispatch`` stamp marks the replay's launch
returning, not the graph's end.

The span recorder (telemetry/spans.py) says how busy each *lane* was; the
e2e histogram says how slow frames were *in aggregate*. Neither can follow
ONE frame. This module adds that axis: a 1-in-N sampled frame gets a
**trace id** at ingest, and every pipeline boundary it crosses — encode,
H2D, dispatch, D2H, decode, emit — appends a monotonic stamp *with the
thread that did the work*. Completed records power three consumers:

* **Perfetto flow linking** — ``spans.chrome_trace`` synthesizes ``s``/
  ``t``/``f`` flow events from each record's stamps (same
  ``perf_counter_ns`` clock as the spans), so a sampled frame renders as
  one connected arrow chain across the encode/H2D/compute/D2H/decode
  threads.
* **Tail attribution** — :func:`tail_report` decomposes sampled e2e
  latency into per-lane contributions and names the slowest lane and the
  slowest session/tenant (``doctor.report()["tail"]``, flight records,
  ``GET /api/fg/{fg}/lineage/``).
* **OpenMetrics exemplars** — sampled frames attach their trace id to the
  ``fsdr_e2e_latency_seconds`` bucket they land in (telemetry/prom.py), so
  a dashboard's p99 bucket links straight to a concrete trace.

Overhead contract (the ≤3% gate, tests/test_torch_telemetry.py): the kernel hot
path calls ``LineageTracer.sample`` once per frame — with sampling off
(``lineage_stride=0``) that is ONE falsy check and a return; at the
default stride it is an unlocked countdown decrement that takes the lock
only on the 1-in-N sampled frames. Unsampled frames carry trace id 0 through
the metas tuples, and every stamp site guards with ``if tid:`` — zero
calls for the 63-of-64 common case.

Stamp lanes, in pipeline order (a record may legitimately miss interior
lanes — a replayed frame re-enters mid-pipeline, serving lanes have no
host codec): ``ingest`` (submission), ``encode`` (wire-encode done),
``H2D`` (staging landed on device), ``dispatch`` (program call returned),
``D2H`` (result landed on host), ``decode`` (host decode done), ``emit``
(frame left the drain loop / fan-back). Per-lane *contribution* is the
delta to the previous present stamp, named for the later lane — the same
boundaries the cat="tpu" spans use, so :func:`tail_report`'s verdict is
commensurable with the doctor's interval-union ``bottleneck_lane``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["LineageTracer", "tracer", "reset_tracer", "tail_report",
           "LANE_ORDER", "PIPELINE_LANES"]

#: every stamp lane in pipeline order (delta attribution walks this)
LANE_ORDER = ("ingest", "encode", "H2D", "dispatch", "D2H", "decode", "emit")

#: the five lanes commensurable with doctor.report()'s interval-union
#: verdict — slowest-lane naming restricts to these (the queue/drain waits
#: between ingest→encode and decode→emit still show in ``lanes``, but a
#: pipelined run's in-flight wait must not outvote a device lane)
PIPELINE_LANES = ("encode", "H2D", "compute", "D2H", "decode")

#: stamp-lane → reported-lane renames: the delta ENDING at the dispatch
#: stamp is the time inside the compiled-program call — the span recorder
#: calls that lane "compute", and tail attribution must agree with it
_LANE_NAME = {"dispatch": "compute", "ingest": "queue", "emit": "drain"}


class _Record:
    """One sampled frame's lineage under construction / completed."""

    __slots__ = ("tid", "stamps", "source", "session", "tenant", "t_done")

    def __init__(self, tid: int):
        self.tid = tid
        #: [(lane, t_ns, thread_ident, thread_name)] in stamp order
        self.stamps: List[Tuple[str, int, int, str]] = []
        self.source: Optional[str] = None
        self.session: Optional[str] = None
        self.tenant: Optional[str] = None
        self.t_done: Optional[float] = None

    def lane_ns(self) -> Dict[str, int]:
        """Per-lane contribution: delta to the previous present stamp in
        :data:`LANE_ORDER`, named for the later lane (with the
        dispatch→compute / ingest→queue / emit→drain renames)."""
        by_lane = {}
        for lane, t, _ident, _name in self.stamps:
            # keep the FIRST stamp per lane (a replayed frame may re-stamp)
            by_lane.setdefault(lane, t)
        out: Dict[str, int] = {}
        prev = None
        for lane in LANE_ORDER:
            t = by_lane.get(lane)
            if t is None:
                continue
            if prev is not None and t >= prev:
                out[_LANE_NAME.get(lane, lane)] = t - prev
            prev = t
        return out

    def e2e_ns(self) -> Optional[int]:
        by_lane = {}
        for lane, t, _ident, _name in self.stamps:
            by_lane.setdefault(lane, t)
        t0, t1 = by_lane.get("ingest"), by_lane.get("emit")
        if t0 is None or t1 is None or t1 < t0:
            return None
        return t1 - t0

    def as_dict(self) -> dict:
        return {"id": self.tid, "source": self.source,
                "session": self.session, "tenant": self.tenant,
                "stamps": [{"lane": ln, "t_ns": t, "thread_ident": ti,
                            "thread": tn}
                           for ln, t, ti, tn in self.stamps]}


class LineageTracer:
    """Process-global sampled lineage recorder; see the module docstring.

    ``stride=0`` disables sampling (``sample()`` is one falsy check);
    ``stride=1`` samples every frame (tests and ``chip_smoke.py``'s
    telemetry phase force it). ``ring`` bounds completed records; in-flight records are bounded
    at ``4*ring`` so a sink that never drains cannot grow the open table.
    """

    __slots__ = ("_stride", "_lock", "_next_id", "_open", "_open_cap",
                 "_done", "dropped", "sample")

    def __init__(self, stride: int = 64, ring: int = 512):
        self._stride = max(0, int(stride))
        self._lock = threading.Lock()
        self._next_id = 0
        self._open: Dict[int, _Record] = {}
        self._open_cap = max(4, 4 * int(ring))
        self._done: deque = deque(maxlen=max(1, int(ring)))
        self.dropped = 0                  # open records evicted unfinished
        self.sample = self._make_sample()

    # -- hot path --------------------------------------------------------------
    @property
    def stride(self) -> int:
        return self._stride

    def _make_sample(self):
        """Build the per-frame ``sample()`` hook as a bound closure: the
        63-of-64 common case touches only a ``nonlocal`` countdown cell
        (no attribute loads, no modulo), and stride 0 is one falsy check.
        Returns a trace id for the 1-in-``stride`` sampled frame, else 0.
        The countdown is unlocked — a racy decrement only skews WHICH
        frame gets sampled, never correctness."""
        stride = self._stride
        left = stride
        lock = self._lock

        def sample() -> int:
            nonlocal left
            if not left:
                return 0
            if left > 1:
                left -= 1
                return 0
            left = stride
            with lock:
                self._next_id += 1
                tid = self._next_id
                if len(self._open) >= self._open_cap:
                    # evict the oldest unfinished record (insertion-ordered)
                    self._open.pop(next(iter(self._open)), None)
                    self.dropped += 1
                self._open[tid] = _Record(tid)
            return tid

        return sample

    def stamp(self, tid: int, lane: str, t_ns: Optional[int] = None) -> None:
        """Append one monotonic stamp (``time.perf_counter_ns`` — the span
        recorder's clock) to a sampled frame's record. ``tid=0`` returns
        immediately; callers on the per-frame path guard with ``if tid:``
        so the unsampled case never even calls."""
        if not tid:
            return
        t = time.perf_counter_ns() if t_ns is None else int(t_ns)
        th = threading.current_thread()
        with self._lock:
            r = self._open.get(tid)
            if r is not None:
                r.stamps.append((lane, t, th.ident or 0, th.name))

    def finish(self, tid: int, source: Optional[str] = None,
               session: Optional[str] = None,
               tenant: Optional[str] = None) -> Optional[dict]:
        """Complete a record (usually right after its ``emit`` stamp) and
        move it to the bounded done ring; returns its dict form (None for
        tid 0 / an already-evicted record)."""
        if not tid:
            return None
        with self._lock:
            r = self._open.pop(tid, None)
            if r is None:
                return None
            if source is not None:
                r.source = str(source)
            if session is not None:
                r.session = str(session)
            if tenant is not None:
                r.tenant = str(tenant)
            r.t_done = time.time()
            self._done.append(r)
        return r.as_dict()

    # -- reads -----------------------------------------------------------------
    def records(self, n: Optional[int] = None) -> List[_Record]:
        """Completed records oldest-first (non-destructive snapshot)."""
        with self._lock:
            evs = list(self._done)
        return evs[-int(n):] if n is not None else evs

    def records_dicts(self, n: Optional[int] = None) -> List[dict]:
        return [r.as_dict() for r in self.records(n)]

    def clear(self) -> None:
        with self._lock:
            self._open.clear()
            self._done.clear()


# ---------------------------------------------------------------------------
# tail attribution
# ---------------------------------------------------------------------------

def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def tail_report(records: Optional[Sequence[_Record]] = None,
                n_slowest: int = 5) -> Optional[dict]:
    """Decompose sampled e2e latency into per-lane contributions.

    ``doctor.report()["tail"]``: over the tracer's completed records (or an
    explicit sequence), per-lane mean contribution and fraction of total
    sampled time, p50/p99 of sampled e2e, the slowest :data:`PIPELINE_LANES`
    lane (commensurable with the interval-union ``bottleneck_lane``), the
    slowest session/tenant by mean e2e, and the ``n_slowest`` individual
    frames (trace id + e2e + their own lane split — the frames an exemplar
    link lands on). None when nothing was sampled.
    """
    if records is None:
        records = tracer().records()
    lane_tot: Dict[str, int] = {}
    lane_cnt: Dict[str, int] = {}
    e2es: List[float] = []
    per_sess: Dict[Tuple[Optional[str], Optional[str]], List[float]] = {}
    rows = []
    for r in records:
        e2e = r.e2e_ns()
        lanes = r.lane_ns()
        for lane, d in lanes.items():
            lane_tot[lane] = lane_tot.get(lane, 0) + d
            lane_cnt[lane] = lane_cnt.get(lane, 0) + 1
        if e2e is None:
            continue
        e2es.append(e2e * 1e-9)
        if r.session is not None or r.tenant is not None:
            per_sess.setdefault((r.session, r.tenant), []).append(e2e * 1e-9)
        rows.append((e2e, r.tid, r.source, r.session, r.tenant, lanes))
    if not lane_tot and not e2es:
        return None
    total_ns = sum(lane_tot.values())
    lanes_out = {
        lane: {"mean_ms": round(lane_tot[lane] / lane_cnt[lane] / 1e6, 6),
               "total_s": round(lane_tot[lane] / 1e9, 6),
               "frac": round(lane_tot[lane] / total_ns, 4) if total_ns
               else 0.0}
        for lane in sorted(lane_tot)}
    pipe = {ln: lane_tot.get(ln, 0) for ln in PIPELINE_LANES
            if lane_tot.get(ln)}
    slowest_lane = max(pipe, key=pipe.get) if pipe else None
    slowest_frac = round(pipe[slowest_lane] / total_ns, 4) \
        if slowest_lane and total_ns else 0.0
    sess_mean = {k: sum(v) / len(v) for k, v in per_sess.items()}
    slow_sess = max(sess_mean, key=sess_mean.get) if sess_mean else None
    e2es.sort()
    rows.sort(reverse=True)
    return {
        "samples": len(records),
        "e2e_samples": len(e2es),
        "p50_ms": round(_quantile(e2es, 0.50) * 1e3, 6) if e2es else None,
        "p99_ms": round(_quantile(e2es, 0.99) * 1e3, 6) if e2es else None,
        "lanes": lanes_out,
        "slowest_lane": slowest_lane,
        "slowest_lane_frac": slowest_frac,
        "slowest_session": slow_sess[0] if slow_sess else None,
        "slowest_tenant": slow_sess[1] if slow_sess else None,
        "slowest_session_mean_ms": round(sess_mean[slow_sess] * 1e3, 6)
        if slow_sess else None,
        "slowest_frames": [
            {"id": tid, "e2e_ms": round(e2e / 1e6, 6), "source": src,
             "session": sess, "tenant": ten,
             "lanes_ms": {ln: round(d / 1e6, 6) for ln, d in lanes.items()}}
            for e2e, tid, src, sess, ten, lanes in rows[:max(0, n_slowest)]],
    }


# ---------------------------------------------------------------------------
# module-level singleton + convenience wrappers
# ---------------------------------------------------------------------------

_tracer: Optional[LineageTracer] = None
_tlock = threading.Lock()


def tracer() -> LineageTracer:
    """The process-global tracer (created on first use from the
    ``lineage_stride`` / ``lineage_ring`` config knobs)."""
    global _tracer
    if _tracer is None:
        with _tlock:
            if _tracer is None:
                from ..config import config
                c = config()
                _tracer = LineageTracer(
                    stride=int(c.get("lineage_stride", 64)),
                    ring=int(c.get("lineage_ring", 512)))
    return _tracer


def reset_tracer() -> LineageTracer:
    """Discard the singleton and rebuild from current config (tests force
    ``lineage_stride=1`` this way)."""
    global _tracer
    with _tlock:
        _tracer = None
    return tracer()

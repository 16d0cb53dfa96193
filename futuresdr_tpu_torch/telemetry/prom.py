"""Prometheus metrics: a minimal counters/gauges registry + text exposition.

The port's copy of ``futuresdr_tpu/telemetry/prom.py``: the per-block
families and the OpenMetrics exemplars included.

Always on (unlike span tracing): updates happen at frame/transfer rate, not
sample rate, so a per-metric lock is cheap. Two sources feed the ``/metrics``
endpoint (``runtime/ctrl_port.py``):

* the **registry** here — process-global counters/gauges (link bytes, wire SNR,
  span-ring drops, …) registered by any module via :func:`counter` /
  :func:`gauge`;
* **per-block families** rendered from :meth:`WrappedKernel.metrics` dicts by
  :func:`render_block_metrics` — the existing metrics dict API stays the single
  source of per-block truth (work counters, port items, buffer occupancy,
  stall counts, kernel ``extra_metrics``), and this module only translates it
  into exposition text at scrape time.

Exposition follows the Prometheus text format v0.0.4 (``# HELP``/``# TYPE``
headers, ``name{label="v"} value`` samples, ``+Inf``/``NaN`` literals).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry", "counter",
           "gauge", "histogram", "render_block_metrics", "render_all",
           "CONTENT_TYPE", "CONTENT_TYPE_OPENMETRICS"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize_name(name: str) -> str:
    name = _NAME_FIX.sub("_", name)
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _exemplar_suffix(ex: Tuple[float, str, float]) -> str:
    """OpenMetrics exemplar tail: ``# {trace_id="…"} value wall_ts``."""
    v, tid, ts = ex
    return f' # {{trace_id="{_escape_label(tid)}"}} {_fmt_value(v)} {ts:.3f}'


def _sample_line(name: str, labels: Dict[str, object], value: float) -> str:
    if labels:
        lab = ",".join(f'{_sanitize_name(str(k))}="{_escape_label(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = _sanitize_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._vals: Dict[Tuple, float] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, "
                             f"got {tuple(labels)}")
        return tuple(labels[k] for k in self.labelnames)

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(self._key(labels), 0.0)

    def samples(self) -> List[Tuple[Dict[str, object], float]]:
        with self._lock:
            items = list(self._vals.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]

    def render(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        samples = self.samples()
        if not samples and not self.labelnames:
            samples = [({}, 0.0)]      # unlabelled metrics expose their zero
        # STABLE sample order: sort by label values (dict insertion order
        # would expose label-set CREATION order, which differs between
        # processes — per-tenant serving label sets made this visible, and
        # scrape diffing / the regress harness need deterministic text)
        samples.sort(key=lambda s: tuple(str(v) for v in s[0].values()))
        for labels, v in samples:
            lines.append(_sample_line(self.name, labels, v))
        return lines

    def render_openmetrics(self) -> List[str]:
        # counters/gauges carry no exemplars; same text either way
        return self.render()


class _BoundCounter:
    """One label set of a :class:`Counter`, key pre-resolved — the same
    hoist-out-of-the-hot-path pattern as :meth:`Histogram.labels` (the
    restart/retry sites bill through these)."""

    __slots__ = ("_metric", "_k")

    def __init__(self, metric: "Counter", k: Tuple):
        self._metric = metric
        self._k = k

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        m = self._metric
        with m._lock:
            m._vals[self._k] = m._vals.get(self._k, 0.0) + amount

    @property
    def value(self) -> float:
        m = self._metric
        with m._lock:
            return m._vals.get(self._k, 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + amount

    def labels(self, **labels) -> _BoundCounter:
        """A bound child for one label set (label validation paid once)."""
        return _BoundCounter(self, self._key(labels))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    """Fixed-bucket log2 histogram family (``telemetry/hist.py`` children).

    Unlike Counter/Gauge the per-observation path must survive the work()
    hot loop, so the label resolution is hoisted out of it: call
    :meth:`labels` ONCE per site to get the bound :class:`~.hist.Log2Hist`
    child and ``observe()`` on that — one frexp + three adds per event.
    Exposition follows the Prometheus histogram convention: cumulative
    ``<name>_bucket{le="…"}`` samples per child plus ``_sum``/``_count``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        from .hist import Log2Hist
        self._cls = Log2Hist
        self._hists: Dict[Tuple, "Log2Hist"] = {}

    def labels(self, **labels):
        """The (created-on-first-use) bound child for one label set."""
        k = self._key(labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = self._cls()
            return h

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimated quantile of one child — or, called WITHOUT labels on a
        labelled family, of all children merged (the aggregate the doctor
        stamps as ``e2e_latency_p50``/``p99``)."""
        from .hist import log2_bounds, quantile_from_buckets
        if labels or not self.labelnames:
            return self.labels(**labels).quantile(q)
        with self._lock:
            children = list(self._hists.values())
        if not children:
            return None
        merged: Optional[list] = None
        total = 0
        for h in children:
            counts, _s, n = h.snapshot()
            total += n
            merged = counts if merged is None else \
                [a + b for a, b in zip(merged, counts)]
        return quantile_from_buckets(merged or [], log2_bounds(), total, q)

    def samples(self):               # _Metric contract: flat (labels, value)
        with self._lock:
            items = list(self._hists.items())
        return [(dict(zip(self.labelnames, k)), h.count) for k, h in items]

    def render(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = list(self._hists.items())
        # same stable order as _Metric.render: child creation order is not
        # deterministic across processes, label-value order is
        items.sort(key=lambda kv: tuple(str(v) for v in kv[0]))
        for k, h in items:
            base = dict(zip(self.labelnames, k))
            counts, total_sum, total = h.snapshot()
            cum = 0
            for bound, c in zip(h.bounds, counts):
                cum += c
                lines.append(_sample_line(f"{self.name}_bucket",
                                          {**base, "le": _fmt_value(bound)},
                                          cum))
            lines.append(_sample_line(f"{self.name}_bucket",
                                      {**base, "le": "+Inf"}, total))
            lines.append(_sample_line(f"{self.name}_sum", base, total_sum))
            lines.append(_sample_line(f"{self.name}_count", base, total))
        return lines

    def render_openmetrics(self) -> List[str]:
        """Like :meth:`render`, plus OpenMetrics exemplars on bucket lines.

        An exemplar recorded by :meth:`~.hist.Log2Hist.exemplar` (the lineage
        tracer feeds ``fsdr_e2e_latency_seconds`` this way) is appended to the
        cumulative ``_bucket`` line of the bucket its value fell in:
        ``… 5 # {trace_id="f-1a2b"} 0.0043 1754550000.123``. The default
        v0.0.4 :meth:`render` stays byte-identical — Prometheus only parses
        exemplars under the OpenMetrics content type.
        """
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = list(self._hists.items())
        items.sort(key=lambda kv: tuple(str(v) for v in kv[0]))
        for k, h in items:
            base = dict(zip(self.labelnames, k))
            counts, total_sum, total = h.snapshot()
            exs = h.exemplars()
            cum = 0
            for i, (bound, c) in enumerate(zip(h.bounds, counts)):
                cum += c
                line = _sample_line(f"{self.name}_bucket",
                                    {**base, "le": _fmt_value(bound)}, cum)
                ex = exs.get(i)
                if ex is not None:
                    line += _exemplar_suffix(ex)
                lines.append(line)
            inf_line = _sample_line(f"{self.name}_bucket",
                                    {**base, "le": "+Inf"}, total)
            ex = exs.get(len(h.bounds))      # overflow-bucket exemplar
            if ex is not None:
                inf_line += _exemplar_suffix(ex)
            lines.append(inf_line)
            lines.append(_sample_line(f"{self.name}_sum", base, total_sum))
            lines.append(_sample_line(f"{self.name}_count", base, total))
        return lines


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str]) -> _Metric:
        name = _sanitize_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name} re-registered with a "
                                 f"different type or label set")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames)

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 exposition (histogram exemplars included, ``# EOF``
        terminator) — served when a scraper asks for
        :data:`CONTENT_TYPE_OPENMETRICS` via ``GET /metrics?openmetrics=1``."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render_openmetrics())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


_registry = Registry()


def registry() -> Registry:
    """The process-global registry."""
    return _registry


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Histogram:
    return _registry.histogram(name, help, labelnames)


# ---------------------------------------------------------------------------
# per-block families from WrappedKernel.metrics() dicts
# ---------------------------------------------------------------------------

# metrics() keys with fixed meanings → (family suffix, type, help, port label?)
_BLOCK_SCALARS = {
    "work_calls": ("work_calls_total", "counter", "work() invocations"),
    "work_time_s": ("work_time_seconds_total", "counter",
                    "cumulative seconds inside work()"),
    "messages_handled": ("messages_handled_total", "counter",
                         "message-port handler invocations"),
}
_BLOCK_PORT_MAPS = {
    "items_in": ("items_in_total", "counter", "items consumed per input port"),
    "items_out": ("items_out_total", "counter",
                  "items produced per output port"),
    "buffer_fill": ("buffer_fill_ratio", "gauge",
                    "input ring occupancy (available/capacity)"),
    "stalls": ("buffer_stalls_total", "counter",
               "parks with a backpressured (full) output ring"),
    "starved": ("buffer_starved_total", "counter",
                "parks waiting on an input ring below min_items"),
}


def render_block_metrics(fg_metrics: Dict[int, Dict[str, dict]],
                         prefix: str = "fsdr_block") -> str:
    """Render ``{fg_id: {block_name: metrics_dict}}`` as Prometheus families.

    Fixed keys map to typed families (above); any OTHER numeric scalar a
    kernel's ``extra_metrics`` contributed becomes a ``<prefix>_extra`` gauge
    with a ``key`` label, and string values become ``<prefix>_attr`` info
    samples — so new kernel metrics surface without touching this table.
    """
    # family name → (type, help, [lines])
    fams: Dict[str, Tuple[str, str, List[str]]] = {}

    def add(family: str, kind: str, help: str, labels: dict, value) -> None:
        fam = fams.setdefault(f"{prefix}_{family}", (kind, help, []))
        fam[2].append(_sample_line(f"{prefix}_{family}", labels, value))

    for fg_id, blocks in fg_metrics.items():
        for bname, m in (blocks or {}).items():
            if not isinstance(m, dict):
                continue
            base = {"fg": fg_id, "block": bname}
            handled = set()
            for key, (fam, kind, help) in _BLOCK_SCALARS.items():
                if key in m:
                    add(fam, kind, help, base, m[key])
                    handled.add(key)
            for key, (fam, kind, help) in _BLOCK_PORT_MAPS.items():
                if isinstance(m.get(key), dict):
                    for port, v in m[key].items():
                        add(fam, kind, help, {**base, "port": port}, v)
                    handled.add(key)
            for key, v in m.items():
                if key in handled:
                    continue
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    add("extra", "gauge",
                        "kernel extra_metrics numeric values",
                        {**base, "key": key}, v)
                elif isinstance(v, str):
                    add("attr", "gauge", "kernel string attributes",
                        {**base, "key": key, "value": v}, 1)
    lines: List[str] = []
    for fam in sorted(fams):
        kind, help, samples = fams[fam]
        lines.append(f"# HELP {fam} {help}")
        lines.append(f"# TYPE {fam} {kind}")
        # sample lines sort within the family (same stable-exposition
        # contract as the registry metrics — block/port discovery order is
        # not deterministic, the rendered text must be)
        lines.extend(sorted(samples))
    return "\n".join(lines) + ("\n" if lines else "")


def render_all(fg_metrics: Optional[Dict[int, Dict[str, dict]]] = None) -> str:
    """Registry + per-block families in one exposition document."""
    text = _registry.render()
    if fg_metrics:
        text += render_block_metrics(fg_metrics)
    return text
